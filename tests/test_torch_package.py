"""Packaging and dispatch of the PyTorch port, and its kernels on a card.

On the CPU: the port imports and runs with JAX and the JAX package
unavailable, no source of it (nor ``chip_smoke.py``) imports either, its
slice config is the JAX package's ``get_cfg()`` with the slice's switches,
the kernel loader raises where there is no ``nvcc`` (never a
plain fallback), the CUDA wrappers refuse CPU tensors, CPU tensors take the
plain versions without touching the loader, and ``chip_smoke.py`` fails
without a card. The tests marked ``cuda`` compare each kernel with its plain
version on the card and skip here.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from unopose_tpu_torch.configs import TINY_SIZES, slice_config
from unopose_tpu_torch.kernels import LAUNCHES, build
from unopose_tpu_torch.ops import ball_query, fps as fps_mod, gather

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "unopose_tpu_torch"


def _run(code: str, cwd=ROOT, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_runs_with_jax_unavailable():
    """Importing and running the port (tiny float32 slice on the CPU) with
    ``jax``, ``flax`` and the JAX package blocked in ``sys.modules``."""
    code = """
import sys
for name in ("jax", "flax", "unopose_tpu"):
    sys.modules[name] = None
import numpy as np, torch
import chip_smoke
from unopose_tpu_torch.configs import slice_config, synthetic_inputs
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.utils.convert import flax_to_torch
torch.manual_seed(0)
model = UNOPose.from_config(slice_config(tiny=True), torch.float32, torch.float32)
inputs = synthetic_inputs(np.random.default_rng(0), 2, tiny=True)
out = model({k: torch.from_numpy(v) for k, v in inputs.items()}, generator=torch.Generator().manual_seed(0))
assert torch.isfinite(out["pred_R"]).all(), out
loaded = {m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
assert not loaded & {"jax", "flax", "jaxlib", "unopose_tpu"}, loaded
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-2000:]


def test_port_sources_import_no_jax():
    """Neither the port nor ``chip_smoke.py`` imports JAX or the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|jaxlib|unopose_tpu)\b", re.M)
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def _assert_subset(ours, ref, path=""):
    for k, v in ours.items():
        assert k in ref, f"{path}{k} is not a key of the reference config"
        if isinstance(v, dict):
            _assert_subset(v, ref[k], f"{path}{k}.")
        else:
            assert ref[k] == v, f"{path}{k}: port {v!r}, reference {ref[k]!r}"


@pytest.mark.parametrize("tiny", [False, True])
def test_slice_config_is_the_reference_config_with_the_switches(tiny):
    """Every value of the port's slice config equals the JAX package's
    ``get_cfg()`` (or the tests' ``get_tiny_cfg``) with the four switches,
    and every key the port's model reads is set."""
    from unopose_tpu.configs.main_cfg import get_cfg, get_tiny_cfg

    if tiny:
        ref = get_tiny_cfg(img_size=TINY_SIZES["img"], n_pts=TINY_SIZES["npts"], coarse_npoint=16,
                           n_tem=TINY_SIZES["ntem"]).model
        ref.fine_point_matching.merge(dict(nsample1=64, nsample2=256))
    else:
        ref = get_cfg().model
    ref.feature_extraction.fused_attn = False
    ref.geo_embedding.fused_table = 0
    ref.fine_point_matching.pe_fused = False
    ref.fused_assignment = False
    ref.use_ref_rad = False
    ours = slice_config(tiny)
    _assert_subset(ours, ref)
    read = re.findall(r"\b(fe|ge|cm|fm)\.get\(\"(\w+)\"", (PORT / "models" / "unopose.py").read_text())
    sections = dict(fe="feature_extraction", ge="geo_embedding", cm="coarse_point_matching", fm="fine_point_matching")
    missing = {(sections[s], k) for s, k in read if k in ref[sections[s]] and k not in ours[sections[s]]}
    assert not missing, missing


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    """No toolkit: ``build.load`` raises instead of handing back a plain path."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "CUDA_ROOTS", (str(tmp_path),))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(build.KernelBuildError):
        build.load()
    with pytest.raises(build.KernelBuildError):
        build.find_nvcc()


def test_cuda_wrappers_refuse_cpu_tensors():
    pts = torch.rand(1, 256, 3)
    with pytest.raises(ValueError):
        fps_mod.fps_cuda(pts, 8)
    planes = torch.rand(3, 1, 256)
    with pytest.raises(ValueError):
        gather.gather_planar_cuda(*planes, torch.zeros(1, 4, 4, dtype=torch.int16))
    perm, inv = ball_query.permutation(256, "cpu")
    with pytest.raises(ValueError):
        ball_query.first_k_select_cuda(pts, pts, perm, inv, 0.1, 64, 0.2, 256)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors the dispatchers never reach the loader or count a launch."""

    def no_loader():
        raise AssertionError("the kernel loader was called for a CPU tensor")

    monkeypatch.setattr(build, "load", no_loader)
    before = dict(LAUNCHES)
    pts = torch.rand(2, 256, 3) * 0.5
    idx = fps_mod.fps(pts, 16)
    sel = ball_query.first_k_budget_select(0.1, 64, 0.2, 256, pts)
    gx, _, _ = gather.gather_planar(*pts.unbind(-1), idx[:, :, None].to(torch.int16))
    assert idx.shape == (2, 16) and sel["g2"][0].shape == (2, 256, 256) and gx.shape == (2, 16, 1)
    assert dict(LAUNCHES) == before


def test_unported_modes_are_refused():
    from unopose_tpu_torch.models import UNOPose

    for key, value in (
        ("feature_extraction.fused_attn", True),
        ("fine_point_matching.pe_fused", True),
        ("fine_point_matching.pe_neighbor_mode", "subset"),
        ("coarse_point_matching.sim_type", "L2"),
        ("fused_assignment", True),
        ("test_coarse_only", True),
    ):
        cfg = slice_config(tiny=True)
        *parents, leaf = key.split(".")
        node = cfg
        for p in parents:
            node = node[p]
        node[leaf] = value
        with pytest.raises(NotImplementedError):
            UNOPose.from_config(cfg)


def test_profile_tool_fails_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "unopose_tpu_torch.tools.profile_slice"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card (and, alone, no repository either): non-zero exit, no result."""
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _lrf_cloud(rng, B, N, dev):
    from unopose_tpu_torch.ops.lrf import global_lrf

    pts = rng.uniform(-0.1, 0.1, size=(B, N, 3)).astype(np.float32) + np.float32(0.6)
    return global_lrf(torch.from_numpy(pts).to(dev))


@pytest.mark.cuda
def test_fps_kernel_matches_plain(cuda):
    pts = _lrf_cloud(np.random.default_rng(0), 4, 5000, cuda)
    for k in (2048, 196):
        assert torch.equal(fps_mod.fps_cuda(pts, k), fps_mod.fps_plain(pts, k))


@pytest.mark.cuda
def test_first_k_select_and_gather_kernels_match_plain(cuda):
    for B, N, dense in ((4, 2048, False), (2, 512, True)):
        pts = _lrf_cloud(np.random.default_rng(1), B, N, cuda) * (0.1 if dense else 1.0)
        perm, inv = ball_query.permutation(N, cuda)
        pts_p = pts.index_select(1, perm.long())
        args = (pts, pts_p, perm, inv, 0.1, 64, 0.2, 256)
        got, want = ball_query.first_k_select_cuda(*args), ball_query.first_k_select_plain(*args)
        assert bool(want["overflow"]) == dense
        for k in ball_query.SELECT_KEYS:
            assert torch.equal(got[k], want[k]), k
        planes = tuple(p.contiguous() for p in pts_p.unbind(-1))
        for idx in (want["idx_p"], want["idx_p"].to(torch.int32)):
            for a, b in zip(gather.gather_planar_cuda(*planes, idx), gather.gather_planar_plain(*planes, idx)):
                assert torch.equal(a, b)
