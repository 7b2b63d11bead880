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

import importlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from unopose_tpu_torch.configs import TINY_SIZES, slice_config, surface_clouds
from unopose_tpu_torch.kernels import LAUNCHES, build
from unopose_tpu_torch.ops import (
    assignment_fused, gather, geo_fused, pe_fused, pe_train, vit_attn,
)

# the ops package exports fps and ball_query, the functions, under their modules' names
fps_mod = importlib.import_module("unopose_tpu_torch.ops.fps")
ball_query = importlib.import_module("unopose_tpu_torch.ops.ball_query")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "unopose_tpu_torch"


def _run(code: str, cwd=ROOT, timeout=120):
    """``code`` in a fresh interpreter. Its torch takes 2 threads unless ``OMP_NUM_THREADS`` says otherwise:
    beside busy test workers, a child on every core ran 9x slower than alone and met its timeout."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.setdefault("OMP_NUM_THREADS", "2")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_runs_with_jax_unavailable():
    """Importing and running the port (every tiny float32 config on the CPU
    and a train step; the bench and the profiling scripts imported, one
    kernel twin run; the launcher, the engine, the test reader and the
    evaluator imported and the tiny ``--eval-only`` run on a synthetic BOP
    tree; the training reader, its colour augmentation, the loaders, the
    checkpointer, the writers, the drawing helpers and the data-parallel
    layer imported; the public ops, the scenes, the fake reference and the
    reference loader run, and the pose-recovery example imported) with
    ``jax``, ``flax`` and the JAX package blocked in ``sys.modules``."""
    code = """
import sys
for name in ("jax", "flax", "unopose_tpu"):
    sys.modules[name] = None
import numpy as np, torch
import chip_smoke
import unopose_tpu_torch.tools.profile_slice
from unopose_tpu_torch.configs import CONFIGS, synthetic_inputs, synthetic_train_inputs, train_config
from unopose_tpu_torch.engine.train import Trainer
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.utils.convert import flax_to_torch
branches = {}
for name, config in CONFIGS.items():
    torch.manual_seed(0)
    cfg = config(tiny=True)
    model = UNOPose.from_config(cfg, torch.float32, torch.float32)
    inputs = synthetic_inputs(np.random.default_rng(0), 2, tiny=True, npts=cfg.fine_npoint)
    out = model({k: torch.from_numpy(v) for k, v in inputs.items()}, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out["pred_R"]).all(), out
    branches[name] = model.fine_matching.pe.last_branch
assert branches == dict(slice="packed", fused_matchers="v5", production="v5", subset="subset",
                        firstk_unpacked="unpacked"), branches
cfg = train_config(tiny=True)
trainer = Trainer(UNOPose.from_config(cfg.model, torch.float32, torch.float32), cfg)
batch = synthetic_train_inputs(np.random.default_rng(0), 2, tiny=True)
metrics = trainer.step({k: torch.from_numpy(v) for k, v in batch.items()}, generator=torch.Generator().manual_seed(0))
assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0, metrics
import unopose_tpu_torch.bench
import unopose_tpu_torch.benchmarks.profile_compact_micro
import unopose_tpu_torch.benchmarks.profile_pe_ablate
import unopose_tpu_torch.benchmarks.profile_r9
li = torch.arange(256, dtype=torch.int32)[None]
assert unopose_tpu_torch.benchmarks.profile_compact_micro.compact_wherechain(li).shape == (1, 256)
import pathlib, tempfile
import unopose_tpu_torch.data.dataset_test, unopose_tpu_torch.engine.inference, unopose_tpu_torch.eval.bop_eval
from unopose_tpu_torch import main_unopose
sys.path.insert(0, "tests")
from test_torch_eval_launcher import _argv, _tiny, write_tree
with tempfile.TemporaryDirectory() as tmp:
    root, det_path = write_tree(pathlib.Path(tmp))
    out = main_unopose.main(_argv(root, det_path, tmp + "/out") + _tiny())
    assert out["rows"] == 6 and out["stats"]["cache_hits"] == 5 and np.isfinite(out["scores"]["AR"]), out
import unopose_tpu_torch.data.color_aug, unopose_tpu_torch.data.dataset_train, unopose_tpu_torch.data.loader
import unopose_tpu_torch.utils.checkpoint, unopose_tpu_torch.utils.vis, unopose_tpu_torch.utils.writer
import unopose_tpu_torch.parallel.mesh
import unopose_tpu_torch.ops
from unopose_tpu_torch.configs import faithful_config
from unopose_tpu_torch.tools.fake_reference import reference_state_dict
from unopose_tpu_torch.tools.scenes import scene_batch
from unopose_tpu_torch.utils.ref_convert import reference_to_state_dict
assert scene_batch(np.random.default_rng(0), 1, img=28, nq=64, nt=96)[0]["pts"].shape == (1, 64, 3)
faithful = UNOPose.from_config(faithful_config(tiny=True))
state = reference_to_state_dict(reference_state_dict(faithful), depth=4)
assert all(torch.equal(state[k], v) for k, v in faithful.state_dict().items())
import importlib.util
spec = importlib.util.spec_from_file_location("example", "examples/pose_recovery_synthetic_torch.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = {m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
assert not loaded & {"jax", "flax", "jaxlib", "unopose_tpu"}, loaded
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-2000:]


def test_port_sources_import_no_jax():
    """Neither the port, ``chip_smoke.py`` nor the port's example imports JAX
    or the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|jaxlib|unopose_tpu)\b", re.M)
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py", ROOT / "examples" / "pose_recovery_synthetic_torch.py"]:
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
    tab = torch.rand(128, 32)
    with pytest.raises(ValueError):
        geo_fused.geo_rpe_fused_cuda(pts[:, :17], torch.rand(1, 17, 3, 3), tab, tab, 1.0, 1.0, 0.2, 1.0)
    planes, idx, w1, w2, total2, _ = ball_query.two_scale_group_first_k_packed_idx(0.1, 64, 0.2, 256, pts)
    center = tuple(pts.unbind(-1))
    with pytest.raises(ValueError):
        pe_fused.pe_channels_cuda(planes, idx, w1, w2, total2, center, 0.1, 0.2)
    mlp = ([torch.rand(6, 32), torch.rand(32, 64), torch.rand(64, 128)], [torch.rand(32), torch.rand(64), torch.rand(128)])
    with pytest.raises(ValueError):
        pe_fused.pe_mlp_pool_cuda(torch.zeros(1, 256, 256, 12, dtype=torch.bfloat16), w1, w2, total2,
                                  pe_fused.pack_mlp(mlp, mlp))
    qkv = torch.rand(2, 9, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        vit_attn.mha_fused_cuda(*qkv.split(32, dim=-1), 2)
    feats = torch.rand(1, 65, 32)
    with pytest.raises(ValueError):
        assignment_fused.fine_assignment_fused_cuda(feats, feats, torch.rand(1, 128), torch.rand(1, 64, 3))
    with pytest.raises(ValueError):
        ball_query.ball_group_subset_cuda(0.2, 64, pts)
    g1, _, m1 = ball_query.ball_group_subset_plain(0.1, 16, pts)
    g2, _, m2 = ball_query.ball_group_subset_plain(0.2, 64, pts)
    with pytest.raises(ValueError):
        pe_fused.pe_fused_masked_cuda(g1, m1, g2, m2, center, 0.1, 0.2, pe_fused.pack_mlp(mlp, mlp))
    chans, (Ws, gammas, betas) = torch.rand(1, 6, 32, 16), _pe_train_params(torch.device("cpu"))
    bn, gb = pe_train.stats_buffer(gammas, betas, "cpu")
    pooled = torch.rand(1, 32, 128)
    for call in (lambda: pe_train.stats_cuda(chans, Ws, gb, bn, 1, 1e-5), lambda: pe_train.fwd_cuda(chans, Ws, bn),
                 lambda: pe_train.bwd_sums_cuda(chans, Ws, bn, pooled, pooled, pooled, 3),
                 lambda: pe_train.bwd_dw_cuda(chans, Ws, bn, pooled, pooled, pooled)):
        with pytest.raises(ValueError):
            call()


def _packed_pe_case(dev, B=1, N=256, k2=256, seed=0):
    """Inputs of the packed PE's four layouts on one small cloud: (the
    materialised grouping, its slot-major copy, the index grouping, the
    centres, both scales' weights)."""
    gen = torch.Generator().manual_seed(seed)
    pts = (torch.rand(B, N, 3, generator=gen) * 0.5).to(dev)
    g2, w1, w2, total2, _ = ball_query.two_scale_group_first_k_packed(0.1, 64, 0.2, k2, pts)
    planes, idx, _, _, _, _ = ball_query.two_scale_group_first_k_packed_idx(0.1, 64, 0.2, k2, pts)
    sm = lambda x: x.transpose(1, 2).contiguous()
    mlp = ([torch.rand(6, 32), torch.rand(32, 64), torch.rand(64, 128)], [torch.rand(32), torch.rand(64), torch.rand(128)])
    mlp = tuple(([W.to(dev) for W in Ws], [b.to(dev) for b in bs]) for Ws, bs in (mlp, mlp))
    return dict(g2=g2, w1=w1, w2=w2, total2=total2, gt=tuple(map(sm, g2)), w1t=sm(w1), w2t=sm(w2), planes=planes,
                idx=idx, center=tuple(pts.unbind(-1)), mlp=mlp)


def test_packed_pe_wrappers_refuse_cpu_tensors():
    """The four packed-PE kernels' wrappers (K19-K22) raise on CPU tensors."""
    d = _packed_pe_case("cpu")
    packed = pe_fused.pack_mlp(*d["mlp"])
    chunks, _ = pe_fused.pe_channels_packed(d["g2"], d["w1"], d["w2"], d["center"], 0.1, 0.2)
    for call in (
        lambda: pe_fused.pe_fused_packed_cuda(d["g2"], d["w1"], d["w2"], d["total2"], d["center"], 0.1, 0.2, packed),
        lambda: pe_fused.pe_mlp_pool_packed_cuda(chunks, d["total2"], packed),
        lambda: pe_fused.pe_fused_gather_t_cuda(d["planes"], d["idx"], d["w1"], d["w2"], d["total2"], d["center"],
                                                0.1, 0.2, packed),
        lambda: pe_fused.pe_fused_packed_t_cuda(d["gt"], d["w1t"], d["w2t"], d["total2"], d["center"], 0.1, 0.2,
                                                packed),
    ):
        with pytest.raises(ValueError):
            call()


def test_packed_pe_dispatch_takes_the_plain_versions_on_cpu(monkeypatch):
    """On CPU tensors the four packed-PE dispatchers never reach the loader
    or count a launch, and each returns (B, P, 256) float32."""

    def no_loader():
        raise AssertionError("the kernel loader was called for a CPU tensor")

    monkeypatch.setattr(build, "load", no_loader)
    before = dict(LAUNCHES)
    d = _packed_pe_case("cpu")
    w = (*d["mlp"][0], *d["mlp"][1])
    chunks, _ = pe_fused.pe_channels_packed(d["g2"], d["w1"], d["w2"], d["center"], 0.1, 0.2)
    outs = (
        pe_fused.pe_fused_packed(d["g2"], d["w1"], d["w2"], d["total2"], d["center"], *w, 0.1, 0.2, None),
        pe_fused.pe_mlp_pool_packed(chunks, d["total2"], *w, None),
        pe_fused.pe_fused_gather_t(d["planes"], d["idx"], d["w1"], d["w2"], d["total2"], d["center"], *w, 0.1, 0.2,
                                   None),
        pe_fused.pe_fused_packed_t(d["gt"], d["w1t"], d["w2t"], d["total2"], d["center"], *w, 0.1, 0.2, None),
    )
    assert all(o.shape == (1, 256, 256) and o.dtype == torch.float32 and torch.isfinite(o).all() for o in outs)
    assert dict(LAUNCHES) == before


def test_kernel_sources_are_built_and_listed():
    """The loader builds every ``csrc/*.cu`` source, among them the four
    packed-PE kernels; each of ``chip_smoke.py``'s kernels names a source
    that exists and a TPU kernel file of the JAX package; every C entry
    point the loader binds is defined in a source; and no kernel source
    includes a file of the JAX package."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    built = {p.name for p in build._sources()}
    assert {"pe_packed.cu", "pe_mlp_pool_packed.cu", "pe_gather_fused.cu", "pe_packed_t.cu"} <= built
    assert built == {p.name for p in (PORT / "kernels" / "csrc").glob("*.cu")}
    named = {Path(src).name for src, _ in chip_smoke.KERNELS.values()}
    assert named == built, named ^ built
    for src, rep in chip_smoke.KERNELS.values():
        assert (ROOT / src).is_file() and (ROOT / rep.split(":")[0]).is_file(), (src, rep)
    sources = "".join(p.read_text() for p in (PORT / "kernels" / "csrc").iterdir())
    for entry in build._SIGNATURES:
        assert f'extern "C" int {entry}(' in sources, entry
    assert not re.search(r"#include\s*[<\"][^>\"]*unopose_tpu/", sources)


def _pe_train_params(dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    dims = (6, 32, 64, 128)
    Ws = [(torch.randn(a, b, generator=gen) * (2.0 / a) ** 0.5).to(dev) for a, b in zip(dims[:-1], dims[1:])]
    gammas = [(1.0 + 0.1 * torch.randn(d, generator=gen)).to(dev) for d in dims[1:]]
    betas = [(0.1 * torch.randn(d, generator=gen)).to(dev) for d in dims[1:]]
    return Ws, gammas, betas


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
    tab = torch.rand(128, 32)
    e8, scale = geo_fused.geo_rpe_fused(pts[:, :17], torch.rand(2, 17, 3, 3), tab, tab, 1.0, 1.0, 0.2, 1.0,
                                        quantize=True)
    assert e8.shape == (2, 17, 17, 32) and e8.dtype == torch.int8 and scale.shape == (32,)
    planes, idx_p, w1, w2, total2, _ = ball_query.two_scale_group_first_k_packed_idx(0.1, 64, 0.2, 256, pts)
    mlp = ([torch.rand(6, 32), torch.rand(32, 64), torch.rand(64, 128)], [torch.rand(32), torch.rand(64), torch.rand(128)])
    feat = pe_fused.pe_fused_v5(planes, idx_p, w1, w2, total2, tuple(pts.unbind(-1)), *mlp, *mlp, 0.1, 0.2, None)
    assert feat.shape == (2, 256, 256)
    g1, _, m1 = ball_query.ball_group_subset(0.1, 16, pts)
    g2, d2, m2 = ball_query.ball_group_subset(0.2, 64, pts)
    assert d2.shape == (2, 256, 64) and m2.dtype == torch.bool
    feat = pe_fused.pe_fused_masked(g1, m1, g2, m2, tuple(pts.unbind(-1)), mlp, mlp, 0.1, 0.2, None)
    assert feat.shape == (2, 256, 256)
    qkv = torch.rand(2, 9, 96, dtype=torch.bfloat16)
    attn = vit_attn.mha_fused(*qkv.split(32, dim=-1), 2)
    assert attn.shape == (2, 9, 32) and attn.dtype == torch.bfloat16
    feats = torch.rand(2, 65, 32)
    pred_pts, weights, label1 = assignment_fused.fine_assignment_fused(feats, feats, torch.rand(2, 128),
                                                                       torch.rand(2, 64, 3))
    assert pred_pts.shape == (2, 64, 3) and weights.shape == (2, 64) and label1.dtype == torch.int32
    Ws, gammas, betas = _pe_train_params(torch.device("cpu"))
    Ws = [W.requires_grad_() for W in Ws]
    pooled, (mus, vars_) = pe_train.pe_mlp_bn_pool_train(torch.rand(2, 6, 32, 16), Ws, gammas, betas)
    pooled.sum().backward()
    assert pooled.shape == (2, 32, 128) and [m.shape[0] for m in mus] == [32, 64, 128] and Ws[2].grad is not None
    assert dict(LAUNCHES) == before


def test_pe_weights_are_folded_once_per_weight_set():
    """The PE folds (and on the card packs) its MLP weights once; an in-place
    change of a weight or a move with ``.to()`` makes them anew."""
    from unopose_tpu_torch.models.matching import FinePositionalEncoding

    pe = FinePositionalEncoding(32, fused=True)
    first = pe.folded_weights()
    assert pe.folded_weights() is first and first[2] is None  # packed only for the card
    with torch.no_grad():
        pe.mlp2_bn1.var.mul_(4.0)
    second = pe.folded_weights()
    assert second is not first and torch.equal(second[1][0][1], pe.folded("mlp2")[0][1])
    assert not torch.equal(second[1][0][1], first[1][0][1])
    pe.to(torch.float64)
    assert pe.folded_weights()[0][0][0].dtype == torch.float64


@pytest.mark.parametrize("config", ["slice", "fused_matchers", "production", "subset", "firstk_unpacked",
                                    "production_pe_packed", "production_pe_v3", "production_pe_v4",
                                    "production_pe_slot_major", "production_s768"])
def test_profile_tool_fails_without_a_card(config):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "unopose_tpu_torch.tools.profile_slice", "--config", config], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


@pytest.mark.parametrize("tiny", [False, True])
def test_production_s768_config_is_production_at_nsample2_768(tiny):
    """The config of ``chip_smoke.py``'s and the profile tool's
    ``production_s768``: ``production_config()`` but for the scale-2
    budget, which the fine PE's routing sends to row 10 (K19)."""
    from unopose_tpu_torch.configs import production_config, production_s768_config

    got, want = production_s768_config(tiny), production_config(tiny)
    assert got.fine_point_matching.nsample2 == 768
    got.fine_point_matching.nsample2 = want.fine_point_matching.nsample2
    assert got == want


K3_K8_BUILDS = {
    "first_k_select", "first_k_select_global_scan", "first_k_select_c1", "first_k_select_c2", "first_k_select_c8",
    "first_k_select_w16", "first_k_select_ordered_walk", "first_k_select_keys_only", "first_k_select_walk_at_4",
    "first_k_select_walk_at_16", "first_k_select_walk_at_32", "first_k_select_scalar_stores", "first_k_select_word_walk",
    "fine_assign_colstats", "fine_assign_colstats_sync", "fine_assign_colstats_4warps",
    "fine_assign_colstats_16warps", "fine_assign_colstats_3stages"}
K5_K26_BUILDS = {
    "pe_channels", "pe_channels_w4", "pe_channels_w16", "pe_channels_p32", "pe_channels_staged_stores",
    "compact_gather", "compact_gather_quads2", "compact_gather_quads4",
    "compact_gather_default_cache", "compact_gather_streamed", "compact_gather_ldcg"}
# K13's and K18's builds: the shipped source, a variant per design choice, and the tie-count check
TRAIN_VARIANTS = ("_volatile_mma", "_no_prefetch", "_group2", "_group8", "_fmax_relu", "_dz_registers")
K13_K18_BUILDS = {
    *(f"pe_train_bwd_sums{v}" for v in ("", *TRAIN_VARIANTS, "_single_tiles", "_three_blocks", "_ties")),
    *(f"pe_train_frozen_bwd{v}" for v in ("", *TRAIN_VARIANTS, "_ties"))}
# K12's and K14's builds: the shipped warpgroup kernels, their mma.sync designs and the overlap variants (the
# warpgroups a block; the ring's stages and the chain warpgroups)
K12_K14_BUILDS = {
    *(f"pe_train_fwd{v}" for v in ("", "_mma_sync", "_one_group", "_two_groups", "_five_groups")),
    *(f"pe_train_bwd_dw{v}" for v in ("", "_mma_sync", "_ring4", "_one_chain", "_one_chain_ring3", "_three_chains"))}
TRAIN_BUILDS = K13_K18_BUILDS | K12_K14_BUILDS | {"pe_train_stats", "pe_train_stats_one_block", "pe_train_stats_pairs"}


def test_kernel_variants_tool_follows_the_shipped_sources(tmp_path):
    """``tools/kernel_variants.py`` makes each variant by replacing text of
    the shipped ``fps.cu``, ``vit_attn.cu``, ``fine_assign.cu`` (K8, K9 and
    K10), ``geo_rpe.cu``, ``pe_mlp_pool.cu``, ``first_k_select.cu`` (K3),
    ``pe_channels.cu`` (K5) and ``compact_micro.cu`` (K26): every
    replacement still
    finds its text (it raises otherwise), each variant differs from the
    shipped source, ``--parent``'s builds inline the headers of the other
    checkout, and the tool fails without a card."""
    from unopose_tpu_torch.tools import kernel_variants

    srcs = kernel_variants.sources(None)
    assert set(srcs) == {"fps", "fps_t1024", "fps_t512", "fps_cluster2", "fps_cluster4", "vit_attn",
                         "vit_attn_ieee_division", "vit_attn_padded_two_blocks", "vit_attn_runtime_steps",
                         "fine_assign", "fine_assign_cp_async", "fine_assign_no_ring", "fine_assign_ld32",
                         "fine_assign_ieee_division", "fine_assign_128_rows", "geo_rpe", "geo_rpe_f32_tables",
                         "geo_rpe_f32_8ch", "geo_rpe_f32_64", "geo_rpe_4ch", "geo_rpe_row_barrier", "geo_rpe_runtime_k",
                         "fine_assign_accum", "fine_assign_accum_ieee_division", "fine_assign_accum_no_ring",
                         "pe_mlp_pool", "pe_mlp_pool_b64", "pe_mlp_pool_registers", "pe_mlp_pool_no_packing",
                         "pe_mlp_pool_epilogue_first", "pe_mlp_pool_atomic", "pe_mlp_pool_stride", "pe_mlp_pool_wgmma",
                         *K3_K8_BUILDS, *K5_K26_BUILDS, *TRAIN_BUILDS}
    shipped = kernel_variants.SHIPPED
    assert shipped == {"K1": "fps", "K7": "vit_attn", "K9": "fine_assign", "K4": "geo_rpe", "K6": "pe_mlp_pool",
                       "K10": "fine_assign_accum", "K3": "first_k_select", "K8": "fine_assign_colstats",
                       "K5": "pe_channels", "K26": "compact_gather", "K11": "pe_train_stats", "K12": "pe_train_fwd",
                       "K13": "pe_train_bwd_sums", "K14": "pe_train_bwd_dw", "K18": "pe_train_frozen_bwd"}
    for name, (kernel, text) in srcs.items():
        assert (text == srcs[shipped[kernel]][1]) == (name in shipped.values()), name
    assert set(kernel_variants.sources(None, ("K6", "K10"))) == {
        "fine_assign_accum", "fine_assign_accum_ieee_division", "fine_assign_accum_no_ring", "pe_mlp_pool",
        "pe_mlp_pool_b64", "pe_mlp_pool_registers", "pe_mlp_pool_no_packing", "pe_mlp_pool_epilogue_first",
        "pe_mlp_pool_atomic", "pe_mlp_pool_stride", "pe_mlp_pool_wgmma"}
    assert set(kernel_variants.sources(None, ("K3", "K8"))) == K3_K8_BUILDS
    assert set(kernel_variants.sources(None, ("K5", "K26"))) == K5_K26_BUILDS
    assert set(kernel_variants.sources(None, ("K13", "K18"))) == K13_K18_BUILDS
    # another checkout's sources, their headers inlined from its own csrc/
    csrc = tmp_path / "unopose_tpu_torch" / "kernels" / "csrc"
    shutil.copytree(PORT / "kernels" / "csrc", csrc)
    (csrc / "pe_common.cuh").write_text("// the other checkout's header\n")
    parent = kernel_variants.sources(tmp_path, ("K6",))["pe_mlp_pool_parent"][1]
    assert "// the other checkout's header" in parent and '#include "pe_common.cuh"' not in parent
    parents = kernel_variants.sources(tmp_path, ("K3", "K8"))
    assert set(parents) == K3_K8_BUILDS | {"first_k_select_parent", "fine_assign_colstats_parent"}
    assert parents["first_k_select_parent"][1] == (csrc / "first_k_select.cu").read_text()
    parents = kernel_variants.sources(tmp_path, ("K5", "K26"))
    assert set(parents) == K5_K26_BUILDS | {"pe_channels_parent", "compact_gather_parent"}
    assert "// the other checkout's header" in parents["pe_channels_parent"][1]
    assert parents["compact_gather_parent"][1] == (csrc / "compact_micro.cu").read_text()
    # the train kernels' parents, and the parent's tie-count check (a source with its own occupancy entry is kept)
    train = kernel_variants.sources(tmp_path, ("K13", "K18"))
    assert set(train) == K13_K18_BUILDS | {"pe_train_bwd_sums_parent", "pe_train_frozen_bwd_parent",
                                           "pe_train_bwd_sums_ties_parent", "pe_train_frozen_bwd_ties_parent"}
    assert train["pe_train_bwd_sums_parent"][1] == (csrc / "pe_train.cu").read_text()
    assert "atomicAdd(g_ties" in train["pe_train_frozen_bwd_ties_parent"][1]
    # -Xptxas -v's lines of the named kernel, and the warps an SM holds at that footprint
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122compact_rounds_kernelEPKiPiii' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers, used 1 barriers, 16384 bytes smem\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118pe_channels_kernelEPKf' for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_118pe_channels_kernelEPKf\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 124 registers, used 1 barriers, 6144 bytes smem, 448 bytes cmem[0]\n")
    assert kernel_variants.ptxas_record(log, "pe_channels_kernel") == dict(registers=124, spill_stores=8,
                                                                           spill_loads=4, smem=6144)
    # the occupancy probe appended to each K5 build names the shipped launcher's shared memory, the first design's
    # three planes for a source without smem_bytes
    assert "smem_bytes(n)" in kernel_variants.with_occupancy(srcs["pe_channels"][1]).split("unopose_k5_resident")[1]
    probe = kernel_variants.with_occupancy(parents["pe_channels_parent"][1].replace("smem_bytes", "planes"))
    assert "(size_t)3 * n * sizeof(float)" in probe.split("unopose_k5_resident")[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "unopose_tpu_torch.tools.kernel_variants"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_kernel_variants_train_builds():
    """``tools/kernel_variants.py --only K13,K18``: the tie-count check
    inserts its count after the pool backward's compare of either design
    (and raises on a source with neither), a source without the occupancy
    entry gets the first design's probe, and each shape's ptxas record names
    its ``pe_train_kernel<mode, depth>`` instantiation, or, for K12 and K14,
    their warpgroup kernels (the mma_sync and parent builds the template's).
    ``--only K12,K14`` builds their variants beside K11's, K13's and K18's
    shipped builds and tie-count checks; the mma_sync variant sends both
    entry points and their occupancy to the template's passes."""
    from unopose_tpu_torch.tools import kernel_variants as kv

    first = "#include <stdint.h>\n  {\n      " + kv.TIE_ANCHORS[1][0] + "\n  }\n"
    checked = kv.tie_check(first)
    assert checked.index(kv.TIE_ANCHORS[1][0]) < checked.index(kv.TIE_ANCHORS[1][1])
    assert "      " + kv.TIE_ANCHORS[1][1] in checked and kv.TIE_DECL in checked
    with pytest.raises(ValueError):
        kv.tie_check("#include <stdint.h>\n")
    shipped = kv.sources(None, ("K13",))["pe_train_bwd_sums"][1]
    assert kv.TIE_ANCHORS[0][0] in shipped and kv.with_train_probe(shipped) == shipped
    assert kv.with_train_probe(first).endswith(kv.TRAIN_PROBE)
    keys = {("K11", "8x2048x256 depth 2"): "ILi0ELi2E", ("K12", "8x2048x64"): "ILi1ELi3E",
            ("K13", "8x2048x256 layer 1"): "ILi2ELi1E", ("K14", "8x2048x256"): "ILi3ELi0E",
            ("K18", "8x2048x64"): "ILi4ELi0E"}
    for (kernel, key), inst in keys.items():
        template = "pe_train_kernel" + inst
        assert kv.ptxas_fn(kernel, key, kv.SHIPPED[kernel] + "_parent") == template
        assert kv.ptxas_fn(kernel, key) == kv.WG_KERNELS.get(kernel, template)
    assert kv.ptxas_fn("K14", "8x2048x64", "pe_train_bwd_dw_mma_sync") == "pe_train_kernelILi3ELi0E"
    assert kv.ptxas_fn("K12", "8x2048x64", "pe_train_fwd_two_groups") == "fwd_wg_kernel"
    builds = kv.sources(None, ("K12", "K14"))
    assert set(builds) == K12_K14_BUILDS | {"pe_train_stats", "pe_train_bwd_sums", "pe_train_frozen_bwd",
                                            "pe_train_bwd_sums_ties", "pe_train_frozen_bwd_ties"}
    mma_sync = builds["pe_train_fwd_mma_sync"][1]
    assert mma_sync == builds["pe_train_bwd_dw_mma_sync"][1]
    assert "launch_fwd(chans" not in mma_sync and "launch<kFwd, 3>(chans" in mma_sync
    assert "launch<kBwdDw, 0>(chans" in mma_sync and "resident_dw(warps)" not in mma_sync
    assert "kFwdGroups = 2, kFwdBlocks = 2;" in builds["pe_train_fwd_two_groups"][1]
    assert "kDwChains = 1, kDwStages = 3;" in builds["pe_train_bwd_dw_one_chain_ring3"][1]
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115pe_train_kernelILi2ELi2EEEvPKf' for 'sm_90a'\n"
           "ptxas info    : Used 126 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115pe_train_kernelILi2ELi1EEEvPKf' for 'sm_90a'\n"
           "    24 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers\n")
    assert kv.ptxas_record(log, kv.ptxas_fn("K13", "8x2048x256 layer 1")) == dict(
        registers=128, spill_stores=24, spill_loads=16, smem=0)
    assert kv.ptxas_record(log, kv.ptxas_fn("K13", "8x2048x64 layer 2"))["registers"] == 126


def _literals(path: Path) -> dict:
    """{name: the int constants a source binds to it}: plain and tuple assignments, and keyword arguments."""
    import ast

    found = {}
    for node in ast.walk(ast.parse(path.read_text())):
        pairs = []
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    pairs.append((t, node.value))
                elif isinstance(t, ast.Tuple) and isinstance(node.value, ast.Tuple):
                    pairs += zip(t.elts, node.value.elts)
            pairs = [(t.id, v) for t, v in pairs if isinstance(t, ast.Name)]
        elif isinstance(node, ast.keyword) and node.arg:
            pairs = [(node.arg, node.value)]
        for name, v in pairs:
            if isinstance(v, ast.Constant) and type(v.value) is int:
                found.setdefault(name, set()).add(v.value)
    return found


def test_tpu_profile_bounds_tool_counts_each_kernel_once(capsys):
    """``tools/tpu_profile_bounds.py`` bounds the five TPU profiling kernels of ``benchmarks/`` (the port
    carries them in ``unopose_tpu_torch/benchmarks/``, K23-K27), one row each at the call sites the kernel
    table names, on the shapes those benchmarks
    set (read from their sources): the fine-PE ablation's both scales' MLP on the first nsample2 / 2 slots
    of each of 2 x B x P points, profile_r9's on all S2 slots of B x N points, the compaction kernels' bytes
    from their (B, ROWS, C x W) words and (B, ROWS, K2) outputs, of the words only the sectors the gather's
    draws touch; the integer-operation counts are marked as estimates."""
    import json

    from unopose_tpu_torch.tools import tpu_profile_bounds as tb

    for path, shapes in tb.SHAPES.items():
        lits = _literals(ROOT / path)
        for name, value in shapes.items():
            assert lits.get(name) == {value}, (path, name, lits.get(name))
    assert tb.main() == 0
    rows = {r["kernel"]: r for r in json.loads(capsys.readouterr().out)["computed"]}
    assert list(rows) == ["benchmarks/profile_pe_ablate.py:68", "benchmarks/profile_compact_micro.py:34",
                          "benchmarks/profile_compact_micro.py:54", "benchmarks/profile_compact_micro.py:134",
                          "benchmarks/profile_r9.py:100"]
    for site, r in rows.items():
        assert (ROOT / site.split(":")[0]).is_file()
        assert r["operations_estimated"] == ("compact_micro" in site)
    mlp = 2 * (6 * 32 + 32 * 64 + 64 * 128)
    pe = _literals(ROOT / "benchmarks/profile_pe_ablate.py")
    (B,), (P,), (s2,) = pe["B"], pe["P"], pe["nsample2"]
    assert rows["benchmarks/profile_pe_ablate.py:68"]["operations"] == 2 * (2 * B * P) * (s2 // 2) * mlp
    r9 = _literals(ROOT / "benchmarks/profile_r9.py")
    (B,), (N,), (S2,) = r9["B"], r9["N"], r9["S2"]
    assert rows["benchmarks/profile_r9.py:100"]["operations"] == 2 * B * N * S2 * mlp
    cm = _literals(ROOT / "benchmarks/profile_compact_micro.py")
    (B,), (R,), (C,), (W,), (K2,) = cm["B"], cm["ROWS"], cm["C"], cm["W"], cm["K2"]
    words, outs = B * R * C * W * 4, B * R * K2 * 4
    assert rows["benchmarks/profile_compact_micro.py:34"]["bytes"] == words + outs  # the words in, the outputs
    # the gather: the 32-byte sectors its K2 uniform draws a row touch, in expectation, and both index tensors
    touched = B * R * (C * W // 8) * (1 - (1 - 8 / (C * W)) ** K2)
    assert rows["benchmarks/profile_compact_micro.py:54"]["bytes"] == pytest.approx(touched * 32 + 3 * outs)
    assert rows["benchmarks/profile_compact_micro.py:134"]["bytes"] == outs // 2 + outs  # half the indices read


def _fma32(a, b, c):
    """fmaf in numpy: a * b + c rounded once to float32. The product is exact
    in float64 and the float64 sum rounds once more; where that sum lands
    exactly halfway between two floats, the sum's error (TwoSum) says which
    way the exact value lies."""
    a, b, c = (np.asarray(x, np.float32).astype(np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(r.astype(np.float64) < s, np.float32(np.inf), np.float32(-np.inf)))
    half = (r.astype(np.float64) + other.astype(np.float64)) / 2 == s
    up = np.maximum(r, other)
    down = np.minimum(r, other)
    return np.where(half & (err > 0), up, np.where(half & (err < 0), down, r))


def _div_fast(e, l, y):
    q = e * y
    return _fma32(_fma32(-l, q, e), y, q)


def _div_exact(e, l, y):
    es = e * np.float32(2.0**64)
    q = _div_fast(es, l, y)
    r = _fma32(-l, q, es)
    c = q * np.float32(2.0**-64)
    exact = q.astype(np.float64) * 2.0**-64
    down = exact.astype(np.float32)
    down = np.where(np.abs(down.astype(np.float64)) > np.abs(exact), np.nextafter(down, np.float32(0)), down)
    tiny = np.where(q - down * np.float32(2.0**64) != np.float32(2.0**-86), c,
                    np.where(r > 0, down + np.float32(2.0**-149), np.where(r < 0, down, c)))
    return np.where(e >= np.float32(2.0**-80), _div_fast(e, l, y), tiny)


@pytest.mark.parametrize("helper", ["div_fast", "div_exact"])
def test_fast_division_is_the_ieee_quotient(helper):
    """``kernels/csrc/fast_div.cuh`` (K7's and K9's division without its slow
    path), transcribed in numpy float32: the quotient of e >= 0 (div_exact;
    div_fast from 2^-80 on) by a softmax sum 1 <= l < 2^12, from y = 1 / l
    rounded to nearest, equals numpy's float32 division, over every exponent
    of e from the subnormals up, and over quotients exactly halfway between
    two subnormals or within a rounding of such a point (where the scaled
    quotient's residual decides)."""
    with open(PORT / "kernels" / "csrc" / "fast_div.cuh") as f:
        src = f.read()
    assert "fmaf(fmaf(-l, q, e), y, q)" in src and "down + 0x1p-149f" in src  # the lines transcribed here
    rng = np.random.default_rng(0)
    lo = -80 if helper == "div_fast" else -149
    exps = np.repeat(np.arange(lo, 128), 2000)
    e = np.ldexp(rng.uniform(1.0, 2.0, exps.size), exps).astype(np.float32)
    l = rng.uniform(1.0, 4096.0, exps.size).astype(np.float32)
    l[::7] = np.floor(l[::7])  # integer sums too
    if helper == "div_exact":
        # e / l exactly halfway between two subnormals (l = 2m, e = m (2k + 1) 2^-149), and e / l within a
        # rounding of such a point (e = l (2k + 1) 2^-150 rounded: the scaled quotient may round onto it)
        m = rng.integers(1, 2048, 200000)
        k = rng.integers(0, 2**23 // m)
        l_near = rng.uniform(1.0, 4096.0, 200000).astype(np.float32)
        e_near = l_near * np.ldexp((2 * rng.integers(0, 2**22, 200000) + 1).astype(np.float64), -150)
        e = np.concatenate([e, np.ldexp((m * (2 * k + 1)).astype(np.float64), -149).astype(np.float32),
                            e_near.astype(np.float32), np.zeros(1, np.float32)])
        l = np.concatenate([l, (2 * m).astype(np.float32), l_near, np.ones(1, np.float32)])
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        y = np.float32(1.0) / l
        got = (_div_fast if helper == "div_fast" else _div_exact)(e, l, y)
        want = e / l
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


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
def test_pe_train_kernels_match_plain(cuda):
    """K11-K14 against their plain passes on the card (B 2, P 256, S 64 and
    256, the last two thirds of each point's slots duplicating the first):
    the batch statistics within 1e-4 relative; the pooled output, every
    layer's sums and the dW within 1e-2 of each tensor's max (bf16 rounding
    flips where float32 sums reassociate); the tie counts equal; each
    backward pass fed its own side's forward max; and a whole forward and
    backward through the autograd function launches each kernel."""
    Ws, gammas, betas = _pe_train_params(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for S in (64, 256):
        chans = torch.randn(2, 6, 256, S, device=cuda, generator=gen) * 0.3
        chans[..., S // 3:] = chans[..., :1]
        chans = chans.contiguous()
        bn, gb = pe_train.stats_buffer(gammas, betas, cuda)
        for depth in (1, 2, 3):
            pe_train.stats_plain(chans, Ws, gb, bn, depth, 1e-5)
            got = bn.clone()
            pe_train.stats_cuda(chans, Ws, gb, got, depth, 1e-5)
            d = pe_train.DIMS[depth]
            for row in (pe_train.MU, pe_train.VAR):
                want = bn[depth - 1, row, :d]
                assert ((got[depth - 1, row, :d] - want).abs().max() / want.abs().max()).item() < 1e-4
        pooled, cnt = pe_train.fwd_plain(chans, Ws, bn)
        k_pooled, k_cnt = pe_train.fwd_cuda(chans, Ws, bn)
        assert ((k_pooled - pooled).abs().max() / pooled.abs().max()).item() < 1e-2 and torch.equal(k_cnt, cnt)
        dpool = torch.randn(2, 256, 128, device=cuda, generator=gen)
        for layer in (3, 2, 1):
            got = bn.clone()
            pe_train.bwd_sums_plain(chans, Ws, bn, pooled, cnt, dpool, layer)
            pe_train.bwd_sums_cuda(chans, Ws, got, k_pooled, k_cnt, dpool, layer)
            for row in (pe_train.SG, pe_train.SGZ):
                want = bn[layer - 1, row, : pe_train.DIMS[layer]]
                assert ((got[layer - 1, row, : pe_train.DIMS[layer]] - want).abs().max() / want.abs().max()).item() < 1e-2
        for a, b in zip(pe_train.bwd_dw_cuda(chans, Ws, bn, k_pooled, k_cnt, dpool),
                        pe_train.bwd_dw_plain(chans, Ws, bn, pooled, cnt, dpool)):
            assert ((a - b).abs().max() / b.abs().max()).item() < 1e-2
    before = dict(LAUNCHES)
    params = [t.clone().requires_grad_() for t in (*Ws, *gammas, *betas)]
    out, _ = pe_train.pe_mlp_bn_pool_train(chans, params[:3], params[3:6], params[6:])
    out.sum().backward()
    torch.cuda.synchronize()
    counts = {k: LAUNCHES[k] - before.get(k, 0) for k in ("pe_train_stats", "pe_train_fwd", "pe_train_bwd_sums",
                                                          "pe_train_bwd_dw")}
    assert counts == dict(pe_train_stats=3, pe_train_fwd=1, pe_train_bwd_sums=3, pe_train_bwd_dw=1)
    assert all(torch.isfinite(p.grad).all() for p in params)


@pytest.mark.cuda
def test_pe_train_split_entry_points(cuda):
    """K11's data-parallel entry points (block pass, then the finish from its
    float64 sums) at one rank's count fill the statistics buffer bitwise as
    the one-call entry point does, at S 64 and 256; K13 and K14 read the
    spare row's 1/n (at one rank's count bitwise as with 0; at
    twice the count K14 against the plain pass given the same row, within
    1e-2 of each tensor's max, each side fed its own forward)."""
    Ws, gammas, betas = _pe_train_params(cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for S in (64, 256):
        chans = torch.randn(2, 6, 256, S, device=cuda, generator=gen) * 0.3
        chans[..., S // 3:] = chans[..., :1]
        chans = chans.contiguous()
        n = 2 * 256 * S
        bn, gb = pe_train.stats_buffer(gammas, betas, cuda)
        split = bn.clone()
        for depth in (1, 2, 3):
            pe_train.stats_cuda(chans, Ws, gb, bn, depth, 1e-5)
            sums = pe_train.stats_partial_cuda(chans, Ws, split, depth)
            assert sums.dtype == torch.float64 and tuple(sums.shape) == (2, 128)
            pe_train.stats_finish_cuda(sums, gb, split, depth, n, 1e-5)
            assert torch.equal(bn, split), (S, depth)
        pooled, cnt = pe_train.fwd_cuda(chans, Ws, bn)
        dpool = torch.randn(2, 256, 128, device=cuda, generator=gen)
        split[0, pe_train.INV_N, 0] = 1.0 / n
        for layer in (3, 2, 1):
            pe_train.bwd_sums_cuda(chans, Ws, bn, pooled, cnt, dpool, layer)
            pe_train.bwd_sums_cuda(chans, Ws, split, pooled, cnt, dpool, layer)
            assert torch.equal(bn[:, :pe_train.INV_N], split[:, :pe_train.INV_N]), (S, layer)
        local = bn.clone()
        local[0, pe_train.INV_N, 0] = 1.0 / n
        dw = pe_train.bwd_dw_cuda(chans, Ws, bn, pooled, cnt, dpool)
        assert all(torch.equal(a, b) for a, b in zip(dw, pe_train.bwd_dw_cuda(chans, Ws, local, pooled, cnt, dpool)))
        doubled = bn.clone()
        doubled[0, pe_train.INV_N, 0] = 1.0 / (2 * n)
        got = pe_train.bwd_dw_cuda(chans, Ws, doubled, pooled, cnt, dpool)
        want = pe_train.bwd_dw_plain(chans, Ws, doubled, *pe_train.fwd_plain(chans, Ws, bn), dpool)
        assert any(not torch.equal(a, b) for a, b in zip(got, dw))
        for a, b in zip(got, want):
            assert ((a - b).abs().max() / b.abs().max()).item() < 1e-2


@pytest.mark.cuda
def test_pe_train_odd_tiles(cuda):
    """The train passes at S 16 and 48 (an odd number of 16-slot tiles: the
    second tile of K13's last layer-3 step runs idle), 80 and 112 (K12's and
    K14's ragged last 64-slot tile) and P 37 against their plain passes at
    the gates of test_pe_train_kernels_match_plain, K14 and K18 too; K12's
    pooled within the gate and its tie counts equal. At S 16 and 48 every
    point's max agrees with the plain forward's within 1e-4 of the largest,
    and each backward takes the full cotangent. Each backward finds its max
    slots by an exact compare with its own forward's recompute: where the
    kernel's and the plain forward's bf16 roundings part, a point's max can
    sit on another slot (at S 80 here, on the first design's build too), and
    one such point moves a sum over 3 x 37 points past the gate. So at S 80
    and 112 the points whose max moves by more than 1e-5 of the largest (at
    most 2) take no cotangent on either side."""
    Ws, gammas, betas = _pe_train_params(cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)

    def cotangent_on_agreeing(cotangent, got, want):
        gap = ((got - want).abs() / want.abs().max()).amax(dim=-1, keepdim=True)
        if S <= 48:
            assert (gap <= 1e-4).all()
            return cotangent
        assert int((gap > 1e-5).sum()) <= 2
        return cotangent * (gap <= 1e-5)

    for S in (16, 48, 80, 112):
        chans = torch.randn(3, 6, 37, S, device=cuda, generator=gen) * 0.3
        chans[..., S // 3:] = chans[..., :1]
        chans = chans.contiguous()
        bn, gb = pe_train.stats_buffer(gammas, betas, cuda)
        for depth in (1, 2, 3):
            pe_train.stats_plain(chans, Ws, gb, bn, depth, 1e-5)
        pooled, cnt = pe_train.fwd_plain(chans, Ws, bn)
        k_pooled, k_cnt = pe_train.fwd_cuda(chans, Ws, bn)
        assert torch.equal(k_cnt, cnt)
        assert ((k_pooled - pooled).abs().max() / pooled.abs().max()).item() < 1e-2
        cotangent = torch.randn(3, 37, 128, device=cuda, generator=gen)
        dpool = cotangent_on_agreeing(cotangent, k_pooled, pooled)
        for layer in (3, 2, 1):
            got = bn.clone()
            pe_train.bwd_sums_plain(chans, Ws, bn, pooled, cnt, dpool, layer)
            pe_train.bwd_sums_cuda(chans, Ws, got, k_pooled, k_cnt, dpool, layer)
            for row in (pe_train.SG, pe_train.SGZ):
                want = bn[layer - 1, row, : pe_train.DIMS[layer]]
                assert ((got[layer - 1, row, : pe_train.DIMS[layer]] - want).abs().max() / want.abs().max()).item() < 1e-2
        for a, b in zip(pe_train.bwd_dw_cuda(chans, Ws, bn, k_pooled, k_cnt, dpool),
                        pe_train.bwd_dw_plain(chans, Ws, bn, pooled, cnt, dpool)):
            assert ((a - b).abs().max() / b.abs().max()).item() < 1e-2
        frozen = pe_train.frozen_buffer(gammas, betas, [g * 0.1 for g in gammas], [g.abs() + 0.5 for g in gammas],
                                        1e-5, cuda)
        f_pooled, f_cnt = pe_train.fwd_plain(chans, Ws, frozen)
        kf_pooled, kf_cnt = pe_train.fwd_cuda(chans, Ws, frozen)
        assert torch.equal(kf_cnt, f_cnt)
        dpool = cotangent_on_agreeing(cotangent, kf_pooled, f_pooled)
        want_bn, got_bn = frozen.clone(), frozen.clone()
        want = pe_train.frozen_bwd_plain(chans, Ws, want_bn, f_pooled, f_cnt, dpool)
        got = pe_train.frozen_bwd_cuda(chans, Ws, got_bn, kf_pooled, kf_cnt, dpool)
        pairs = [*zip(got, want), *((got_bn[l, r, :d], want_bn[l, r, :d]) for l, d in enumerate(pe_train.DIMS[1:])
                                    for r in (pe_train.SG, pe_train.SGZ))]
        for a, b in pairs:
            assert ((a - b).abs().max() / b.abs().max()).item() < 1e-2


@pytest.mark.cuda
def test_fps_kernel_matches_plain(cuda):
    """K1's indices equal to the plain loop's: the template's 5000 -> 2048 and
    -> 196, the clouds' 2048 -> 196, an N that is not a multiple of the
    1024-thread block, npoint = N, and the largest N the kernel takes
    (``fps.MAX_N``, its coordinates read from shared memory)."""
    rng = np.random.default_rng(0)
    pts = _lrf_cloud(rng, 4, 5000, cuda)
    for k in (2048, 196):
        assert torch.equal(fps_mod.fps_cuda(pts, k), fps_mod.fps_plain(pts, k))
    for B, N, k in ((4, 2048, 196), (3, 4097, 300), (2, 700, 700), (2, fps_mod.MAX_N, 128)):
        pts = _lrf_cloud(rng, B, N, cuda)
        assert torch.equal(fps_mod.fps_cuda(pts, k), fps_mod.fps_plain(pts, k)), (B, N, k)


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


@pytest.mark.cuda
def test_geo_rpe_kernel_matches_plain(cuda):
    """int8 codes equal but for one step on at most 0.1% of entries, with
    bf16 (bf16 model) and float32 (float32 model) contraction; the float32
    store within 1e-5 of the channel bound 1.25 (max|T_d| + max|T_a|), the
    bf16 store equal but for one bf16 ulp on at most 0.1% of entries."""
    from unopose_tpu_torch.models.embedding import knn_anchor_vectors

    rng = np.random.default_rng(2)
    pts = torch.cat([torch.ones(4, 1, 3, device=cuda), _lrf_cloud(rng, 4, 196, cuda)], dim=1)
    _, ref_vec = knn_anchor_vectors(pts, 3)
    for D in (256, 32):
        W, b = torch.randn(D, D, device=cuda) / D**0.5, torch.randn(D, device=cuda) * 0.1
        tab_d, sd = geo_fused.build_taylor_table(W, b, 18.2, 128)
        tab_a, sa = geo_fused.build_taylor_table(W.t().contiguous(), b, 12.0, 128)
        args = (pts, ref_vec, tab_d, tab_a, sd, sa, 0.2, 3.8)
        for dtype in (torch.bfloat16, torch.float32):
            (e8, sc) = geo_fused.geo_rpe_fused_cuda(*args, dtype, True)
            (p8, psc) = geo_fused.geo_rpe_fused_plain(*args, dtype, True)
            steps = (e8.int() - p8.int()).abs()
            assert int(steps.max()) <= 1 and steps.gt(0).float().mean().item() <= 1e-3 and torch.equal(sc, psc)
        bound = 1.25 * (tab_d.abs().amax(0) + tab_a.abs().amax(0))
        e, p = geo_fused.geo_rpe_fused_cuda(*args), geo_fused.geo_rpe_fused_plain(*args)
        assert e.dtype == torch.float32 and e.shape == p.shape
        assert bool(((e - p).abs() <= 1e-5 * bound).all())
        e, p = (f(*args, torch.bfloat16) for f in (geo_fused.geo_rpe_fused_cuda, geo_fused.geo_rpe_fused_plain))
        assert e.dtype == torch.bfloat16 and e.shape == p.shape
        diff = (e.float() - p.float()).abs()
        one_ulp = diff <= 2.0 ** (torch.frexp(p.float().abs())[1] - 8).float()
        assert bool(one_ulp.all()) and diff.gt(0).float().mean().item() <= 1e-3


@pytest.mark.cuda
def test_geo_rpe_kernel_edges(cuda):
    """The layouts' edges at the gates above: one point (N 1), the main N 197
    (a 5-column last unit of 32) and MAX_N 512, at D 32 (32-channel tiles)
    and 256 (bf16 tables of 256 channels, float32 of 128), with both
    contraction dtypes; and k 1 and 4 anchor angles at MAX_N, D 256."""
    from unopose_tpu_torch.models.embedding import knn_anchor_vectors

    rng = np.random.default_rng(5)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for N in (1, 197, geo_fused.MAX_N):
        if N == 1:
            pts = torch.ones(4, 1, 3, device=cuda)
            ref_vec = torch.randn(4, 1, 3, 3, device=cuda, generator=gen)
        else:
            pts = torch.cat([torch.ones(4, 1, 3, device=cuda), _lrf_cloud(rng, 4, N - 1, cuda)], dim=1)
            _, ref_vec = knn_anchor_vectors(pts, 3)
        for D in (32, 256):
            W = torch.randn(D, D, device=cuda, generator=gen) / D**0.5
            b = torch.randn(D, device=cuda, generator=gen) * 0.1
            tab_d, sd = geo_fused.build_taylor_table(W, b, 18.2, 128)
            tab_a, sa = geo_fused.build_taylor_table(W.t().contiguous(), b, 12.0, 128)
            args = (pts, ref_vec, tab_d, tab_a, sd, sa, 0.2, 3.8)
            for dtype in (torch.bfloat16, torch.float32):
                (e8, sc) = geo_fused.geo_rpe_fused_cuda(*args, dtype, True)
                (p8, psc) = geo_fused.geo_rpe_fused_plain(*args, dtype, True)
                steps = (e8.int() - p8.int()).abs()
                assert int(steps.max()) <= 1 and steps.gt(0).float().mean().item() <= 1e-3, (N, D, dtype)
                assert torch.equal(sc, psc)
    # angle counts other than the model's 3 go through the build that reads k at run time
    for k in (1, 4):
        _, ref_vec = knn_anchor_vectors(pts, k)
        (e8, sc) = geo_fused.geo_rpe_fused_cuda(pts, ref_vec, *args[2:], torch.bfloat16, True)
        (p8, psc) = geo_fused.geo_rpe_fused_plain(pts, ref_vec, *args[2:], torch.bfloat16, True)
        steps = (e8.int() - p8.int()).abs()
        assert int(steps.max()) <= 1 and steps.gt(0).float().mean().item() <= 1e-3 and torch.equal(sc, psc), k


@pytest.mark.cuda
def test_pe_kernels_match_plain(cuda):
    """Channels: rel xyz bitwise, unequal entries at most twice the plain
    version's own one-ulp spread; pool (fed the plain channels) within 1e-2
    of its max."""
    pts = _lrf_cloud(np.random.default_rng(3), 4, 2048, cuda)
    planes, idx_p, w1, w2, total2, overflow = ball_query.two_scale_group_first_k_packed_idx(0.1, 64, 0.2, 256, pts)
    assert not bool(overflow)
    center = tuple(pts.unbind(-1))
    got = pe_fused.pe_channels_cuda(planes, idx_p, w1, w2, total2, center, 0.1, 0.2)
    want = pe_fused.pe_channels_plain(planes, idx_p, w1, w2, total2, center, 0.1, 0.2)
    up = lambda x: torch.nextafter(x, torch.full_like(x, float("inf")))
    nudged = pe_fused.pe_channels_plain(tuple(map(up, planes)), idx_p, w1, w2, total2, tuple(map(up, center)), 0.1, 0.2)
    need = torch.arange(256, device=cuda)[None, None, :] < (pe_fused.chunks_needed(total2, 256) * 64)[..., None]
    g, w, n = got[need].float(), want[need].float(), nudged[need].float()
    assert torch.equal(g[:, [0, 1, 2, 6, 7, 8]], w[:, [0, 1, 2, 6, 7, 8]])
    assert (g != w).sum() <= 2 * (n != w).sum()
    mlp = [([torch.randn(6, 32, device=cuda) * 0.3, torch.randn(32, 64, device=cuda) * 0.3,
             torch.randn(64, 128, device=cuda) * 0.3], [torch.randn(d, device=cuda) * 0.1 for d in (32, 64, 128)])
           for _ in range(2)]
    pooled = pe_fused.pe_mlp_pool_cuda(want, w1, w2, total2, pe_fused.pack_mlp(*mlp))
    ref = pe_fused.pe_mlp_pool_plain(want, w1, w2, total2, *mlp)
    assert (pooled - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


@pytest.mark.cuda
def test_pe_kernels_match_plain_on_surfaces(cuda):
    """On sphere surfaces with points in all four 64-slot tiers (the 3- and
    4-chunk loops run), where the local frames are well conditioned: at
    least 99.9% of the needed channel entries within one bf16 ulp of the
    plain version's, none more than 2^-5 off (two ulps at the channels'
    largest magnitude, 2); pool (fed the plain channels) within 1e-2 of its
    max."""
    perm, _ = ball_query.permutation(2048, "cpu")
    pts = torch.from_numpy(surface_clouds(np.random.default_rng(4), 4, perm.numpy())).to(cuda)
    planes, idx_p, w1, w2, total2, overflow = ball_query.two_scale_group_first_k_packed_idx(0.1, 64, 0.2, 256, pts)
    chunks = pe_fused.chunks_needed(total2, 256)
    assert not bool(overflow) and torch.bincount(chunks.flatten(), minlength=5)[1:].min().item() >= 1000
    center = tuple(pts.unbind(-1))
    got = pe_fused.pe_channels_cuda(planes, idx_p, w1, w2, total2, center, 0.1, 0.2)
    want = pe_fused.pe_channels_plain(planes, idx_p, w1, w2, total2, center, 0.1, 0.2)
    need = torch.arange(256, device=cuda)[None, None, :] < (chunks * 64)[..., None]
    g, w = got[need].float(), want[need].float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    diff = (g - w).abs()
    assert (diff <= torch.ldexp(torch.ones_like(diff), e - 8)).float().mean().item() >= 0.999
    assert diff.max().item() <= 2.0**-5
    mlp = [([torch.randn(6, 32, device=cuda) * 0.3, torch.randn(32, 64, device=cuda) * 0.3,
             torch.randn(64, 128, device=cuda) * 0.3], [torch.randn(d, device=cuda) * 0.1 for d in (32, 64, 128)])
           for _ in range(2)]
    pooled = pe_fused.pe_mlp_pool_cuda(want, w1, w2, total2, pe_fused.pack_mlp(*mlp))
    ref = pe_fused.pe_mlp_pool_plain(want, w1, w2, total2, *mlp)
    assert (pooled - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


@pytest.mark.cuda
def test_subset_kernels_match_plain(cuda):
    """The subset grouping bitwise equal to its plain twin (every output, miss
    slots included) at S 64 and 256; the masked PE on those groupings with
    at most twice as many entries unequal to the plain twin's as the plain
    twin shows against itself one ulp up (the uniform cubes' frames are ill
    conditioned, as for the PE-v5 channels)."""
    pts = _lrf_cloud(np.random.default_rng(5), 4, 2048, cuda)
    groups = []
    for r, S in ((0.1, 64), (0.2, 256)):
        got, want = ball_query.ball_group_subset_cuda(r, S, pts), ball_query.ball_group_subset_plain(r, S, pts)
        for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(got[2], want[2]) and 0 < want[2].float().mean().item() < 1
        groups += [want[0], want[2]]
    mlp = [([torch.randn(6, 32, device=cuda) * 0.3, torch.randn(32, 64, device=cuda) * 0.3,
             torch.randn(64, 128, device=cuda) * 0.3], [torch.randn(d, device=cuda) * 0.1 for d in (32, 64, 128)])
           for _ in range(2)]
    center = tuple(pts.unbind(-1))
    got = pe_fused.pe_fused_masked_cuda(*groups, center, 0.1, 0.2, pe_fused.pack_mlp(*mlp))
    want = pe_fused.pe_fused_masked_plain(*groups, center, *mlp, 0.1, 0.2)
    up = lambda xs: tuple(torch.nextafter(x, torch.full_like(x, float("inf"))) for x in xs)
    nudged = pe_fused.pe_fused_masked_plain(up(groups[0]), groups[1], up(groups[2]), groups[3], up(center), *mlp,
                                            0.1, 0.2)
    assert (got != want).sum() <= 2 * (nudged != want).sum()


@pytest.mark.cuda
def test_mha_fused_kernel_matches_plain(cuda):
    """bf16 at the ViT-B shape, read in place from the qkv output, at the
    tiny config's hd 16, at ragged N (a one-row last tile, the register
    budget's 272 and past it, where the scores are recomputed per pass), at
    every hd the kernel takes, and with q scaled by 40 (scores far below
    their row's max: the division's exact path for tiny quotients): at
    least 99% of outputs bitwise equal to the plain twin and none more than
    one bf16 ulp of its row's largest output off (float32 sums in another
    order); the float32 variant within 1e-5 of the output's max. An N whose
    K and V exceed a block's shared memory raises the launcher's error, and
    the card goes on working."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    both = (torch.bfloat16, torch.float32)
    cases = [(32, 261, 12, 64, both, 1.0), (4, 9, 2, 16, both, 1.0), (4, 261, 12, 64, (torch.bfloat16,), 40.0)]
    cases += [(4, N, 12, 64, both, 1.0) for N in (1, 17, 257, 261, 272, 273, 289)]
    cases += [(4, 261, 4, hd, (torch.bfloat16,), 1.0) for hd in range(16, 129, 16)]
    for B, N, H, hd, dtypes, q_scale in cases:
        for dtype in dtypes:
            qkv = torch.randn(B, N, 3 * H * hd, device=cuda, generator=gen)
            qkv[..., : H * hd] *= q_scale
            qkv = qkv.to(dtype)
            q, k, v = qkv.split(H * hd, dim=-1)
            got, want = vit_attn.mha_fused_cuda(q, k, v, H).float(), vit_attn.mha_fused_plain(q, k, v, H).float()
            if dtype == torch.float32:
                assert (got - want).abs().max() <= 1e-5 * want.abs().max()
                continue
            _, e = torch.frexp(want.abs().amax(dim=-1, keepdim=True))
            assert (got == want).float().mean() >= 0.99
            assert ((got - want).abs() <= torch.ldexp(torch.ones_like(got), e - 8)).all()
    big = torch.randn(1, 1024, 3 * 128, device=cuda, generator=gen).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="mha_fused"):
        vit_attn.mha_fused_cuda(*big.split(128, dim=-1), 1)
    assert torch.ones(4, device=cuda).sum().item() == 4.0


@pytest.mark.cuda
def test_fine_assign_kernels_match_plain(cuda):
    """Each sweep against its plain twin on the same inputs (two pairs of
    2049 x 2049 at C 256, and C 32 at 300 x 300): column and row statistics
    within 1e-5 relative, labels equal on at least 99.9% of rows and columns
    (near ties under another float32 summation order), sums within 1e-4 of
    their max."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    for B, M, C in ((2, 2049, 256), (2, 300, 32)):
        f1, f2 = (torch.randn(B, M, C, device=cuda, generator=gen) for _ in range(2))
        f1[:, : 3 * M // 4] = f2[:, : 3 * M // 4] + 0.5 * f1[:, : 3 * M // 4]
        score = torch.rand(B, 2 * (M - 1), device=cuda, generator=gen)
        pts2 = torch.rand(B, M - 1, 3, device=cuda, generator=gen)
        f1n, f2n, s1, s2 = assignment_fused.operands(f1, f2, score, 0.1)
        cm, cs = assignment_fused.colstats_plain(f1n, f2n)
        for a, b in zip(assignment_fused.colstats_cuda(f1n, f2n), (cm, cs)):
            assert ((a - b).abs() <= 1e-5 * b.abs().clamp_min(1.0)).all()
        rm, rs, l1, l2 = assignment_fused.labels_plain(f1n, f2n, cm, cs, s1, s2)
        got = assignment_fused.labels_cuda(f1n, f2n, cm, cs, s1, s2)
        for a, b in zip(got[:2], (rm, rs)):
            assert ((a - b).abs() <= 1e-5 * b.abs().clamp_min(1.0)).all()
        assert (got[2] == l1).float().mean() >= 0.999 and (got[3] == l2).float().mean() >= 0.999
        args = (f1n, f2n, cm, cs, s1, s2, rm, rs, l1, l2, pts2)
        for a, b in zip(assignment_fused.accum_cuda(*args), assignment_fused.accum_plain(*args)):
            assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def _labels_case(gen, B, M, C, dev, q_scale=1.0):
    """Operands of one labels case: three quarters of the rows match a
    column; columns 1-8 duplicated at 9-16 and rows 1-8 at 9-16 (with their
    scores), so pred has exact ties along rows and columns; column 17's
    score 0, so its pred is 0 on every row; f1n scaled by q_scale."""
    f1, f2 = (torch.randn(B, M, C, device=dev, generator=gen) for _ in range(2))
    f1[:, : 3 * M // 4] = f2[:, : 3 * M // 4] + 0.5 * f1[:, : 3 * M // 4]
    score = torch.rand(B, 2 * (M - 1), device=dev, generator=gen)
    if M > 17:
        f1[:, 9:17], f2[:, 9:17] = f1[:, 1:9], f2[:, 1:9]
        score[:, 8:16] = score[:, :8]  # s1 of rows 9-16 (score row i - 1)
        score[:, M - 1 + 8: M - 1 + 16] = score[:, M - 1: M - 1 + 8]  # s2 of columns 9-16
        score[:, M - 1 + 16] = 0.0  # s2 of column 17
    f1n, f2n, s1, s2 = assignment_fused.operands(f1, f2, score, 0.1)
    return (f1n.float() * q_scale).to(torch.bfloat16), f2n, s1, s2


@pytest.mark.cuda
def test_fine_assign_labels_edges(cuda):
    """K9 at the edges of its layout, against its plain twin at the gates
    above: M 2049 (a one-row last tile), 65 and 300, C 32 and 256; exact ties
    along rows and columns, where the first occurrence wins (label1 never a
    later duplicate column, label2 never a later duplicate row); a column
    whose pred is 0 on every row, whose label2 is row 0; and q scaled by 40,
    where pred underflows (the division's exact path for tiny dividends).
    Two launches on the same inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    for B, M, C, q_scale in ((2, 2049, 256, 1.0), (2, 65, 32, 1.0), (2, 300, 256, 1.0), (2, 300, 32, 1.0),
                             (2, 2049, 256, 40.0)):
        f1n, f2n, s1, s2 = _labels_case(gen, B, M, C, cuda, q_scale)
        cm, cs = assignment_fused.colstats_plain(f1n, f2n)
        rm, rs, l1, l2 = assignment_fused.labels_plain(f1n, f2n, cm, cs, s1, s2)
        got = assignment_fused.labels_cuda(f1n, f2n, cm, cs, s1, s2)
        # the logits' float32 sums differ by summation order in proportion to their size: the gate scales with q
        for a, b in zip(got[:2], (rm, rs)):
            assert ((a - b).abs() <= 1e-5 * q_scale * b.abs().clamp_min(1.0)).all(), (M, C, q_scale)
        assert (got[2] == l1).float().mean() >= 0.999 and (got[3] == l2).float().mean() >= 0.999, (M, C, q_scale)
        again = assignment_fused.labels_cuda(f1n, f2n, cm, cs, s1, s2)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        if M > 17:
            assert not torch.isin(got[2], torch.arange(9, 17, device=cuda)).any()
            assert not torch.isin(got[3], torch.arange(9, 17, device=cuda)).any()
            assert (got[3][:, 17] == 0).all()
        if q_scale > 1.0:
            pred = assignment_fused._pred(assignment_fused._logits(f1n, f2n), cm, cs, s1, s2, rm, rs)
            assert (pred == 0).float().mean() > 0.1  # the case reaches underflow


def _pe_pool_case(gen, B, P, S2, total2, dev):
    """One K6 case: random bf16 channels, multiset weights in {0, 1, 2} on each point's first total2 slots
    (0 past them), the fine PE's MLP shapes with random weights."""
    chans = (torch.randn(B, P, S2, 12, device=dev, generator=gen) * 0.5).to(torch.bfloat16)
    t2 = torch.tensor(total2, dtype=torch.int32, device=dev).reshape(B, P)
    inside = torch.arange(S2, device=dev)[None, None, :] < t2[..., None]
    w1, w2 = ((torch.randint(0, 3, (B, P, S2), device=dev, generator=gen) * inside).to(torch.bfloat16)
              for _ in range(2))
    mlp = [([torch.randn(6, 32, device=dev, generator=gen) * 0.3, torch.randn(32, 64, device=dev, generator=gen) * 0.3,
             torch.randn(64, 128, device=dev, generator=gen) * 0.3],
            [torch.randn(d, device=dev, generator=gen) * 0.1 for d in (32, 64, 128)]) for _ in range(2)]
    return chans, w1, w2, t2, mlp


@pytest.mark.cuda
def test_pe_mlp_pool_edges(cuda):
    """K6 at the edges of its layout, against its plain twin at chip_smoke.py's gate (within 1e-2 of the
    output's max): points with total2 0, 1, 64, 65 and 256 (1 to 4 chunks of 64 slots, each clipped to S2),
    S2 64, 128 and 256, point counts that are not a multiple of a block's 8 warps (21 and 1), and a scale
    whose weights are all 0 on a point, whose pooled features are exactly 0, as are both scales of a point
    with total2 0. Then 2 x 2048 points, more than the resident grid's warps (396 blocks of 8 on an H100),
    so that each warp walks several points: total2 cycling 0, 1, 65 and 256 in every block's share, so
    the next point's rows load while a point of another chunk count runs and the running max starts again
    at each point (every point with total2 0 exactly 0 after one with kept slots)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    for S2 in (64, 128, 256):
        for B, P in ((3, 7), (1, 1)):
            total2 = [min(t, S2) for t in (0, 1, 64, 65, 256, 17, 200) * 3][: B * P] if P > 1 else [min(65, S2)]
            chans, w1, w2, t2, mlp = _pe_pool_case(gen, B, P, S2, total2, cuda)
            if P > 1:
                w1[0, 1, 0], w2[0, 1] = 1, 0  # point 1 (total2 1): one kept slot in scale 1, none in scale 2
                w1[1, 3], w2[1, 3, 0] = 0, 1  # point 10 (total2 65, or 64 at S2 64): none kept in scale 1
            got = pe_fused.pe_mlp_pool_cuda(chans, w1, w2, t2, pe_fused.pack_mlp(*mlp))
            want = pe_fused.pe_mlp_pool_plain(chans, w1, w2, t2, *mlp)
            assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item(), (S2, B, P)
            if P > 1:
                assert (got[0, 0] == 0).all() and (got[0, 1, 128:] == 0).all() and (got[1, 3, :128] == 0).all()
                assert (got[0, 1, :128] != 0).any() and (got[1, 3, 128:] != 0).any()
    B, P, S2 = 2, 2048, 256
    total2 = [(0, 1, 65, 256)[i % 4] for i in range(B * P)]
    chans, w1, w2, t2, mlp = _pe_pool_case(gen, B, P, S2, total2, cuda)
    w1[:, 1::8, 0] = 1  # every eighth point of total2 1: one kept slot in scale 1
    got = pe_fused.pe_mlp_pool_cuda(chans, w1, w2, t2, pe_fused.pack_mlp(*mlp))
    want = pe_fused.pe_mlp_pool_plain(chans, w1, w2, t2, *mlp)
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    assert (got[t2 == 0] == 0).all() and (got[t2 == 256] != 0).any(-1).all()
    assert (got[:, 1::8, :128] != 0).any(-1).all()


def _accum_case(gen, B, M1, M2, C, dev):
    """K10's inputs on the plain twins' statistics and labels: three quarters of the query rows match a
    reference row (where M2 allows), scores uniform, pts2 in [-1, 1)^3."""
    f1 = torch.randn(B, M1, C, device=dev, generator=gen)
    f2 = torch.randn(B, M2, C, device=dev, generator=gen)
    m = min(3 * M1 // 4, M2)
    f1[:, :m] = f2[:, :m] + 0.5 * f1[:, :m]
    score = torch.rand(B, M1 - 1 + M2 - 1, device=dev, generator=gen)
    f1n, f2n, s1, s2 = assignment_fused.operands(f1, f2, score, 0.1)
    cm, cs = assignment_fused.colstats_plain(f1n, f2n)
    rm, rs, l1, l2 = assignment_fused.labels_plain(f1n, f2n, cm, cs, s1, s2)
    pts2 = torch.rand(B, M2 - 1, 3, device=dev, generator=gen) * 2 - 1
    return [f1n, f2n, cm, cs, s1, s2, rm, rs, l1, l2, pts2]


@pytest.mark.cuda
def test_fine_assign_accum_edges(cuda):
    """K10 at the edges of its layout, against its plain twin at the gate above (sums within 1e-4 of their
    max): M1, M2 of 65, 130 and 2049, C 16, 64 and 256 (the 32- and 128-byte swizzled tiles); every row
    masked and no live column (wsum and num all 0); one live entry (its row's sums are that entry's terms);
    the bg row 0 even where its label1 is set. Two launches on the same inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    for B, M1, M2, C in ((2, 65, 130, 16), (2, 130, 65, 64), (2, 2049, 2049, 256), (1, 2049, 65, 16),
                         (1, 65, 2049, 256)):
        a = _accum_case(gen, B, M1, M2, C, cuda)
        l1, l2 = a[8].clone(), a[9].clone()
        l1[:, 0] = 1  # the bg row's label is ignored
        cases = {"as is": (l1, l2), "rows masked": (torch.zeros_like(l1), l2),
                 "no live column": (l1, torch.zeros_like(l2))}
        one1, one2 = torch.zeros_like(l1), torch.zeros_like(l2)
        one1[:, M1 // 2], one2[:, M2 - 1] = 3, 5
        cases["one entry"] = (one1, one2)
        for name, (c1, c2) in cases.items():
            args = (*a[:8], c1, c2, a[10])
            got = assignment_fused.accum_cuda(*args)
            want = assignment_fused.accum_plain(*args)
            for g, w in zip(got, want):
                assert (g - w).abs().max() <= 1e-4 * w.abs().max(), (M1, M2, C, name)
            assert all(torch.equal(x, y) for x, y in zip(got, assignment_fused.accum_cuda(*args)))
            assert (got[0][:, 0] == 0).all() and (got[1][:, 0] == 0).all()
            if name in ("rows masked", "no live column"):
                assert not got[0].any() and not got[1].any(), (M1, M2, C, name)
            if name == "one entry":
                assert torch.count_nonzero(got[0]) == B and (got[0][:, M1 // 2] > 0).all(), (M1, M2, C)


@pytest.mark.cuda
def test_fine_colstats_edges(cuda):
    """K8 at the edges of its layout, against its plain twin: M1, M2 of 1, 2, 65, 130 and 2049, C 16, 48,
    64 and 256 (the 32- and 128-byte swizzled tiles, row tiles and column tiles cut by M), rows of a tile
    past M1 never entering a column's statistics, and f1n scaled by 40. The column max within 1e-5
    relative, the sum of exponentials within 1e-5 relative times the largest |logit| / 10: the tensor
    cores and the twin's float32 product round a logit differently by a few of its ulps, and exp carries
    that absolute difference into every term; unit rows over temperature 0.1 give logits of at most 10,
    where this is the gate above, and f1n x 40 logits up to 400 (measured 1.3e-5 there, the kernel's first
    design giving the same bits). Two launches on the same inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    for B, M1, M2, C, q in ((2, 1, 2, 16, 1.0), (2, 65, 130, 48, 1.0), (2, 130, 65, 64, 1.0),
                            (1, 2049, 2049, 256, 1.0), (1, 2049, 65, 16, 40.0), (1, 65, 2049, 256, 40.0)):
        f1n, f2n, _, _ = _labels_case(gen, B, max(M1, M2), C, cuda, q)
        f1n, f2n = f1n[:, :M1].contiguous(), f2n[:, :M2].contiguous()
        got = assignment_fused.colstats_cuda(f1n, f2n)
        cm, cs = assignment_fused.colstats_plain(f1n, f2n)
        scale = max(1.0, torch.matmul(f1n.float(), f2n.float().transpose(1, 2)).abs().max().item() / 10.0)
        assert ((got[0] - cm).abs() <= 1e-5 * cm.abs().clamp_min(1.0)).all(), (M1, M2, C, q)
        assert ((got[1] - cs).abs() <= 1e-5 * scale * cs.abs().clamp_min(1.0)).all(), (M1, M2, C, q)
        assert all(torch.equal(x, y) for x, y in zip(got, assignment_fused.colstats_cuda(f1n, f2n)))


@pytest.mark.cuda
def test_first_k_select_edges(cuda):
    """K3 at the edges of its layout, every output equal to the plain select: budgets k2 of 4, 12 (rows
    written 4 slots a step), 64 and 512; N of 4 and 36 (chunks narrower than a word), 272, 576 and 4096 with
    k2 4096 (fewer warps a block, so that the cloud, masks and rows fit); a cloud whose every centre
    overflows every way, one with a few isolated points among dense ones (the first hits found by a walk in
    original order or by the least key, centre by centre), and the main cubes."""
    rng = np.random.default_rng(13)
    for N, k1, k2 in ((4, 4, 4), (36, 4, 12), (272, 16, 64), (576, 64, 512), (4096, 1024, 4096), (2048, 64, 256)):
        clouds = {"cubes": _lrf_cloud(rng, 2, N, cuda),
                  "dense": torch.from_numpy(rng.uniform(-0.05, 0.05, size=(2, N, 3)).astype(np.float32)).to(cuda)}
        mixed = clouds["cubes"].clone()
        mixed[:, : N // 2] *= 0.05  # half the points packed near the origin, the rest spread out
        clouds["mixed"] = mixed
        perm, inv = ball_query.permutation(N, cuda)
        for name, pts in clouds.items():
            args = (pts, pts.index_select(1, perm.long()), perm, inv, 0.1, k1, 0.2, k2)
            got, want = ball_query.first_k_select_cuda(*args), ball_query.first_k_select_plain(*args)
            for k in ball_query.SELECT_KEYS:
                assert torch.equal(got[k], want[k]), (N, k2, name, k)
            if name == "dense" and N > k2:
                assert bool(want["overflow"]), (N, k2)


def _pe_channels_filled(planes, idx, w1, w2, total2, center, r1=0.1, r2=0.2):
    """K5 through its C entry into an output first filled with 0xffff (a bf16 NaN), so that a slot it leaves
    unwritten shows."""
    import ctypes

    B, N = planes[0].shape
    _, P, S2 = idx.shape
    out = torch.full((B, P, S2, 12), -1, dtype=torch.int16, device=idx.device).view(torch.bfloat16)
    args = (*(p.float().contiguous() for p in planes), idx.contiguous(),
            *(w.to(torch.bfloat16).contiguous() for w in (w1, w2)), total2.to(torch.int32).contiguous(),
            *(c.float().contiguous() for c in center), out)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    build.check(build.load().unopose_pe_channels(*(ctypes.c_void_p(a.data_ptr()) for a in args), B, N, P, S2, r1,
                                                 r2, 1.0 / r1, 1.0 / r2, stream), "pe_channels")
    return out


def _check_channels(got, planes, idx, w1, w2, total2, center, surfaces: bool):
    """K5's output against its plain twin at chip_smoke.py's gates, over the slots each point needs: the rel xyz
    channels bitwise equal; on the uniform cubes at most twice as many unequal entries as the twin shows against
    itself one ulp up, on the sphere surfaces 99.9% within one bf16 ulp and none more than 2^-5 off; every slot
    past a point's tier unwritten (0xffff)."""
    S2 = idx.shape[-1]
    need = torch.arange(S2, device=idx.device)[None, None, :] < (pe_fused.chunks_needed(total2, S2) * 64)[..., None]
    assert (got.view(torch.int16)[~need] == -1).all()
    want = pe_fused.pe_channels_plain(planes, idx, w1, w2, total2, center, 0.1, 0.2)
    g, w = got[need].float(), want[need].float()
    assert torch.equal(g[:, [0, 1, 2, 6, 7, 8]], w[:, [0, 1, 2, 6, 7, 8]])
    if surfaces:
        _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
        diff = (g - w).abs()
        assert (diff <= torch.ldexp(torch.ones_like(diff), e - 8)).float().mean().item() >= 0.999
        assert diff.max().item() <= 2.0**-5
    else:
        up = lambda x: torch.nextafter(x, torch.full_like(x, float("inf")))
        nudged = pe_fused.pe_channels_plain(tuple(map(up, planes)), idx, w1, w2, total2, tuple(map(up, center)), 0.1,
                                            0.2)[need].float()
        assert (g != w).sum() <= 2 * (nudged != w).sum()


@pytest.mark.cuda
def test_pe_channels_edges(cuda):
    """K5 at the edges of its layout, at the gates its first design passed (``_check_channels``): N 4096 (the
    largest cloud it stages); the sphere surfaces, every tier 1-4; every seventh point with total2 0 and no
    weight (one 64-slot chunk of zero weights); S2 64 and 128 (tiers clipped to S2); and point counts that are no
    multiple of a block's 128 points or a warp's 16 (300, 33 and 7 centres of a 2048-point cloud), whose rows
    must equal those of the launch over every point bit for bit (each point's channels depend on it alone).
    Slots past a point's tier stay unwritten, and two launches give the same bits."""
    rng = np.random.default_rng(15)
    perm, _ = ball_query.permutation(2048, "cpu")
    cases = {"cubes N 4096": (_lrf_cloud(rng, 2, 4096, cuda), 256),
             "surfaces": (torch.from_numpy(surface_clouds(rng, 4, perm.numpy())).to(cuda), 256),
             **{f"cubes S2 {s2}": (_lrf_cloud(rng, 4, 2048, cuda), s2) for s2 in (64, 128, 256)}}
    for name, (pts, s2) in cases.items():
        planes, idx, w1, w2, total2, overflow = ball_query.two_scale_group_first_k_packed_idx(0.1, 64, 0.2, s2, pts)
        center = tuple(pts.unbind(-1))
        if name == "cubes S2 256":
            total2, w1, w2 = total2.clone(), w1.clone(), w2.clone()
            total2[:, ::7], w1[:, ::7], w2[:, ::7] = 0, 0, 0
        got = _pe_channels_filled(planes, idx, w1, w2, total2, center)
        _check_channels(got, planes, idx, w1, w2, total2, center, name == "surfaces")
        assert torch.equal(got.view(torch.int16), _pe_channels_filled(planes, idx, w1, w2, total2, center).view(
            torch.int16)), name
        if name == "surfaces":
            assert torch.bincount(pe_fused.chunks_needed(total2, s2).flatten(), minlength=5)[1:].min().item() > 0
        if name == "cubes S2 256":
            for P in (300, 33, 7):
                part = _pe_channels_filled(planes, idx[:, :P], w1[:, :P], w2[:, :P], total2[:, :P],
                                           tuple(c[:, :P] for c in center))
                assert torch.equal(part.view(torch.int16), got[:, :P].view(torch.int16)), P


@pytest.mark.cuda
def test_compact_gather_edges(cuda):
    """K26 equal to its plain twin at 0, 1 and 65536 rows (the compaction script's 256 blocks of 256 rows), and
    on 1000 rows with bank indices outside [0, 16) (16, 17, -1 and the least int32), whose outputs are 0."""
    from unopose_tpu_torch.benchmarks import profile_compact_micro as cm

    d = {k: torch.from_numpy(v).to(cuda) for k, v in cm.script_inputs(np.random.default_rng(16)).items()}
    x, li, bi = d["x"].view(-1, cm.C * cm.W), d["li"].view(-1, cm.K2), d["bi"].view(-1, cm.K2)
    assert x.shape[0] == 65536
    for rows in (0, 1, 65536):
        got = cm.compact_gather_cuda(x[:rows], li[:rows], bi[:rows])
        assert got.shape == (rows, cm.K2) and torch.equal(got, cm.compact_gather_plain(x[:rows], li[:rows], bi[:rows]))
    bad = bi[:1000].clone()
    flat = bad.view(-1)
    flat[0::5], flat[1::5], flat[2::7], flat[3::11] = 16, -1, 17, -(2**31)
    got = cm.compact_gather_cuda(x[:1000], li[:1000], bad)
    assert torch.equal(got, cm.compact_gather_plain(x[:1000], li[:1000], bad))
    assert not got[(bad < 0) | (bad >= cm.BANKS)].any()


@pytest.mark.cuda
def test_hyp_select_kernel_matches_plain(cuda):
    """K17 in both modes (TP in the kernel from bf16 operands; TP read from
    the float32 product) bitwise equal to its plain twins at the main path's
    shapes (B 4 here, P2 300, N 196): the same float32 operations in the
    same order, the row sums in the kernel's lane order. Each launch is
    counted; a model cloud beyond a block's shared memory raises, and the
    card goes on working."""
    from unopose_tpu_torch.ops import hyp_select

    gen = torch.Generator(device=cuda).manual_seed(2)
    B, N, P2 = 4, 196, 300
    pts1, model = (torch.rand(B, N, 3, device=cuda, generator=gen) - 0.5 for _ in range(2))
    rs = torch.linalg.qr(torch.randn(B, P2, 3, 3, device=cuda, generator=gen))[0]
    ts = (torch.rand(B, P2, 3, device=cuda, generator=gen) - 0.5) * 0.4
    w1 = (torch.rand(B, N, device=cuda, generator=gen) < 0.7).float()
    before = dict(LAUNCHES)
    for kernel, plain in ((hyp_select.hypothesis_select_scores_cuda, hyp_select.hypothesis_select_scores_plain),
                          (hyp_select.hypothesis_select_scores_v2_cuda, hyp_select.hypothesis_select_scores_v2_plain)):
        got, want = kernel(pts1, model, rs, ts, w1), plain(pts1, model, rs, ts, w1)
        assert torch.equal(got, want)
    assert {k: LAUNCHES[k] - before.get(k, 0) for k in ("hyp_select", "hyp_select_v2")} == dict(hyp_select=1,
                                                                                            hyp_select_v2=1)
    big = torch.rand(1, 20000, 3, device=cuda)
    with pytest.raises(RuntimeError, match="hyp_select"):
        hyp_select.hypothesis_select_scores_cuda(pts1[:1], big, rs[:1], ts[:1], w1[:1])
    assert torch.ones(4, device=cuda).sum().item() == 4.0


@pytest.mark.cuda
def test_pe_train_frozen_kernels_match_plain(cuda):
    """The frozen-BN stack on the card: K12 on the buffer filled from the
    running statistics against its plain pass (pooled within 1e-2 of the
    max, tie counts equal), K18 against ``frozen_bwd_plain`` fed its own
    side's forward (dW and every layer's sums of g and g zhat within 1e-2
    of each tensor's max: bf16 rounding flips where float32 sums
    reassociate), K18 run twice bitwise equal (block sums added in order),
    at B 2, P 256, S 64 and 256; and a forward and backward through
    ``pe_mlp_bn_pool_frozen`` launches K12 and K18 once each, nothing of
    K11, K13, K14."""
    Ws, gammas, betas = _pe_train_params(cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    means = [0.2 * torch.randn(d, device=cuda, generator=gen) for d in (32, 64, 128)]
    vars_ = [0.5 + torch.rand(d, device=cuda, generator=gen) for d in (32, 64, 128)]
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    for S in (64, 256):
        chans = torch.randn(2, 6, 256, S, device=cuda, generator=gen) * 0.3
        chans[..., S // 3:] = chans[..., :1]
        chans = chans.contiguous()
        bn = pe_train.frozen_buffer(gammas, betas, means, vars_, 1e-5, cuda)
        pooled, cnt = pe_train.fwd_plain(chans, Ws, bn)
        k_pooled, k_cnt = pe_train.fwd_cuda(chans, Ws, bn)
        assert rel(k_pooled, pooled) < 1e-2 and torch.equal(k_cnt, cnt)
        dpool = torch.randn(2, 256, 128, device=cuda, generator=gen)
        want_bn, got_bn, again_bn = bn.clone(), bn.clone(), bn.clone()
        want = pe_train.frozen_bwd_plain(chans, Ws, want_bn, pooled, cnt, dpool)
        got = pe_train.frozen_bwd_cuda(chans, Ws, got_bn, k_pooled, k_cnt, dpool)
        again = pe_train.frozen_bwd_cuda(chans, Ws, again_bn, k_pooled, k_cnt, dpool)
        assert all(rel(a, b) < 1e-2 for a, b in zip(got, want))
        for l, d in enumerate(pe_train.DIMS[1:]):
            for row in (pe_train.SG, pe_train.SGZ):
                assert rel(got_bn[l, row, :d], want_bn[l, row, :d]) < 1e-2
        assert all(torch.equal(a, b) for a, b in zip(got, again)) and torch.equal(got_bn, again_bn)
    before = dict(LAUNCHES)
    params = [t.clone().requires_grad_() for t in (*Ws, *gammas, *betas)]
    pe_train.pe_mlp_bn_pool_frozen(chans, params[:3], params[3:6], params[6:], means, vars_).sum().backward()
    torch.cuda.synchronize()
    counts = {k: LAUNCHES[k] - before.get(k, 0) for k in ("pe_train_stats", "pe_train_fwd", "pe_train_bwd_sums",
                                                          "pe_train_bwd_dw", "pe_train_frozen_bwd")}
    assert counts == dict(pe_train_stats=0, pe_train_fwd=1, pe_train_bwd_sums=0, pe_train_bwd_dw=0,
                          pe_train_frozen_bwd=1)
    assert all(torch.isfinite(p.grad).all() for p in params)


@pytest.mark.cuda
def test_subset_grouping_at_8192_points_matches_plain(cuda):
    """``subset_config()``'s fine PE grouping at N 8192 (the JAX package's
    ``fine_npoint`` of 8192 takes it too): both scales through K15, which
    stages the permuted cloud in two chunks, bitwise equal to the plain twin
    on every output, miss slots included, and nothing raised."""
    from unopose_tpu_torch.configs import subset_config
    from unopose_tpu_torch.models.matching import FinePositionalEncoding

    fm = subset_config().fine_point_matching
    pe = FinePositionalEncoding(256, fm.pe_radius1, fm.pe_radius2, fm.nsample1, fm.nsample2, fused=True,
                                neighbor_mode="subset").to(cuda)
    pts = _lrf_cloud(np.random.default_rng(6), 2, 8192, cuda)
    before = LAUNCHES["ball_group_subset"]
    g1, v1, g2, v2 = pe._subset_groups(pts)
    assert LAUNCHES["ball_group_subset"] - before == 2
    for (g, v), (r, S) in zip(((g1, v1), (g2, v2)), ((fm.pe_radius1, fm.nsample1), (fm.pe_radius2, fm.nsample2))):
        want = ball_query.ball_group_subset_plain(r, S, pts)
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(g, want[0]))
        assert torch.equal(v, want[2]) and 0 < v.float().mean().item() < 1


@pytest.mark.cuda
def test_first_k_select_at_any_n_divisible_by_4(cuda):
    """K3 at cloud sizes whose chunks of N / 4 points end inside a 32-point
    word (N 1984, 2000; N 2048 beside them): every output equal to the plain
    select, and the fine PE's unpacked grouping at N 2000 runs on the card."""
    for N in (1984, 2000, 2048):
        pts = _lrf_cloud(np.random.default_rng(7), 4, N, cuda)
        perm, inv = ball_query.permutation(N, cuda)
        args = (pts, pts.index_select(1, perm.long()), perm, inv, 0.1, 64, 0.2, 256)
        got, want = ball_query.first_k_select_cuda(*args), ball_query.first_k_select_plain(*args)
        for k in ball_query.SELECT_KEYS:
            assert torch.equal(got[k], want[k]), (N, k)
    g1, g2 = ball_query.two_scale_group_first_k_fast(0.1, 64, 0.2, 256, pts[:, :2000].contiguous())
    assert g1[0].shape == (4, 2000, 64) and g2[0].shape == (4, 2000, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("cloud", ["cubes", "surfaces", "dense_s2_512", "dense_s2_768"])
def test_packed_pe_kernels_match_plain(cuda, cloud):
    """K19-K22 against their plain twins at B 4, N 2048: at S2 256 on the
    uniform cubes at most twice as many unequal outputs as the twin shows
    against itself one ulp up (K20, fed the twin's channels and with a
    float32 last layer: within 1e-2 of the output's max, K6's gate); on
    sphere surfaces at least 99.9% of outputs within one bf16 ulp and none
    more than two ulps of the largest output off; K21 bitwise equal to K5
    followed by K6. At S2 512 on the cubes shrunk by 0.55, the cubes' gates:
    there a point of a 64-point block has over 256 hits, so K19 takes its
    full path, and K21 and K22 their 512-slot tier. At S2 768 (past one
    512-slot window) on the cubes shrunk by 0.48 with r1 0.08 (at r1 0.1
    that density overflows the grouping's 64 scale-1 slots), the same: K19's
    full blocks, K21's and K22's 768-slot tier, K20's 192-slot chunks."""
    k2 = {"dense_s2_512": 512, "dense_s2_768": 768}.get(cloud, 256)
    r1 = 0.08 if k2 == 768 else 0.1
    if cloud == "surfaces":
        perm, _ = ball_query.permutation(2048, "cpu")
        pts = torch.from_numpy(surface_clouds(np.random.default_rng(8), 4, perm.numpy())).to(cuda)
    else:
        pts = _lrf_cloud(np.random.default_rng(8), 4, 2048, cuda) * {512: 0.55, 768: 0.48}.get(k2, 1.0)
    up = lambda xs: tuple(torch.nextafter(x, torch.full_like(x, float("inf"))) for x in xs)
    g2, w1, w2, t2, overflow = ball_query.two_scale_group_first_k_packed(r1, 64, 0.2, k2, pts)
    planes, idx, _, _, _, _ = ball_query.two_scale_group_first_k_packed_idx(r1, 64, 0.2, k2, pts)
    assert not bool(overflow)
    if k2 > 256:
        assert (pe_fused.block_max(t2, 64) > k2 // 2).any() and (pe_fused.slot_tiers(t2, k2) == k2).any()
    c = tuple(pts.unbind(-1))
    gen = torch.Generator(device=cuda).manual_seed(9)
    mlp = [([torch.randn(6, 32, device=cuda, generator=gen) * 0.3, torch.randn(32, 64, device=cuda, generator=gen) * 0.3,
             torch.randn(64, 128, device=cuda, generator=gen) * 0.3],
            [torch.randn(d, device=cuda, generator=gen) * 0.1 for d in (32, 64, 128)]) for _ in range(2)]
    packed = pe_fused.pack_mlp(*mlp)
    sm = lambda x: x.transpose(1, 2).contiguous()
    ch, _ = pe_fused.pe_channels_packed(g2, w1, w2, c, r1, 0.2)
    cases = {
        "K19": (lambda g, cc: pe_fused.pe_fused_packed_plain(g, w1, w2, t2, cc, *mlp, r1, 0.2),
                pe_fused.pe_fused_packed_cuda(g2, w1, w2, t2, c, r1, 0.2, packed), (g2, c)),
        "K21": (lambda p, cc: pe_fused.pe_fused_gather_t_plain(p, idx, w1, w2, t2, cc, *mlp, r1, 0.2),
                pe_fused.pe_fused_gather_t_cuda(planes, idx, w1, w2, t2, c, r1, 0.2, packed), (planes, c)),
        "K22": (lambda g, cc: pe_fused.pe_fused_packed_t_plain(tuple(map(sm, g)), sm(w1), sm(w2), t2, cc, *mlp, r1,
                                                               0.2),
                pe_fused.pe_fused_packed_t_cuda(tuple(map(sm, g2)), sm(w1), sm(w2), t2, c, r1, 0.2, packed), (g2, c)),
        "K20": (lambda chunks, _: pe_fused.pe_mlp_pool_packed_plain(chunks, t2, *mlp),
                pe_fused.pe_mlp_pool_packed_cuda(ch, t2, packed), (ch, None)),
    }
    for name, (plain, got, (a, b)) in cases.items():
        want = plain(a, b)
        assert torch.isfinite(got).all(), name
        if cloud == "surfaces":
            diff = (got - want).abs()
            _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
            assert (diff <= torch.ldexp(torch.ones_like(diff), e - 8)).float().mean().item() >= 0.999, name
            _, e = torch.frexp(want.abs().max())
            assert diff.max().item() <= 2.0 * torch.ldexp(torch.ones_like(diff.max()), e - 8).item(), name
        elif name == "K20":
            assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
        else:
            assert (got != want).sum() <= 2 * (plain(up(a), up(b)) != want).sum(), name
    if k2 == 256:
        v5 = pe_fused.pe_mlp_pool_cuda(pe_fused.pe_channels_cuda(planes, idx, w1, w2, t2, c, r1, 0.2), w1, w2, t2,
                                       packed)
        assert torch.equal(cases["K21"][1].view(torch.int32), v5.view(torch.int32))
    assert torch.ones(4, device=cuda).sum().item() == 4.0
