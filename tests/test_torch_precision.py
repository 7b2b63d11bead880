"""The precision gate of the PyTorch port (CPU): its production forward held
against its reference-faithful forward, the counterpart of the JAX
package's ``tests/test_production_gate.py``.

Both configurations load the same weights, a fake reference checkpoint
(``tools/fake_reference.py``) read through ``utils/ref_convert.py`` with
``parity_gather=True``, as ``chip_smoke.py``'s ``precision`` path loads
them at full width. The scenes are ``tools/scenes.py:scene_batch``, the
port's copy of the JAX study's, at the JAX gate's sizes: 56 px crops, 512
query and 768 template points, 64 coarse nodes, the production PE budgets
64/256, B 4 (one batch, where the JAX gate runs two). The taps and limits are the JAX gate's: the final
coarse attention (relative max < 0.03), the coarse scores (max < 0.05), the
fine scores (median < 0.05, 95th percentile < 0.2) and the pose score (max <
0.05); the coarse search draws the same uniforms in every configuration.
"""

import functools

import numpy as np
import pytest
import torch

from benchmarks.study_production_path import scene_batch as jax_scene_batch
from unopose_tpu_torch.configs import (
    faithful_config,
    production_bf16_geo_config,
    production_config,
)
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.tools.fake_reference import write_fake_reference
from unopose_tpu_torch.tools.scenes import scene_batch
from unopose_tpu_torch.utils.ref_convert import load_reference_into

B, REPS = 4, 1
GATE_SIZES = dict(img=56, nq=512, nt=768)
CONFIGS = {"faithful": (faithful_config, torch.float32), "production": (production_config, torch.bfloat16),
           "production_bf16_geo": (production_bf16_geo_config, torch.bfloat16)}


def gate_config(name: str):
    """The tiny config at the JAX gate's sizes, with the reference's gather."""
    fn, _ = CONFIGS[name]
    cfg = fn(tiny=True)
    cfg.update(coarse_npoint=64, fine_npoint=GATE_SIZES["nq"])
    cfg.feature_extraction.img_size = GATE_SIZES["img"]
    cfg.fine_point_matching.parity_gather = True
    return cfg


@functools.lru_cache(maxsize=None)
def gate_taps(name: str, path: str):
    """(coarse attention, coarse scores, fine scores, pose score) of each
    batch, float32 numpy, for the config ``name`` on the checkpoint at ``path``."""
    dtype = CONFIGS[name][1]
    model = load_reference_into(UNOPose.from_config(gate_config(name), dtype, dtype), path).eval()
    rng = np.random.default_rng(11)
    out = []
    for rep in range(REPS):
        inputs, _, _ = scene_batch(rng, B, **GATE_SIZES)
        gen = torch.Generator().manual_seed(50 + rep)
        uniforms = torch.rand((B, 3 * model.nproposal1), generator=gen)
        o = model({k: torch.from_numpy(v) for k, v in inputs.items()}, uniforms=uniforms, return_intermediates=True)
        out.append(tuple(o[k].float().numpy() for k in ("coarse_atten", "coarse_score", "fine_score",
                                                        "pred_pose_score")))
    return out


@functools.lru_cache(maxsize=None)
def checkpoint() -> str:
    """A fake reference checkpoint of the faithful model's seeded init, in a
    directory that lives as long as the test process."""
    import atexit
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="unopose_precision_")
    atexit.register(shutil.rmtree, root, True)
    torch.manual_seed(0)
    path = f"{root}/reference.pth"
    write_fake_reference(path, UNOPose.from_config(gate_config("faithful")))
    return path


@pytest.mark.parametrize("name", ["production", "production_bf16_geo"])
def test_production_forward_matches_faithful(name):
    path = checkpoint()
    for (fa, fcs, ffs, fps_), (pa, pcs, pfs, pps_) in zip(gate_taps("faithful", path), gate_taps(name, path)):
        atten_rel = np.abs(pa - fa).max() / (np.abs(fa).max() + 1e-9)
        assert atten_rel < 0.03, atten_rel
        assert np.abs(pcs - fcs).max() < 0.05, np.abs(pcs - fcs).max()
        dfs = np.abs(pfs - ffs)
        assert np.median(dfs) < 0.05, np.median(dfs)
        assert np.percentile(dfs, 95) < 0.2, np.percentile(dfs, 95)
        assert np.abs(pps_ - fps_).max() < 0.05, np.abs(pps_ - fps_).max()


def test_scene_batch_equals_the_jax_studys():
    """Draw for draw, array for array, on the same generator."""
    got, gr, gt = scene_batch(np.random.default_rng(3), 2, **GATE_SIZES)
    want, wr, wt = jax_scene_batch(np.random.default_rng(3), 2, **GATE_SIZES)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert np.array_equal(gr, wr) and np.array_equal(gt, wt)


def test_faithful_config_pins_the_studys_switches():
    """``faithful_config`` is production with the JAX study's faithful
    switches (``build_model("faithful")``) and the plain PE MLP;
    ``production_bf16_geo_config`` is production with float fused
    embeddings. Both at full width, and the models take the paths."""
    prod, faith, geo = production_config(), faithful_config(), production_bf16_geo_config()
    assert faith.geo_embedding.fused_table == 0 and faith.geo_embedding.quant_int8 is False
    assert faith.fine_point_matching.pe_packed is False and faith.fine_point_matching.pe_fused is False
    assert faith.feature_extraction.fused_attn is False and faith.fused_assignment is False
    switches = ("geo_embedding.fused_table", "geo_embedding.quant_int8", "fine_point_matching.pe_packed",
                "fine_point_matching.pe_fused", "feature_extraction.fused_attn", "fused_assignment")

    def rest(cfg, keys):
        return {k: v for k, v in cfg.flatten().items() if k not in keys}

    assert rest(faith, switches) == rest(prod, switches)
    assert geo.geo_embedding.quant_int8 is False and geo.geo_embedding.fused_table == 128
    assert rest(geo, ("geo_embedding.quant_int8",)) == rest(prod, ("geo_embedding.quant_int8",))
    m = UNOPose.from_config(faithful_config(tiny=True))
    assert m.geo_embed.fused_table == 0 and not m.fused_assignment and not m.fine_matching.pe.fused
    assert m.fine_matching.pe.packed is False and not m.encoder.rgb_net.vit.blocks0[0].fused_attn
