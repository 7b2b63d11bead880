"""The config keys the port took last, against the JAX package (CPU).

One parametrised test, a case for each key: the fused geometric embedding
written as float32 or bf16 values (``quant_int8=False``), the reference's
shifted gather (``parity_gather``), the PE's activation storage
(``pe_dtype`` "bf16" and "fp32"), a PE without its LRF or its xyz channels,
and ``sim_type="L2"`` in each matcher. Each case builds the port's stage
from a config through ``UNOPose.from_config`` and compares it with the JAX
package's counterpart on the same converted weights and numpy inputs; the
JAX fused embedding runs with ``fused_interpret=True``. The tolerances are
those of the existing tests of the same stage, restated in each branch.
A second parametrised test takes the train keys and the backbones: each ViT
variant without registers, the clip, the EMA, ``freeze_vit`` and the
subset mode in training, read as ``configs/main_cfg.py`` and the JAX
package read them.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_fused import geo_case
from test_torch_models import B, max_abs, perturb, slice_inputs, t
from unopose_tpu.models import UNOPose as JaxUNOPose
from unopose_tpu.models.embedding import GeometricStructureEmbedding as JaxGeo
from unopose_tpu.models.matching import FinePositionalEncoding as JaxPE
from unopose_tpu.models.unopose import _resolve_pe_dtype
from unopose_tpu_torch.configs import production_config, slice_config
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.utils.convert import flax_to_torch, load_flax_variables

CASES = ["geo_float32", "geo_bfloat16", "parity_gather", "pe_dtype_bf16", "pe_dtype_fp32", "no_lrf", "no_xyz",
         "coarse_l2", "fine_l2"]


def set_key(cfg, key: str, value):
    *parents, leaf = key.split(".")
    node = cfg
    for p in parents:
        node = node[p]
    node[leaf] = value
    return cfg


def geo_stage(dtype: str):
    """The fused embedding with ``quant_int8=False`` in a ``dtype`` model:
    the float32 values within 1e-5 (float32 rounding of the same stencils),
    the bf16 values within one bf16 ulp of the output plus one bf16 step of
    the stencil weights (2^-8 of the channel bound), as the plain version's
    test gates them."""
    cfg = set_key(production_config(tiny=True), "geo_embedding.quant_int8", False)
    td, jd = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    model = UNOPose.from_config(cfg, td, td)
    tge = model.geo_embed
    assert tge.fused_table == 128 and not tge.quant_int8 and tge.dtype == td
    ge = cfg.geo_embedding
    kw = dict(hidden_dim=ge.hidden_dim, sigma_d=ge.sigma_d, sigma_a=ge.sigma_a, angle_k=ge.angle_k,
              reduction_a=ge.reduction_a, d_index_max=tge.d_index_max)
    jge = JaxGeo(fused_table=128, quant_int8=False, fused_interpret=True, dtype=jd, **kw)
    pts = geo_case()[0]
    variables = perturb(jge.init(jax.random.PRNGKey(0), jnp.asarray(pts)))
    load_flax_variables(tge, variables)
    want = np.asarray(jge.apply(variables, jnp.asarray(pts)).astype(jnp.float32))
    with torch.no_grad():
        got = tge(t(pts))
    assert got.dtype == td and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if dtype == "float32":
        assert max_abs(want, got) < 1e-5
        return
    k = variables["params"]
    tabs = [jnp.asarray(x) for x in (k["proj_d"]["kernel"], k["proj_d"]["bias"], k["proj_a"]["kernel"],
                                     k["proj_a"]["bias"])]
    from unopose_tpu.ops.geo_fused import build_taylor_table

    tab_d, _ = build_taylor_table(tabs[0], tabs[1], float(tge.d_index_max), 128)
    tab_a, _ = build_taylor_table(tabs[2], tabs[3], float(np.pi * 180.0 / (ge.sigma_a * np.pi)), 128)
    bound = 1.25 * (np.abs(np.asarray(tab_d)).max(0) + np.abs(np.asarray(tab_a)).max(0))
    assert (np.abs(want - got) <= 2.0**-7 * np.abs(want) + 2.0**-8 * bound).all()


def matcher_models(key: str, value, stage: str, args):
    """(jax model, its perturbed variables of ``stage`` alone, torch model)
    of the tiny slice config with ``key`` set: JAX initialises the matcher
    ``stage`` on ``args`` and the port loads its tensors. The fine PE's
    MLPs are not declared (the callers hand both packages the PE's pooled
    features) and stay at the port's init."""
    cfg = set_key(slice_config(tiny=True), key, value)
    jm = JaxUNOPose.from_config(cfg, dtype=jnp.float32, backbone_dtype=jnp.float32)
    keys = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    init = jax.jit(lambda k, *a: jm.init(k, *a, method=lambda m, *b: getattr(m, stage)(*b)))
    variables = perturb(init(keys, *map(jnp.asarray, args)))
    tm = UNOPose.from_config(cfg, dtype=torch.float32, backbone_dtype=torch.float32)
    missing, unexpected = tm.load_state_dict(flax_to_torch(variables), strict=False)
    assert not unexpected and all(not k.startswith(stage) or ".pe.mlp1" in k or ".pe.mlp2" in k for k in missing)
    return jm, variables, tm.eval()


def fine_stage_given_pe(key: str, value, monkeypatch):
    """The fine blocks, similarity and score head with both packages handed
    the same pooled PE features, as ``test_torch_models.
    test_fine_point_matching_given_pe`` runs them: similarity within 1e-3 of
    its max, scores within 1e-4. Returns the port's model, similarity and
    arguments."""
    import unopose_tpu.models.matching as jax_matching

    rng = np.random.default_rng(6)
    n = 256  # the JAX PE's packed path (patched here) needs N >= nsample2
    p1, p2 = (rng.normal(size=(B, n, 3)).astype(np.float32) * 0.3 for _ in range(2))
    f1, f2 = (rng.normal(size=(B, n, 32)).astype(np.float32) for _ in range(2))
    g1, g2 = (rng.normal(size=(B, 17, 17, 32)).astype(np.float32) for _ in range(2))
    i1, i2 = (np.stack([rng.permutation(n)[:16] for _ in range(B)]).astype(np.int32) for _ in range(2))
    R = np.stack([np.eye(3, dtype=np.float32)] * B)
    tr = np.zeros((B, 3), np.float32)
    pooled = rng.normal(size=(2 * B, n, 256)).astype(np.float32)
    monkeypatch.setattr(jax_matching, "pe_packed_firstk_path", lambda *a, **k: jnp.asarray(pooled))
    args = (p1, f1, g1, i1, p2, f2, g2, i2, R, tr)
    jm, variables, tm = matcher_models(key, value, "fine_matching", args)
    pe = tm.fine_matching.pe
    monkeypatch.setattr(pe, "forward", lambda pts: pe.mlp3(t(pooled)))
    a_j, s_j, _, _ = jax.jit(lambda v, *a: jm.apply(v, *a, method=lambda m, *b: m.fine_matching(*b)))(
        variables, *map(jnp.asarray, args))
    with torch.no_grad():
        a_t, s_t = tm.fine_matching(*map(t, args))
    assert max_abs(a_j[-1], a_t) < 1e-3 * np.abs(np.asarray(a_j[-1])).max()
    assert max_abs(s_j[-1], s_t) < 1e-4
    return tm, a_t, args


def pe_stage(key: str, value, mode: str = "first_k", packed=None):
    """The fine PE built from ``production_config(tiny)`` with ``key`` set
    (its fused switch on) against JAX's module with the same keys, on the
    tiny slice's query cloud, as ``test_torch_subset_pe.
    test_fine_positional_encoding_matches_jax`` gates it: the median row
    error within 1e-4, and no more rows off by over 1e-3 (float32 storage)
    or 0.05 (bf16 storage: an activation that rounds the other way moves a
    row by ~1e-3) than max(3, twice JAX's own count under a one-ulp input
    change). The port routes past every fused and packed path, as JAX does.
    One cloud, and budgets of 32 / 128, keep JAX's bf16 MLP on the CPU short."""
    cfg = production_config(tiny=True)
    fm = cfg.fine_point_matching
    fm.update(pe_neighbor_mode=mode, pe_packed=packed, nsample1=32, nsample2=128)
    set_key(cfg, key, value)
    tpe = UNOPose.from_config(cfg).fine_matching.pe
    kw = dict(out_dim=32, r1=fm.pe_radius1, r2=fm.pe_radius2, nsample1=fm.nsample1, nsample2=fm.nsample2,
              use_lrf=fm.get("use_lrf", True), use_xyz=fm.get("use_xyz", True), neighbor_mode=mode, packed=packed,
              compute_dtype=_resolve_pe_dtype(fm.get("pe_dtype")), fused=True)
    jpe = JaxPE(**kw)
    pts = slice_inputs()["pts"][:1]
    pts = ((pts - pts.mean(1, keepdims=True)) / 0.1).astype(np.float32)
    variables = perturb(jpe.init(jax.random.PRNGKey(0), jnp.asarray(pts), train=False))
    load_flax_variables(tpe, variables)
    apply = jax.jit(jpe.apply)
    want = np.asarray(apply(variables, jnp.asarray(pts)))
    ulp = np.abs(np.asarray(apply(variables, jnp.asarray(np.nextafter(pts, np.float32(np.inf))))) - want).max(-1)
    with torch.no_grad():
        got = tpe(t(pts)).numpy()
    assert tpe.last_branch == ("subset" if mode == "subset" else "unpacked")
    err = np.abs(got - want).max(-1)
    far = 1e-3 if tpe.compute_dtype == torch.float32 else 0.05
    assert np.median(err) < 1e-4, np.median(err)
    assert (err > far).sum() <= max(3, 2 * (ulp > far).sum()), ((err > far).sum(), (ulp > far).sum())
    return tpe


@pytest.mark.parametrize("case", CASES)
def test_config_key_matches_jax(case, monkeypatch):
    if case in ("geo_float32", "geo_bfloat16"):
        geo_stage(case.split("_")[1])
    elif case == "parity_gather":
        tm, shifted, args = fine_stage_given_pe("fine_point_matching.parity_gather", True, monkeypatch)
        assert all(b.transformer.parity_gather for b in tm.fine_matching.blocks)
        for b in tm.fine_matching.blocks:
            b.transformer.parity_gather = False
        with torch.no_grad():
            plain, _ = tm.fine_matching(*map(t, args))
        assert max_abs(shifted, plain) > 1e-3  # the key changes the computation
    elif case == "pe_dtype_bf16":
        tpe = pe_stage("fine_point_matching.pe_dtype", "bf16", packed=False)
        assert tpe.compute_dtype == torch.bfloat16
    elif case == "pe_dtype_fp32":
        tpe = pe_stage("fine_point_matching.pe_dtype", "fp32", mode="subset")
        assert tpe.compute_dtype == torch.float32
        with pytest.raises(ValueError):
            UNOPose.from_config(set_key(slice_config(tiny=True), "fine_point_matching.pe_dtype", "fp16"))
    elif case in ("no_lrf", "no_xyz"):
        key = "fine_point_matching.use_lrf" if case == "no_lrf" else "fine_point_matching.use_xyz"
        tpe = pe_stage(key, False)
        assert tpe.mlp1_fc0_kernel.shape[0] == (6 if case == "no_lrf" else 3)
    elif case == "coarse_l2":
        rng = np.random.default_rng(4)
        f1, f2 = (rng.normal(size=(B, 16, 32)).astype(np.float32) for _ in range(2))
        g1, g2 = (rng.normal(size=(B, 17, 17, 32)).astype(np.float32) for _ in range(2))
        jm, variables, tm = matcher_models("coarse_point_matching.sim_type", "L2", "coarse_matching",
                                           (f1, g1, f2, g2))
        a_j, s_j, _ = jax.jit(lambda v, *a: jm.apply(v, *a, method=lambda m, *b: m.coarse_matching(*b)))(
            variables, *map(jnp.asarray, (f1, g1, f2, g2)))
        with torch.no_grad():
            a_t, s_t = tm.coarse_matching(*map(t, (f1, g1, f2, g2)))
        # the coarse similarity within 1e-3 of its max, the scores 1e-4 (test_torch_models)
        assert max_abs(a_j[-1], a_t) < 1e-3 * np.abs(np.asarray(a_j[-1])).max()
        assert max_abs(s_j[-1], s_t) < 1e-4
        assert float(a_t.min()) >= 0.0  # distances, not cosines
        cfg = set_key(production_config(tiny=True), "coarse_point_matching.sim_type", "L2")
        assert UNOPose.from_config(cfg).fused_assignment  # the fine stage's key alone gates the fused solver
    else:
        _, a_t, _ = fine_stage_given_pe("fine_point_matching.sim_type", "L2", monkeypatch)
        assert float(a_t.min()) >= 0.0
        # L2 logits never reach the fused assignment: the auto gate turns it off, as JAX's does
        cfg = set_key(production_config(tiny=True), "fine_point_matching.sim_type", "L2")
        assert not UNOPose.from_config(cfg).fused_assignment
        with pytest.raises(ValueError):
            UNOPose.from_config(set_key(slice_config(tiny=True), "fine_point_matching.sim_type", "dot"))


# ------------------------------------------------------------------ the train keys and the backbones
TRAIN_CASES = ["vit_base", "vit_large", "vit_small_patch14_dinov2", "vit_base_patch14_dinov2",
               "vit_large_patch14_dinov2", "clip_grad", "model_ema", "freeze_vit", "subset_train"]


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_key_matches_main_cfg(case):
    """The keys of ``configs/main_cfg.py`` this port took last, each read as
    the JAX package reads it: ``feature_extraction.vit_type`` for each
    variant without registers (the port's hyperparameters are JAX's
    ``VIT_VARIANTS`` entry, and a ViT built from it at a 224-px image has
    JAX's parameter tree, names and shapes, with the narrow width both
    packages' ``make_vit`` overrides take); ``train.clip_grad`` (get_cfg's
    section, off at max_norm 35; on, the port clips at that max_norm, as
    JAX's optimizer chain does); ``train.model_ema`` (absent from get_cfg:
    off; on, decay 0.999 by default in both); ``freeze_vit`` (get_cfg's
    True in the port's train config; off, every parameter trains, as JAX's
    train step differentiates every leaf); ``pe_neighbor_mode="subset"``
    in training (the fine PE's train forward takes the subset groupings)."""
    from unopose_tpu.configs.main_cfg import get_cfg
    from unopose_tpu.engine import train as jtrain
    from unopose_tpu.models import vit as jvit
    from unopose_tpu_torch import configs
    from unopose_tpu_torch.engine.train import Trainer, clip_max_norm, ema_decay
    from unopose_tpu_torch.models.vit import VIT_VARIANTS, make_vit

    ref = get_cfg()
    ours = configs.main_config()
    if case.startswith("vit_"):
        assert VIT_VARIANTS[case] == jvit.VIT_VARIANTS[case]
        narrow = dict(embed_dim=32, num_heads=2)
        jv = jvit.make_vit(case, img_size=224, **narrow)
        shapes = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32)))
        want = {k: tuple(v.shape) for k, v in flax_to_torch(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
        tv = make_vit(case, img_size=224, **narrow)
        assert want == {k: tuple(v.shape) for k, v in tv.state_dict().items()}
        assert tv.grid * tv.grid + tv.num_prefix_tokens == (257 if VIT_VARIANTS[case]["patch_size"] == 14 else 197)
        cfg = set_key(production_config(tiny=True), "feature_extraction.vit_type", case)
        assert UNOPose.from_config(set_key(cfg, "feature_extraction.embed_dim", VIT_VARIANTS[case]["embed_dim"])
                                   ).encoder.rgb_net.vit.num_prefix_tokens == 1
    elif case == "clip_grad":
        assert dict(ours.train.clip_grad) == dict(ref.train.clip_grad) and clip_max_norm(ours) is None
        ours.train.clip_grad.enabled = ref.train.clip_grad.enabled = True
        assert clip_max_norm(ours) == 35.0
        chain = jtrain.build_optimizer(ref, {"w": jnp.zeros(3)})
        g = {"w": jnp.asarray([300.0, 400.0, 0.0])}  # norm 500, clipped to 35
        u, _ = chain.update(g, chain.init({"w": jnp.zeros(3)}), {"w": jnp.zeros(3)})
        assert np.all(np.isfinite(np.asarray(u["w"])))
    elif case == "model_ema":
        assert "model_ema" not in ref.train and ema_decay(ours) is None
        ours.train.model_ema = configs.Config(enabled=True)
        assert ema_decay(ours) == 0.999
    elif case == "freeze_vit":
        assert ours.model.feature_extraction.freeze_vit is ref.model.feature_extraction.freeze_vit is True
        cfg = configs.main_config(tiny=True)
        cfg.model.feature_extraction.freeze_vit = False
        model = UNOPose.from_config(cfg.model)
        assert len(Trainer(model, cfg).params) == len(list(model.parameters()))
        assert not model.encoder.rgb_net.freeze_vit
    else:
        assert ref.model.fine_point_matching.get("pe_neighbor_mode", "first_k") == "first_k"
        cfg = configs.main_config(tiny=True)
        cfg.model.fine_point_matching.update(pe_neighbor_mode="subset", nsample1=8, nsample2=16)
        pe = UNOPose.from_config(cfg.model).fine_matching.pe
        assert pe.neighbor_mode == "subset" and pe.compute_dtype == torch.bfloat16
        pts = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, size=(2, 64, 3)).astype(np.float32))
        out = pe.forward_train(pts)
        assert tuple(out.shape) == (2, 64, pe.mlp3.out_features) and torch.isfinite(out).all()
