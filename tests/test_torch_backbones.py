"""The ViT backbones without register tokens in the PyTorch port against
the JAX package (CPU): ``vit_base`` and ``vit_large`` (patch 16, no
LayerScale) and ``vit_{small,base,large}_patch14_dinov2``, whose position
embeddings cover the class token (``pos_embed_prefix``). Each variant,
narrowed by ``make_vit``'s overrides, against JAX's on converted perturbed
parameters in both modes (the exact path, and the production one: fused
attention, W8A8 GEMMs, tanh-GELU); the timm graft (the prefix rows split
off, the patch rows resampled) against JAX's on a seeded fake checkpoint;
and the feature extractor's prefix count. Each test states its tolerance
and why.
"""

import functools
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch import nn

from test_torch_models import max_abs, perturb, t
from unopose_tpu.utils.config import CN
from unopose_tpu_torch.configs import Config
from unopose_tpu_torch.models.feature_extraction import ViTAE
from unopose_tpu_torch.models.vit import VIT_VARIANTS, make_vit
from unopose_tpu_torch.utils import checkpoint
from unopose_tpu_torch.utils.convert import flax_to_torch, load_flax_variables

jvit = importlib.import_module("unopose_tpu.models.vit")
jva = importlib.import_module("unopose_tpu.ops.vit_attn")
jckpt = importlib.import_module("unopose_tpu.utils.checkpoint")

NON_REG4 = ["vit_base", "vit_large", "vit_small_patch14_dinov2", "vit_base_patch14_dinov2",
            "vit_large_patch14_dinov2"]
NARROW = dict(embed_dim=32, depth=4, num_heads=2)  # the tests' width; the variant keeps the rest


def img_size(vit_type: str, grid: int = 3) -> int:
    return grid * VIT_VARIANTS[vit_type]["patch_size"]


@functools.lru_cache(maxsize=None)
def narrow_variables(vit_type: str):
    """Perturbed variables of the narrowed variant (one tree for both modes) and its input images."""
    size = img_size(vit_type)
    x = np.random.default_rng(3).uniform(-1, 1, size=(2, size, size, 3)).astype(np.float32)
    jv = jvit.make_vit(vit_type, img_size=size, dtype=jnp.float32, **NARROW)
    return perturb(jax.jit(jv.init)(jax.random.PRNGKey(0), jnp.asarray(x))), x


@pytest.mark.parametrize("mode", ["exact", "production"])
@pytest.mark.parametrize("vit_type", NON_REG4)
def test_non_reg4_vit_matches_jax(vit_type, mode, monkeypatch):
    """Each variant at 32 wide, 4 deep, 2 heads on a 3 x 3 grid (10 tokens:
    one class token, no registers), against JAX's ``make_vit`` with the same
    overrides on converted perturbed parameters: the same variables (the
    prefix position embeddings included, LayerScale only where the variant
    has ``init_values``); the four pyramid taps and the class token within
    1e-5 of each output's max on the exact path (float32 reassociation),
    within 1e-3 in production mode (fused attention, JAX's in interpret
    mode; W8A8 codes that flip one step, as
    ``test_torch_production.test_production_vit_matches_jax`` gates them)."""
    assert VIT_VARIANTS[vit_type] == jvit.VIT_VARIANTS[vit_type]
    fused = mode == "production"
    if fused:
        monkeypatch.setattr(jva, "mha_fused", functools.partial(jva.mha_fused, interpret=True))
    size = img_size(vit_type)
    variables, x = narrow_variables(vit_type)
    jv = jvit.make_vit(vit_type, img_size=size, dtype=jnp.float32, fused_attn=fused, int8_gemm=fused, **NARROW)
    want, want_cls = jax.jit(jv.apply)(variables, jnp.asarray(x))
    tv = make_vit(vit_type, img_size=size, dtype=torch.float32, fused_attn=fused, int8_gemm=fused, **NARROW)
    assert set(flax_to_torch(variables)) == set(tv.state_dict())
    assert tuple(tv.pos_embed_prefix.shape) == (1, 1, 32) and tv.reg_token is None
    assert (tv.blocks0[0].ls1 is None) == (VIT_VARIANTS[vit_type]["init_values"] is None)
    load_flax_variables(tv, variables)
    with torch.no_grad():
        got, got_cls = tv(t(x))
    tol = 1e-3 if fused else 1e-5
    for w, g in [*zip(want, got), (want_cls, got_cls)]:
        assert tuple(g.shape) == w.shape and (g.shape[1] == 10 or g.dim() == 2)
        assert max_abs(w, g) <= tol * np.abs(np.asarray(w)).max()


def fake_timm(vit_type: str, grid: int, seed: int) -> dict:
    """A seeded timm state dict of ``vit_type`` at 32 wide and the variant's
    depth, on a ``grid`` x ``grid`` patch grid: the prefix row first in
    ``pos_embed``, no register token, LayerScale gammas where the variant
    has ``init_values``."""
    v, dim, rng = VIT_VARIANTS[vit_type], 32, np.random.default_rng(seed)
    P = v["patch_size"]
    normal = lambda *shape: rng.normal(size=shape).astype(np.float32)
    sd = {"patch_embed.proj.weight": normal(dim, 3, P, P), "patch_embed.proj.bias": normal(dim),
          "cls_token": normal(1, 1, dim), "pos_embed": normal(1, 1 + grid * grid, dim),
          "norm.weight": 1 + 0.1 * normal(dim), "norm.bias": 0.1 * normal(dim)}
    for i in range(v["depth"]):
        p = f"blocks.{i}."
        for name, shape in (("norm1", (dim,)), ("norm2", (dim,))):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = 1 + 0.1 * normal(*shape), 0.1 * normal(*shape)
        for name, (o, k) in (("attn.qkv", (3 * dim, dim)), ("attn.proj", (dim, dim)), ("mlp.fc1", (4 * dim, dim)),
                             ("mlp.fc2", (dim, 4 * dim))):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = 0.02 * normal(o, k), 0.02 * normal(o)
        if v["init_values"] is not None:
            sd[p + "ls1.gamma"], sd[p + "ls2.gamma"] = 0.1 * normal(dim), 0.1 * normal(dim)
    return sd


class ViTHolder(nn.Module):
    """A narrowed ViT at the model's place (``checkpoint.VIT_PREFIX``), for the graft."""

    def __init__(self, vit_type: str, size: int):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.rgb_net = nn.Module()
        self.encoder.rgb_net.vit = make_vit(vit_type, img_size=size, embed_dim=32, num_heads=2)


@pytest.mark.parametrize("vit_type", NON_REG4)
def test_non_reg4_timm_graft_matches_jax(vit_type, tmp_path):
    """A fake timm checkpoint of the variant on a 4 x 4 grid, grafted into a
    32-wide ViT of the variant's depth on a 3 x 3 grid by
    ``maybe_load_pretrained_vit``: every ViT tensor bitwise equal to JAX's
    ``maybe_load_pretrained_vit`` followed by ``utils/convert.py`` (the
    class token's position row split off into ``pos_embed_prefix`` as it
    is, the 16 patch rows resampled to 9); and ``convert_timm_vit_to_flax``
    on the same dict equal to JAX's, leaf for leaf."""
    sd = fake_timm(vit_type, 4, seed=len(vit_type))
    v = VIT_VARIANTS[vit_type]
    kw = dict(depth=v["depth"], reg_tokens=0, no_embed_class=False)
    conv, jconv = checkpoint.convert_timm_vit_to_flax(sd, **kw), jckpt.convert_timm_vit_to_flax(sd, **kw)
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(x) for p, x in jax.tree_util.tree_leaves_with_path(tree)}
    assert flat(conv).keys() == flat(jconv).keys()
    assert all(np.array_equal(a, flat(jconv)[k]) for k, a in flat(conv).items())
    np.testing.assert_array_equal(conv["pos_embed_prefix"], sd["pos_embed"][:, :1])

    path = str(tmp_path / "vit.pth")
    torch.save({"model": {k: torch.from_numpy(x) for k, x in sd.items()}}, path)
    size = img_size(vit_type)
    fe = dict(vit_type=vit_type, img_size=size, pretrained=True, vit_ckpt=path, freeze_vit=True)
    jv = jvit.make_vit(vit_type, img_size=size, embed_dim=32, num_heads=2)
    shapes = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32)))
    params, loaded = jckpt.maybe_load_pretrained_vit({"encoder": {"rgb_net": {"vit": shapes["params"]}}}, CN(fe))
    want = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray, params["encoder"]["rgb_net"]["vit"])})
    holder = ViTHolder(vit_type, size)
    assert loaded and checkpoint.maybe_load_pretrained_vit(holder, Config(fe))
    state = holder.state_dict()
    assert len(want) == len(state)
    for k, x in want.items():
        assert torch.equal(state[checkpoint.VIT_PREFIX + k], x), k
    np.testing.assert_array_equal(state[checkpoint.VIT_PREFIX + "pos_embed"].numpy(),
                                  checkpoint.interpolate_pos_embed_np(sd["pos_embed"][:, 1:], 3))


@pytest.mark.parametrize("vit_type, tokens", [("vit_small_patch14_dinov2", 257), ("vit_base", 197),
                                              ("vit_small_patch14_reg4_dinov2", 261)])
def test_feature_extractor_takes_the_variant_prefix(vit_type, tokens):
    """The feature extractor drops the variant's prefix tokens (one class
    token, plus four registers in the reg4 variants): at 224 px a variant
    makes 257 tokens at patch 14 without registers, 197 at patch 16, 261
    with them, and the upscaled map is 4 g x 4 g for the variant's grid g
    (the ViT narrowed to 8 wide and 1 deep: only the token count matters)."""
    ae = ViTAE(vit_type, out_dim=8, img_size=224)
    ae.vit = make_vit(vit_type, img_size=224, embed_dim=8, depth=1, num_heads=1)
    ae.output_upscaling = nn.Linear(32, 16 * 8)
    seen = []
    ae.vit.norm.register_forward_hook(lambda m, i, o: seen.append(o.shape[1]))
    g = 224 // VIT_VARIANTS[vit_type]["patch_size"]
    with torch.no_grad():
        out = ae(torch.zeros(1, 224, 224, 3))
    assert seen and set(seen) == {tokens} and ae.vit.num_prefix_tokens == tokens - g * g
    assert tuple(out.shape) == (1, 4 * g, 4 * g, 8)
