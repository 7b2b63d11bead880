"""A published UNOPose checkpoint (the reference PyTorch model's state dict)
turned into the port's state dict (counterpart of
``unopose_tpu/utils/ref_convert.py``).

The reference's modules (``feature_extraction``, ``geo_embedding``,
``coarse_point_matching``, ``fine_point_matching``) are mapped onto the JAX
package's flax layout by the JAX converter's own rules, then by
``utils/convert.py:flax_to_torch`` onto the port's modules, which carry the
flax names; the result equals the JAX converter followed by
``flax_to_torch`` bit for bit. The rules:

1. the geometric embedding's ``proj_d`` / ``proj_a`` read a sinusoid whose
   (sin, cos) pairs the reference interleaves and the model concatenates,
   so their input rows are permuted (sin rows first, then cos);
2. per-block tensors are stacked on a leading axis (the flax ``blocks``);
3. a Linear's (out, in) weight becomes a flax (in, out) kernel, the fine
   PE's 1 x 1 convolutions planar kernels, its BatchNorms' weight, bias and
   running statistics the flax scale, bias, mean and var;
4. the ViT (timm naming under ``feature_extraction.rgb_net.vit``) goes
   through ``utils/checkpoint.py:convert_timm_vit_to_flax``.

The reference's unused ``fine_point_matching.dis_proj`` and its sinusoids'
``div_term`` buffers (and the BatchNorms' ``num_batches_tracked``) are
dropped: no rule reads them. The reference gathers each fine block's sparse
features one dense slot off (its bg token first); weights trained that way
want ``fine_point_matching.parity_gather=True``, a computation switch
(``models/transformer.py``), not a layout rule.
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np
import torch

from unopose_tpu_torch.utils.checkpoint import convert_timm_vit_to_flax
from unopose_tpu_torch.utils.convert import flax_to_torch

logger = logging.getLogger(__name__)


def _np(sd: dict) -> dict:
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in sd.items()}


def _linear(sd: dict, prefix: str) -> dict:
    out = {"kernel": np.ascontiguousarray(sd[prefix + "weight"].T)}
    if prefix + "bias" in sd:
        out["bias"] = sd[prefix + "bias"]
    return out


def _layernorm(sd: dict, prefix: str) -> dict:
    return {"scale": sd[prefix + "weight"], "bias": sd[prefix + "bias"]}


def sincos_perm(d: int) -> np.ndarray:
    """The reference's interleaved (sin_0, cos_0, sin_1, ...) rows that make
    the model's (sin_0, .., sin_{d/2-1}, cos_0, ..) rows."""
    return np.concatenate([np.arange(0, d, 2), np.arange(1, d, 2)])


def _sincos_permuted_linear(sd: dict, prefix: str) -> dict:
    w = sd[prefix + "weight"]  # (out, d)
    return {"kernel": np.ascontiguousarray(w[:, sincos_perm(w.shape[1])].T), "bias": sd[prefix + "bias"]}


def _attention_output(sd: dict, prefix: str) -> dict:
    return {"expand": _linear(sd, prefix + "expand."), "squeeze": _linear(sd, prefix + "squeeze."),
            "norm": _layernorm(sd, prefix + "norm.")}


def _vanilla_layer(sd: dict, prefix: str) -> dict:
    a = prefix + "attention."
    return {
        "attention": {name: _linear(sd, f"{a}attention.{name}.") for name in ("proj_q", "proj_k", "proj_v")},
        "linear": _linear(sd, a + "linear."),
        "norm": _layernorm(sd, a + "norm."),
        "output": _attention_output(sd, prefix + "output."),
    }


def _rpe_layer(sd: dict, prefix: str) -> dict:
    out = _vanilla_layer(sd, prefix)
    out["attention"]["proj_p"] = _linear(sd, prefix + "attention.attention.proj_p.")
    return out


def _linear_attn_layer(sd: dict, prefix: str) -> dict:
    out = _vanilla_layer(sd, prefix)
    out["attention"]["scale"] = sd[prefix + "attention.attention.scale"]
    return out


def _geometric_transformer(sd: dict, prefix: str, blocks=("self", "cross")) -> dict:
    return {f"layer{i}": (_rpe_layer if b == "self" else _vanilla_layer)(sd, f"{prefix}layers.{i}.")
            for i, b in enumerate(blocks)}


def _stack_blocks(trees: list):
    """Per-block trees stacked leaf by leaf on a leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack_blocks([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _shared_mlp(sd: dict, prefix: str, n_layers: int, name: str) -> Tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    for i in range(n_layers):
        w = sd[f"{prefix}layer{i}.conv.weight"]  # (out, in, 1, 1)
        params[f"{name}_fc{i}_kernel"] = np.ascontiguousarray(w[:, :, 0, 0].T)
        bnp = f"{prefix}layer{i}.normlayer.bn."
        params[f"{name}_bn{i}"] = {"scale": sd[bnp + "weight"], "bias": sd[bnp + "bias"]}
        stats[f"{name}_bn{i}"] = {"mean": sd[bnp + "running_mean"], "var": sd[bnp + "running_var"]}
    return params, stats


def convert_fine_pe(sd: dict, prefix: str = "PE.") -> Tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    for name in ("mlp1", "mlp2"):
        p, s = _shared_mlp(sd, f"{prefix}{name}.", 3, name)
        params.update(p)
        stats.update(s)
    w3 = sd[prefix + "mlp3.conv.weight"]  # (out, in, 1)
    params["mlp3"] = {"kernel": np.ascontiguousarray(w3[:, :, 0].T), "bias": sd[prefix + "mlp3.conv.bias"]}
    return params, stats


def convert_geo_embedding(sd: dict, prefix: str = "geo_embedding.") -> dict:
    return {"proj_d": _sincos_permuted_linear(sd, prefix + "proj_d."),
            "proj_a": _sincos_permuted_linear(sd, prefix + "proj_a.")}


def convert_coarse_matching(sd: dict, prefix: str = "coarse_point_matching.", nblock: int = 3) -> dict:
    blocks = [{"transformer": _geometric_transformer(sd, f"{prefix}transformers.{i}."),
               "score_head": _linear(sd, f"{prefix}score_heads.{i}.")} for i in range(nblock)]
    return {"in_proj": _linear(sd, prefix + "in_proj."), "out_proj": _linear(sd, prefix + "out_proj."),
            "bg_token": sd[prefix + "bg_token"], "blocks": _stack_blocks(blocks)}


def convert_fine_matching(sd: dict, prefix: str = "fine_point_matching.", nblock: int = 3) -> Tuple[dict, dict]:
    blocks = [{"transformer": {"sparse_layer": _geometric_transformer(sd, f"{prefix}transformers.{i}.sparse_layer."),
                               "dense_layer": _linear_attn_layer(sd, f"{prefix}transformers.{i}.dense_layer.")},
               "score_head": _linear(sd, f"{prefix}score_heads.{i}.")} for i in range(nblock)]
    pe_params, pe_stats = convert_fine_pe(sd, prefix + "PE.")
    params = {"in_proj": _linear(sd, prefix + "in_proj."), "out_proj": _linear(sd, prefix + "out_proj."),
              "bg_token": sd[prefix + "bg_token"], "pe": pe_params, "blocks": _stack_blocks(blocks)}
    return params, {"pe": pe_stats}


def convert_encoder(sd: dict, prefix: str = "feature_extraction.", depth: int = 12, reg_tokens: int = 4) -> dict:
    """The ViT (timm naming under ``rgb_net.vit``) and the linear upscaler."""
    vit = prefix + "rgb_net.vit."
    vit_sd = {k[len(vit):]: v for k, v in sd.items() if k.startswith(vit)}
    rgb_net = {"vit": convert_timm_vit_to_flax(vit_sd, depth=depth, reg_tokens=reg_tokens)}
    up = prefix + "rgb_net.output_upscaling."
    if up + "weight" in sd:
        rgb_net["output_upscaling"] = _linear(sd, up)
    return {"rgb_net": rgb_net}


def convert_unopose_state_dict(state_dict: dict, nblock_coarse: int = 3, nblock_fine: int = 3, depth: int = 12,
                               reg_tokens: int = 4) -> Dict[str, dict]:
    """The reference state dict -> the flax layout ``{"params": ...,
    "batch_stats": ...}`` of numpy arrays, as the JAX converter makes it."""
    sd = _np(state_dict)
    fine_params, fine_stats = convert_fine_matching(sd, nblock=nblock_fine)
    return {
        "params": {
            "encoder": convert_encoder(sd, depth=depth, reg_tokens=reg_tokens),
            "geo_embed": convert_geo_embedding(sd),
            "coarse_matching": convert_coarse_matching(sd, nblock=nblock_coarse),
            "fine_matching": fine_params,
        },
        "batch_stats": {"fine_matching": fine_stats},
    }


def reference_to_state_dict(state_dict: dict, nblock_coarse: int = 3, nblock_fine: int = 3, depth: int = 12,
                            reg_tokens: int = 4) -> Dict[str, torch.Tensor]:
    """The reference state dict -> the port's state dict (float32 tensors)."""
    state = flax_to_torch(convert_unopose_state_dict(state_dict, nblock_coarse, nblock_fine, depth, reg_tokens))
    logger.info("converted a reference checkpoint: %d tensors -> %d", len(state_dict), len(state))
    return state


def load_reference_checkpoint(path: str) -> dict:
    """A reference ``.pth`` (a state dict, or one under ``model`` or
    ``state_dict``) as numpy arrays, the ``module.`` prefix of a
    data-parallel save stripped. Loaded with ``weights_only``: tensors and
    plain containers alone."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    return _np(sd)


def load_reference_into(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load the reference checkpoint at ``path`` into ``model`` (a
    ``UNOPose``, best built with ``fine_point_matching.parity_gather=True``),
    strictly: every parameter and buffer from the checkpoint. The block
    counts and the ViT's depth and register tokens are the model's."""
    vit = model.encoder.rgb_net.vit
    depth = sum(len(getattr(vit, f"blocks{s}")) for s in range(4))
    state = reference_to_state_dict(load_reference_checkpoint(path), len(model.coarse_matching.blocks),
                                    len(model.fine_matching.blocks), depth, vit.reg_tokens)
    model.load_state_dict(state, strict=True)
    return model
