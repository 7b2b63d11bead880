"""A reference-layout UNOPose checkpoint made from a port model: the rules
of ``utils/ref_convert.py`` run backwards, for the tests and
``chip_smoke.py`` where no published checkpoint is at hand.

``reference_state_dict(model)`` maps every parameter and buffer of a
``UNOPose`` onto the reference's names and layouts: the timm ViT under
``feature_extraction.rgb_net.vit`` (the patch embedding back to its
(D, 3, P, P) convolution, the segments' blocks back to ``blocks.i``), the
sinusoid projections' input rows back to the interleaved (sin, cos) order,
one module per block (``transformers.i``, ``score_heads.i``), the
transformer layers' ``attention.attention.*`` nesting, and the fine PE's
1 x 1 convolutions and BatchNorms. It adds what the reference holds and the
conversion drops: the sinusoid's ``div_term`` buffer, the unused
``fine_point_matching.dis_proj`` and the BatchNorms' ``num_batches_tracked``.
The JAX package's ``convert_unopose_state_dict`` maps the result back to
the parameters it came from, bit for bit (``tests/test_torch_ref_convert.py``).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from unopose_tpu_torch.utils.ref_convert import sincos_perm

_VIT = "encoder.rgb_net.vit."
_LAYER = {  # a transformer layer's port names -> the reference's
    "attention.proj_q": "attention.attention.proj_q", "attention.proj_k": "attention.attention.proj_k",
    "attention.proj_v": "attention.attention.proj_v", "attention.proj_p": "attention.attention.proj_p",
    "attention.scale": "attention.attention.scale", "linear": "attention.linear", "norm": "attention.norm",
    "output.expand": "output.expand", "output.squeeze": "output.squeeze", "output.norm": "output.norm",
}
_BN = {"weight": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _layer(rest: str) -> str:
    """``attention.proj_q.weight`` -> ``attention.attention.proj_q.weight`` (and so on)."""
    if rest in _LAYER:  # a bare parameter: the linear attention's scale
        return _LAYER[rest]
    module, leaf = rest.rsplit(".", 1)
    return f"{_LAYER[module]}.{leaf}"


def _vit_key(key: str, segments: list) -> str:
    """A port ViT key (flax names, blocks in four segments) -> its timm name."""
    m = re.fullmatch(r"blocks(\d)\.(\d+)\.(.+)", key)
    if m is None:
        return {"patch_embed.weight": "patch_embed.proj.weight", "patch_embed.bias": "patch_embed.proj.bias"}.get(
            key, key)
    s, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
    i = sum(segments[:s]) + j
    rest = {"ls1": "ls1.gamma", "ls2": "ls2.gamma"}.get(rest, rest)
    rest = re.sub(r"^qkv\.", "attn.qkv.", rest)
    rest = re.sub(r"^attn_proj\.", "attn.proj.", rest)
    return f"blocks.{i}.{rest}"


def reference_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model`` (a ``UNOPose`` with its coarse stage) -> the reference's
    state dict, float32 tensors on the CPU (``num_batches_tracked`` int64)."""
    vit = model.encoder.rgb_net.vit
    segments = [len(getattr(vit, f"blocks{s}")) for s in range(4)]
    P = vit.patch_size
    out: Dict[str, torch.Tensor] = {}
    for key, t in model.state_dict().items():
        a = t.detach().float().cpu().numpy()
        if key.startswith(_VIT):
            name = _vit_key(key[len(_VIT):], segments)
            if name == "patch_embed.proj.weight":  # (D, P P 3) -> (D, 3, P, P)
                a = a.T.reshape(P, P, 3, -1).transpose(3, 2, 0, 1)
            ref = "feature_extraction.rgb_net.vit." + name
        elif key.startswith("encoder.rgb_net."):
            ref = "feature_extraction." + key[len("encoder."):]
        elif key.startswith("geo_embed."):
            ref = "geo_embedding." + key[len("geo_embed."):]
            if key.endswith(".weight"):  # the concatenated sinusoid rows back to the interleaved order
                w = np.empty_like(a)
                w[:, sincos_perm(a.shape[1])] = a
                a = w
        else:
            ref = _matcher_key(key)
            if ref.endswith(".conv.weight") and ".mlp3." not in ref:  # planar (in, out) -> (out, in, 1, 1)
                a = a.T[:, :, None, None]
            elif ref.endswith("mlp3.conv.weight"):  # (out, in) -> (out, in, 1)
                a = a[:, :, None]
        out[ref] = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    d = model.geo_embed.hidden_dim
    out["geo_embedding.embedding.div_term"] = torch.exp(
        torch.arange(0, d, 2, dtype=torch.float32) * float(-np.log(10000.0) / d))
    fm = model.fine_matching
    out["fine_point_matching.dis_proj.weight"] = torch.zeros(fm.out_proj.weight.shape)
    out["fine_point_matching.dis_proj.bias"] = torch.zeros(fm.out_proj.weight.shape[0])
    for name in [k for k in out if k.endswith("normlayer.bn.running_mean")]:
        out[name.replace("running_mean", "num_batches_tracked")] = torch.tensor(0, dtype=torch.int64)
    return out


def _matcher_key(key: str) -> str:
    """A coarse or fine matcher key -> the reference's."""
    stage, rest = key.split(".", 1)
    ref_stage = {"coarse_matching": "coarse_point_matching", "fine_matching": "fine_point_matching"}[stage]
    m = re.fullmatch(r"blocks\.(\d+)\.(.+)", rest)
    if m is None:
        pm = re.fullmatch(r"pe\.mlp(\d)_fc(\d)_kernel", rest)
        if pm:
            return f"{ref_stage}.PE.mlp{pm.group(1)}.layer{pm.group(2)}.conv.weight"
        pm = re.fullmatch(r"pe\.mlp(\d)_bn(\d)\.(\w+)", rest)
        if pm:
            return f"{ref_stage}.PE.mlp{pm.group(1)}.layer{pm.group(2)}.normlayer.bn.{_BN[pm.group(3)]}"
        if rest.startswith("pe.mlp3."):
            return f"{ref_stage}.PE.mlp3.conv.{rest.rsplit('.', 1)[1]}"
        return f"{ref_stage}.{rest}"
    i, rest = m.group(1), m.group(2)
    if rest.startswith("score_head."):
        return f"{ref_stage}.score_heads.{i}.{rest[len('score_head.'):]}"
    m = re.fullmatch(r"transformer\.(sparse_layer\.)?layer(\d+)\.(.+)", rest)
    if m:
        return f"{ref_stage}.transformers.{i}.{m.group(1) or ''}layers.{m.group(2)}.{_layer(m.group(3))}"
    m = re.fullmatch(r"transformer\.dense_layer\.(.+)", rest)
    return f"{ref_stage}.transformers.{i}.dense_layer.{_layer(m.group(1))}"


def write_fake_reference(path: str, model: torch.nn.Module, wrap: str = "model") -> Dict[str, torch.Tensor]:
    """Save ``reference_state_dict(model)`` to ``path`` as a training
    script would (under ``wrap``: "model", "state_dict", or "" for the bare
    state dict) and return it."""
    sd = reference_state_dict(model)
    torch.save({wrap: sd} if wrap else sd, path)
    return sd
