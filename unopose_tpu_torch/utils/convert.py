"""Convert a flax variables tree of the JAX package into a torch state dict.

The torch modules use the flax module and parameter names, so the mapping
is structural:

- ``params`` and ``batch_stats`` merge into one namespace (BatchNorm running
  statistics are the buffers ``mean``/``var`` beside ``weight``/``bias``;
  a train state's ``batch_stats`` go to those buffers, which the train step
  updates, and ``scale``/``bias`` to the trainable parameters);
- a module holding ``kernel`` (and ``bias``) with a 2-D kernel is a Dense:
  the flax (in, out) kernel becomes the torch (out, in) ``weight``;
- a module holding exactly ``scale`` and ``bias`` is a norm: ``scale``
  becomes ``weight``;
- the upscaler's transposed convolutions (``deconv1``, ``deconv2``): flax's
  ``ConvTranspose`` (``transpose_kernel=False``) correlates the
  stride-dilated input with its (kh, kw, in, out) kernel, where torch's
  ``ConvTranspose2d`` scatters each input pixel through its (in, out, kh,
  kw) weight, so the kernel is flipped in both spatial axes and permuted;
- every other leaf (embeddings, tokens, LayerScale, the PE's raw
  ``mlp*_fc*_kernel``, the linear attention ``scale``) keeps its name and
  layout;
- a scanned stack (``blocks``, ``blocks0`` .. ``blocks3``) carries the layer
  on axis 0 and becomes ``<stack>.<i>.``, an ``nn.ModuleList``.

Every flax leaf is consumed exactly once: a leaf that maps to no key, or
two leaves that map to one key, raise; ``load_flax_variables`` then loads
strictly, so every torch parameter and buffer has exactly one source.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_STACK = re.compile(r"blocks\d*")
_DECONV = re.compile(r"deconv\d+")


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def flax_to_torch(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of numpy arrays -> state dict."""
    leaves: Dict[tuple, np.ndarray] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})).items():
            if path in leaves:
                raise ValueError(f"leaf {'/'.join(path)} appears in two collections")
            leaves[path] = arr
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected variable collections: {sorted(unknown)}")

    siblings: Dict[tuple, set] = {}
    for path in leaves:
        siblings.setdefault(path[:-1], set()).add(path[-1])

    state: Dict[str, torch.Tensor] = {}
    source: Dict[str, tuple] = {}
    for path, arr in leaves.items():
        parent, leaf = path[:-1], path[-1]
        kind = siblings[parent] - {"mean", "var"}
        stack_at = next((i for i, p in enumerate(parent) if _STACK.fullmatch(p)), None)
        layers = range(arr.shape[0]) if stack_at is not None else [None]
        keys = []
        for li in layers:
            a = arr[li] if li is not None else arr
            names = list(parent)
            if li is not None:
                names.insert(stack_at + 1, str(li))
            if leaf == "kernel" and kind <= {"kernel", "bias"} and a.ndim == 2:
                names.append("weight")  # Dense: (in, out) -> (out, in)
                a = a.T
            elif leaf == "kernel" and parent and _DECONV.fullmatch(parent[-1]) and a.ndim == 4:
                names.append("weight")  # ConvTranspose: (kh, kw, in, out) -> (in, out, kh, kw), flipped
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif leaf == "scale" and kind == {"scale", "bias"}:
                names.append("weight")  # LayerNorm / BatchNorm scale
            else:
                names.append(leaf)
            key = ".".join(names)
            if key in source:
                raise ValueError(f"flax leaves {source[key]} and {path} both map to {key}")
            source[key] = path
            state[key] = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
            keys.append(key)
        if not keys:
            raise ValueError(f"flax leaf {'/'.join(path)} maps to no torch key")
    return state


def load_flax_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> torch.nn.Module:
    """Convert ``variables`` and load them into ``model`` (strict: every torch
    parameter and buffer must be covered, and nothing extra)."""
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return model
