"""Training checkpoints and the pretrained backbone (counterpart of
``unopose_tpu/utils/checkpoint.py``).

``Checkpointer`` keeps a train state every ``period`` iterations and the
last ``max_to_keep`` of them, one directory a step named by the step, as
orbax lays them out. A saved state is what the JAX package's ``TrainState``
holds: every parameter (the frozen ViT too) and buffer of the model (the
BatchNorm running statistics), the Adam state, the update count and, where
the trainer keeps one, the model EMA. A step
is written under a temporary name and renamed into place, so that a run
killed while saving leaves no half-written step.

The timm DINOv2 graft: a timm ``VisionTransformer`` state dict is mapped
onto the JAX package's flax ViT layout (``convert_timm_vit_to_flax``), then
by ``utils/convert.py`` onto the port's ViT, whose modules carry the flax
names; the patch position embeddings are resampled to the model's grid
(``interpolate_pos_embed_np``) first.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import shutil
import tempfile
from typing import List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


class Checkpointer:
    """Steps under ``directory`` (created at the first save)."""

    def __init__(self, directory: str, max_to_keep: int = 2, period: int = 5000):
        self.directory = osp.abspath(directory)
        self.max_to_keep = max_to_keep
        self.period = period

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        if not osp.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and osp.isfile(osp.join(self.directory, n, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, trainer) -> None:
        """Write ``trainer``'s state as ``step``, then drop the oldest steps past ``max_to_keep``."""
        state = dict(model=trainer.model.state_dict(), optimizer=trainer.optimizer.state_dict(),
                     iteration=trainer.iteration)
        if getattr(trainer, "ema", None) is not None:
            state["ema"] = trainer.ema
        os.makedirs(self.directory, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
        try:
            with open(osp.join(tmp, STATE_FILE), "wb") as f:
                torch.save(state, f)
                f.flush()
                os.fsync(f.fileno())
            final = osp.join(self.directory, str(step))
            if osp.isdir(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(osp.join(self.directory, str(old)))
        logger.info("saved checkpoint at step %d -> %s", step, self.directory)

    def load(self, step: Optional[int] = None) -> Optional[dict]:
        """The saved state of ``step`` (the latest by default) on the CPU, or
        None where there is none: ``model`` (a state dict), ``optimizer``,
        ``iteration`` and, where it was saved, ``ema``. Eval reads the
        model's part alone."""
        step = self.latest_step() if step is None else step
        if step is None or step not in self.steps():
            return None
        return torch.load(osp.join(self.directory, str(step), STATE_FILE), map_location="cpu", weights_only=True)

    def restore(self, trainer, step: Optional[int] = None):
        """Load ``step`` (the latest by default) into ``trainer``: the model's
        parameters and buffers, the Adam state, the update count and the
        EMA, which a trainer that keeps one must find in the step."""
        state = self.load(step)
        if state is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        ema = getattr(trainer, "ema", None)
        if ema is not None and set(state.get("ema", {})) != set(ema):
            raise KeyError(f"the step under {self.directory} holds no EMA of the model's parameters")
        trainer.model.load_state_dict(state["model"], strict=True)
        trainer.optimizer.load_state_dict(state["optimizer"])
        trainer.iteration = state["iteration"]
        if ema is not None:
            with torch.no_grad():
                for k, v in state["ema"].items():
                    trainer.ema[k].copy_(v)
        return trainer


# --------------------------------------------------------------------------- the timm DINOv2 backbone

VIT_PREFIX = "encoder.rgb_net.vit."  # the ViT's place in the model's state dict


def convert_timm_vit_to_flax(state_dict: dict, depth: int = 12, reg_tokens: int = 4,
                             no_embed_class: bool = True) -> dict:
    """A timm ``VisionTransformer`` state dict (numpy arrays) in the JAX
    package's ViT layout:

        patch_embed.proj.{weight,bias} -> patch_embed (conv -> GEMM kernel)
        cls_token / reg_token / pos_embed -> same names; without
            ``no_embed_class`` timm's pos_embed starts with the 1 + reg_tokens
            prefix rows, which go to pos_embed_prefix
        blocks.i.norm{1,2}.{weight,bias} -> blocks<s>.norm{1,2}.{scale,bias}[j]
        blocks.i.attn.qkv.* -> blocks<s>.qkv[j]; blocks.i.attn.proj.* -> blocks<s>.attn_proj[j]
        blocks.i.ls{1,2}.gamma -> blocks<s>.ls{1,2}[j]
        blocks.i.mlp.fc{1,2}.* -> blocks<s>.mlp.fc{1,2}[j]
        norm.{weight,bias} -> norm.{scale,bias}

    Block i is layer j of segment s: the four segments ``blocks0..3`` hold
    ``[depth - 3 * (depth // 4)] + [depth // 4] * 3`` blocks, stacked on a
    leading axis."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    w = sd["patch_embed.proj.weight"]  # (D, 3, P, P) -> (P * P * 3, D), the patchify order (P, P, 3)
    D, C, P, _ = w.shape
    params: dict = {
        "patch_embed": {"kernel": w.transpose(2, 3, 1, 0).reshape(P * P * C, D), "bias": sd["patch_embed.proj.bias"]},
        "cls_token": sd["cls_token"],
        "pos_embed": sd["pos_embed"],
    }
    if reg_tokens and "reg_token" in sd:
        params["reg_token"] = sd["reg_token"]
    if not no_embed_class:
        npfx = 1 + reg_tokens
        params["pos_embed_prefix"], params["pos_embed"] = sd["pos_embed"][:, :npfx], sd["pos_embed"][:, npfx:]
    n = depth // 4
    start = 0
    for si, seg_len in enumerate([depth - 3 * n] + [n] * 3):
        ids = range(start, start + seg_len)
        start += seg_len

        def stack(fmt, ids=ids):
            return np.stack([sd[fmt.format(i)] for i in ids])

        def dense(name, ids=ids):
            return {"kernel": stack(f"blocks.{{}}.{name}.weight", ids).transpose(0, 2, 1),
                    "bias": stack(f"blocks.{{}}.{name}.bias", ids)}

        blocks = {
            "norm1": {"scale": stack("blocks.{}.norm1.weight"), "bias": stack("blocks.{}.norm1.bias")},
            "norm2": {"scale": stack("blocks.{}.norm2.weight"), "bias": stack("blocks.{}.norm2.bias")},
            "qkv": dense("attn.qkv"),
            "attn_proj": dense("attn.proj"),
            "mlp": {"fc1": dense("mlp.fc1"), "fc2": dense("mlp.fc2")},
        }
        if "blocks.0.ls1.gamma" in sd:
            blocks["ls1"] = stack("blocks.{}.ls1.gamma")
            blocks["ls2"] = stack("blocks.{}.ls2.gamma")
        params[f"blocks{si}"] = blocks
    params["norm"] = {"scale": sd["norm.weight"], "bias": sd["norm.bias"]}
    return params


def load_timm_checkpoint(path: str) -> dict:
    """A timm ``.pth`` checkpoint (its ``model`` entry where it has one) as numpy arrays."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model = ckpt.get("model", ckpt)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in model.items()}


def graft_vit_params(model: torch.nn.Module, vit_params: dict) -> torch.nn.Module:
    """Copy the flax-layout ViT tree ``vit_params`` into ``model``'s ViT
    (``VIT_PREFIX``), each tensor cast to its parameter's dtype. Every ViT
    tensor of the model must have a source of its shape, and every source a
    tensor: else ``KeyError`` or ``ValueError`` and nothing is copied."""
    from unopose_tpu_torch.utils.convert import flax_to_torch

    src = {VIT_PREFIX + k: v for k, v in flax_to_torch({"params": vit_params}).items()}
    own = model.state_dict()
    vit_keys = {k for k in own if k.startswith(VIT_PREFIX)}
    if vit_keys != set(src):
        raise KeyError(f"the pretrained ViT's tensors {sorted(set(src) - vit_keys)} are not the model's, and the "
                       f"model's {sorted(vit_keys - set(src))} have no source")
    for k, v in src.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: pretrained shape {tuple(v.shape)} != model shape {tuple(own[k].shape)}")
    with torch.no_grad():
        for k, v in src.items():
            own[k].copy_(v)
    return model


def maybe_load_pretrained_vit(model: torch.nn.Module, fe_cfg) -> bool:
    """Graft the timm DINOv2 checkpoint ``fe_cfg.vit_ckpt`` into ``model``'s
    ViT where ``fe_cfg.pretrained`` is set, its patch position embeddings
    resampled to the model's grid (the prefix tokens' rows, where the
    variant's pos embed covers them, kept as they are); returns whether it did. A set ``pretrained`` with no
    such file raises ``FileNotFoundError``; a frozen ViT left at random
    weights is warned about (test configurations only)."""
    from unopose_tpu_torch.models.vit import VIT_VARIANTS

    if not fe_cfg.get("pretrained", False):
        if fe_cfg.get("freeze_vit", False):
            logger.warning(
                "freeze_vit without pretrained weights: the frozen backbone stays at random init (the reference "
                "asserts 'freeze must use pretrained'; only test and debug configs should hit this)")
        return False
    ckpt = fe_cfg.get("vit_ckpt", "")
    if not ckpt or not osp.exists(ckpt):
        raise FileNotFoundError(
            f"model.feature_extraction.pretrained=True but vit_ckpt does not exist: {ckpt!r} "
            "(set pretrained=False to train from scratch)")
    vit_type = fe_cfg.get("vit_type", "vit_base_patch14_reg4_dinov2")
    variant = VIT_VARIANTS[vit_type]
    sd = load_timm_checkpoint(ckpt)
    grid = fe_cfg.get("img_size", 224) // variant["patch_size"]
    pe, npfx = sd["pos_embed"], 0 if variant["no_embed_class"] else 1 + variant["reg_tokens"]
    sd["pos_embed"] = np.concatenate([pe[:, :npfx], interpolate_pos_embed_np(pe[:, npfx:], grid)], axis=1)
    graft_vit_params(model, convert_timm_vit_to_flax(sd, depth=variant["depth"], reg_tokens=variant["reg_tokens"],
                                                     no_embed_class=variant["no_embed_class"]))
    logger.info("loaded pretrained ViT weights from %s (%s, grid %d)", ckpt, vit_type, grid)
    return True


def interpolate_pos_embed_np(pos_embed: np.ndarray, new_grid: int) -> np.ndarray:
    """(1, g * g, D) patch position embeddings resampled to (1, new_grid ** 2,
    D) by ``scipy.ndimage.zoom`` at order 3 (cubic spline)."""
    from scipy.ndimage import zoom

    _, n, d = pos_embed.shape
    g = int(round(n**0.5))
    if g == new_grid:
        return pos_embed
    out = zoom(pos_embed.reshape(g, g, d), (new_grid / g, new_grid / g, 1.0), order=3)
    return out.reshape(1, new_grid * new_grid, d).astype(pos_embed.dtype)
