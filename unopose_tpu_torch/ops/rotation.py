"""Rotations about the axes and the train step's initial-pose noise
(counterpart of ``unopose_tpu/ops/rotation.py``: ``rot_x``, ``rot_y``,
``rot_z``, ``aug_pose_noise``), and the training data's random rotation
(``unopose_tpu/data/dataset_train.py:random_rotation_np``).

The noise's random draws are arguments (``PoseNoiseDraws``) or come from a
``torch.Generator``: the JAX package draws them from a key, so the tests
draw them with JAX and hand the same numbers to both packages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

STD_ROTS = (15.0, 10.0, 5.0, 1.25, 1.0)  # degrees; one is drawn per batch
MAX_ROT = 45.0
STD_TRANS = (0.2, 0.2, 0.2)
MAX_TRANS = 0.8


def _stack(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_z(a: torch.Tensor) -> torch.Tensor:
    """(...,) radians -> (..., 3, 3) rotation about z."""
    c, s, o, i = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return _stack([[c, -s, o], [s, c, o], [o, o, i]])


def rot_x(a: torch.Tensor) -> torch.Tensor:
    c, s, o, i = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return _stack([[i, o, o], [o, c, -s], [o, s, c]])


def rot_y(a: torch.Tensor) -> torch.Tensor:
    c, s, o, i = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return _stack([[c, o, s], [o, i, o], [-s, o, c]])


class PoseNoiseDraws(NamedTuple):
    """The random numbers of one ``aug_pose_noise`` call: the index into
    ``STD_ROTS`` (one per batch), (B, 3) standard normals of the Euler
    angles and (B, 3) standard normals of the translation."""

    std_index: int
    angles: torch.Tensor
    trans: torch.Tensor

    @classmethod
    def draw(cls, batch: int, generator: Optional[torch.Generator] = None, device=None) -> "PoseNoiseDraws":
        dev = generator.device if generator is not None else device
        idx = int(torch.randint(0, len(STD_ROTS), (1,), generator=generator, device=dev).item())
        ang = torch.randn((batch, 3), generator=generator, device=dev)
        tr = torch.randn((batch, 3), generator=generator, device=dev)
        return cls(idx, ang, tr)


def aug_pose_noise(gt_r: torch.Tensor, gt_t: torch.Tensor, draws: PoseNoiseDraws):
    """Train-time initial pose: gt_r (B, 3, 3) times Rz(a0) Rx(a1) Ry(a2) of
    the draws' angles (std ``STD_ROTS[std_index]`` degrees, clamped to
    +-``MAX_ROT``) on the right, gt_t (B, 3) plus clamped gaussian noise with
    z kept positive. No gradient flows through either output."""
    dev = gt_r.device
    std = torch.tensor(STD_ROTS, dtype=torch.float32)[draws.std_index].item()
    angles = torch.clamp(draws.angles.to(dev).float() * std, -MAX_ROT, MAX_ROT) * (np.pi / 180.0)
    rand_rot = rot_z(angles[:, 0]) @ rot_x(angles[:, 1]) @ rot_y(angles[:, 2])
    trans = draws.trans.to(dev).float() * torch.tensor(STD_TRANS, dtype=torch.float32, device=dev)
    trans = torch.clamp(trans, -MAX_TRANS, MAX_TRANS)
    out_r = gt_r.float() @ rand_rot
    out_t = gt_t.float() + trans
    out_t = torch.cat([out_t[:, :2], torch.clamp_min(out_t[:, 2:], 1e-6)], dim=1)
    return out_r.detach(), out_t.detach()


def random_rotation_np(rng: np.random.Generator) -> np.ndarray:
    """Rx(a0) Ry(a1) Rz(a2), a ~ U[0, 2 pi), float32 (3, 3)."""
    a = rng.random(3) * 2 * np.pi
    rx = np.array([[1, 0, 0], [0, np.cos(a[0]), -np.sin(a[0])], [0, np.sin(a[0]), np.cos(a[0])]])
    ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])], [0, 1, 0], [-np.sin(a[1]), 0, np.cos(a[1])]])
    rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0], [np.sin(a[2]), np.cos(a[2]), 0], [0, 0, 1]])
    return (rx @ ry @ rz).astype(np.float32)
