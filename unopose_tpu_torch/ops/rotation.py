"""Rotations about the axes, the conversions between matrices, quaternions
and axis-angle, the geodesic angle, random rotations and the train step's
initial-pose noise (counterpart of ``unopose_tpu/ops/rotation.py``), and
the training data's random rotation
(``unopose_tpu/data/dataset_train.py:random_rotation_np``).

The noise's random draws are arguments (``PoseNoiseDraws``) or come from a
``torch.Generator``: the JAX package draws them from a key, so the tests
draw them with JAX and hand the same numbers to both packages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from unopose_tpu_torch.ops.geometry import sqrt_rn

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


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (w, x, y, z), w >= 0,
    by the JAX package's branchless Shepperd-style formulation."""
    R = R.float()
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw2 = torch.clamp_min(1 + m00 + m11 + m22, 0.0) / 4
    qx2 = torch.clamp_min(1 + m00 - m11 - m22, 0.0) / 4
    qy2 = torch.clamp_min(1 - m00 + m11 - m22, 0.0) / 4
    qz2 = torch.clamp_min(1 - m00 - m11 + m22, 0.0) / 4
    qw = sqrt_rn(qw2)
    safe = torch.clamp_min(4 * qw, 1e-8)
    big = qw > 1e-4
    qx = torch.where(big, (m21 - m12) / safe, sqrt_rn(qx2))
    qy = torch.where(big, (m02 - m20) / safe, sqrt_rn(qy2) * torch.sign(m01 + 1e-30))
    qz = torch.where(big, (m10 - m01) / safe, sqrt_rn(qz2) * torch.sign(m02 + 1e-30))
    q = torch.stack([qw, qx, qy, qz], dim=-1)
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)


def axangle_to_mat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis (..., 3) (normalised here), angle (...,) radians -> (..., 3, 3)."""
    ax = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + 1e-12)
    x, y, z = ax.unbind(-1)
    o = torch.zeros_like(x)
    K = _stack([[o, -z, y], [z, o, -x], [-y, x, o]])
    c, s = torch.cos(angle)[..., None, None], torch.sin(angle)[..., None, None]
    return torch.eye(3, dtype=K.dtype, device=K.device) + s * K + (1 - c) * torch.matmul(K, K)


def mat_to_axangle(R: torch.Tensor):
    """Rotation matrix -> (axis (..., 3), angle (...,)); axis (1, 0, 0) below 1e-6 rad."""
    q = mat_to_quat(R)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    angle = 2.0 * torch.arccos(w)
    s = sqrt_rn(torch.clamp_min(1.0 - w * w, 1e-12))
    axis = q[..., 1:] / s[..., None]
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=axis.dtype, device=axis.device)
    return torch.where(angle[..., None] < 1e-6, x_axis, axis), angle


def rotation_angle_deg(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between two rotations (..., 3, 3), in degrees."""
    cos = (torch.einsum("...ij,...ij->...", R1, R2) - 1.0) / 2.0
    return torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))


def random_so3(generator: Optional[torch.Generator] = None, shape=(), device=None) -> torch.Tensor:
    """Rotations Rx(a0) Ry(a1) Rz(a2), a ~ U[0, 2 pi), of ``shape`` (..., 3, 3),
    drawn from ``generator`` (the JAX package's from a key)."""
    dev = generator.device if generator is not None else device
    a = torch.rand(tuple(shape) + (3,), generator=generator, device=dev) * (2 * np.pi)
    return rot_x(a[..., 0]) @ rot_y(a[..., 1]) @ rot_z(a[..., 2])


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
