"""Drive unopose_tpu_torch.ops end to end, as a user would: a reference cloud
and a query cloud under a known relative pose -> FPS (the fps kernel on the
card) -> global LRF -> ball-query grouping -> coarse hypothesis search and
fine weighted-SVD refinement on the oracle attention -> the recovered poses
against the known one, within 1 degree and 0.02; and an all-zero probe
whose fine pose must stay finite. The counterpart of
``examples/pose_recovery_synthetic.py``.

    python examples/pose_recovery_synthetic_torch.py [--device cpu] [--batch 4] [--npts 2048]
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys
import time

import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from unopose_tpu_torch.ops import (  # noqa: E402
    compute_coarse_Rt_overlap,
    compute_fine_Rt_overlap,
    fps,
    global_lrf,
    query_and_group,
    quat_to_rotmat,
)

ROT_LIMIT_DEG, TRANS_LIMIT = 1.0, 0.02


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device: str = "cuda", batch: int = 4, npts: int = 2048, npoint: int = 196, n_proposal1: int = 6000,
        n_proposal2: int = 300, seed: int = 42, log=print) -> dict:
    """The example at ``batch`` pairs of ``npts`` points on ``device``. Returns
    each stage's rotation errors (degrees) and translation errors, the FPS
    and solver times (ms, from the host clock around synchronised calls),
    and whether the all-zero probe stayed finite. Raises ``AssertionError``
    where a limit fails."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (run with --device cpu for the CPU)")
    rng = np.random.default_rng(seed)
    B, N = batch, npts
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R_gt = quat_to_rotmat(torch.from_numpy(q)).float().numpy()
    t_gt = (rng.normal(size=(B, 3)) * 0.3).astype(np.float32)
    pts2 = rng.uniform(-1, 1, size=(B, N, 3)).astype(np.float32)  # the reference cloud
    pts1 = (np.einsum("bij,bnj->bni", R_gt, pts2) + t_gt[:, None]).astype(np.float32)
    pts1 += 0.002 * rng.normal(size=pts1.shape).astype(np.float32)
    p1, p2 = torch.from_numpy(pts1).to(dev), torch.from_numpy(pts2).to(dev)
    out = {}

    t0 = time.perf_counter()
    idx = fps(p1, npoint)
    _sync(dev)
    out["fps_ms"] = (time.perf_counter() - t0) * 1e3
    distinct = len(set(idx[0].tolist()))
    log(f"fps {B}x{N} -> {npoint}: {out['fps_ms']:.2f} ms (first call), idx[0, :8] = {idx[0, :8].tolist()}")
    assert distinct == npoint, f"FPS picked {distinct} distinct points of {npoint}"

    a, b = global_lrf(p1).cpu().numpy(), global_lrf(p2).cpu().numpy()
    dev_lrf = np.abs(np.sort(np.linalg.norm(a, axis=-1), 1) - np.sort(np.linalg.norm(b, axis=-1), 1)).max()
    log(f"LRF invariance across the rigid transform: max deviation {dev_lrf:.3e}")

    grouped, _ = query_and_group(0.1, 64, p1, p1)
    out["grouped_finite"] = bool(torch.isfinite(grouped).all())
    log(f"grouped {tuple(grouped.shape)}, finite {out['grouped_finite']}")
    assert out["grouped_finite"] and tuple(grouped.shape) == (B, N, 64, 3)

    # the oracle attention: the identity correspondence, every point foreground
    atten = torch.full((B, N + 1, N + 1), -5.0, device=dev)
    atten[:, 1:, 1:] += 10.0 * torch.eye(N, device=dev)
    score = torch.ones((B, 2 * N), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    Rc, tc, sc = compute_coarse_Rt_overlap(atten, score, p1, p2, n_proposal1, n_proposal2, generator=gen)
    _sync(dev)
    out["coarse_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    Rf, tf, sf, _ = compute_fine_Rt_overlap(atten, score, p1, p2)
    _sync(dev)
    out["fine_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"coarse solver ({n_proposal1} triplets -> {n_proposal2} -> 1) {out['coarse_ms']:.1f} ms, "
        f"fine solver ({N}x{N} assignment) {out['fine_ms']:.1f} ms (first calls)")

    for name, R, t, s in (("coarse", Rc, tc, sc), ("fine", Rf, tf, sf)):
        R, t = R.double().cpu().numpy(), t.double().cpu().numpy()
        ang = np.degrees(np.arccos(np.clip((np.einsum("bij,bij->b", R, R_gt) - 1) / 2, -1, 1)))
        terr = np.linalg.norm(t - t_gt, axis=-1)
        out[f"{name}_rot_deg"], out[f"{name}_trans"] = ang.tolist(), terr.tolist()
        log(f"{name}: rot err deg {ang.round(4).tolist()}, trans err {terr.round(5).tolist()}, "
            f"score {s.cpu().numpy().round(3).tolist()}")
        assert ang.max() < ROT_LIMIT_DEG and terr.max() < TRANS_LIMIT, f"{name} pose recovery failed"

    z = torch.zeros((1, N, 3), device=dev)
    Rz, tz, _, _ = compute_fine_Rt_overlap(torch.zeros((1, N + 1, N + 1), device=dev), torch.zeros((1, 2 * N),
                                           device=dev), z, z)
    out["zero_probe_finite"] = bool(torch.isfinite(Rz).all() and torch.isfinite(tz).all())
    log(f"degenerate all-zero input -> finite: {out['zero_probe_finite']}")
    assert out["zero_probe_finite"], "the all-zero probe's pose is not finite"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--npts", type=int, default=2048)
    args = ap.parse_args(argv)
    run(args.device, args.batch, args.npts)
    print(f"OK: end-to-end pose recovery on {args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
