"""The port's ops (counterpart of ``unopose_tpu/ops/__init__.py``, which
exports the same names but the TPU-only FPS entry points ``fps_pallas`` and
``fps_xla``: here ``fps`` dispatches by device, to the kernel on the card)."""

from unopose_tpu_torch.ops.geometry import (
    backproject,
    compute_feature_similarity,
    inverse_transform_pts,
    pairwise_dist,
    pairwise_sqdist,
    transform_pts,
)
from unopose_tpu_torch.ops.procrustes import kabsch_rotation, quat_to_rotmat, weighted_procrustes
from unopose_tpu_torch.ops.eig3 import eigvals_sym3, largest_eigvec_sym3, smallest_eigvec_sym3
from unopose_tpu_torch.ops.lrf import batch_lrf, global_lrf
from unopose_tpu_torch.ops.fps import fps, gather_points, sample_pts_feats, sample_pts_feats_wlrf
from unopose_tpu_torch.ops.ball_query import ball_query, group_points, query_and_group
from unopose_tpu_torch.ops.rotation import aug_pose_noise, random_so3, rot_x, rot_y, rot_z
from unopose_tpu_torch.ops.solver import compute_coarse_Rt_overlap, compute_fine_Rt_overlap
