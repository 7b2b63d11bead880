"""UNOPose (counterpart of ``unopose_tpu/models/unopose.py``): inference, and
the network pass and loss terms of the training step (``train=True``).

features (exact ViT, or the production ViT: fused attention, W8A8 GEMMs,
tanh-GELU) -> global LRF of both clouds -> FPS to ``coarse_npoint`` nodes
-> geometric embeddings with a bg point at (1, 1, 1) (exact, or fused and
int8) -> coarse matching -> coarse hypothesis search -> fine matching
(first_k packed, unpacked or fused PE, or the subset-mode PE) -> weighted-SVD
fine pose, from the materialised similarity matrix or the fused assignment.
``test_coarse_only`` stops after the coarse search and returns its pose;
``fine_only`` (the reference's NetOneRef ablation) has no coarse stage and
starts the fine stage at the identity pose, in inference and training.

The template cache: ``encode_template`` computes once per reference what
the forward derives from the reference crop alone (its FPS subsample in
meters, the subsample's features, the full cloud's LRF rows below
``fine_npoint`` and radius), and the forward takes those as ``dense_po``,
``dense_fo``, ``dense_po_lrf`` and ``tem1_radius`` in place of the
``tem1_*`` inputs, with the same result.

Training: the ViT on its exact path (frozen with ``freeze_vit``: no
autograd; else differentiated) -> both clouds' LRFs ->
FPS -> the exact geometric embedding (differentiated) -> every coarse
block's similarity, scores and saliencies -> the ground-truth pose with
``aug_pose_noise`` as the fine initial pose -> every fine block's outputs,
the fine PE per cloud with batch-statistics BatchNorm (or, under
``UNOPOSE_PE_TRAIN_FROZEN=1``, the running statistics, frozen), in either
neighbour mode. ``compute_train_losses``
turns them into the per-sample loss terms.

The JAX package's three auto switches (``feature_extraction.fused_attn``,
``fine_point_matching.pe_fused``, ``fused_assignment``) default to None,
"on for TPU inference". The port runs on one production device, so None
means on; the fused assignment, like the JAX package's auto gate, also
needs the fine stage's ``sim_type="cosine"`` and ``normalize_feat``, so the
assignment kernels never see the L2 logits.

Every inference key of the JAX package's ``UNOPose.from_config`` is taken:
the fused embedding with ``quant_int8=False`` writes the float embedding in
the model dtype, ``parity_gather`` reproduces the reference's shifted
gather (a converted reference checkpoint needs it,
``utils/ref_convert.py``), ``pe_dtype`` sets the plain PE MLP's
activation storage, ``use_lrf`` / ``use_xyz`` choose the PE's channels,
and ``sim_type="L2"`` the similarity. In training the JAX package's gates turn off the
ViT's production mode, the fused embedding and the fused assignment, and
the port follows them; ``pe_fused`` (None or True) selects the PE train
kernels (``ops/pe_train.py``), where the JAX package's None selects its XLA
formulation of the same function.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from unopose_tpu_torch.configs import Config
from unopose_tpu_torch.losses import compute_overlap_loss
from unopose_tpu_torch.models.embedding import GeometricStructureEmbedding
from unopose_tpu_torch.models.feature_extraction import ViTEncoderOneRef
from unopose_tpu_torch.models.matching import CoarsePointMatching, FinePointMatching
from unopose_tpu_torch.ops.assignment_fused import compute_fine_Rt_overlap_fused
from unopose_tpu_torch.ops.fps import fps, gather_points, sample_pts_feats_wlrf
from unopose_tpu_torch.ops.lrf import global_lrf
from unopose_tpu_torch.ops.rotation import PoseNoiseDraws, aug_pose_noise
from unopose_tpu_torch.ops.solver import compute_coarse_Rt_overlap, compute_fine_Rt_overlap

POSE_KEYS = ("radius", "init_R", "init_t", "init_pose_score", "pred_R", "pred_t", "pred_pose_score", "fine_wsvd_max_w")


def _on(value, default: bool = True) -> bool:
    """An auto switch: None takes ``default``."""
    return default if value is None else bool(value)


PE_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32, None: None}


def resolve_pe_dtype(value) -> Optional[torch.dtype]:
    """``fine_point_matching.pe_dtype``: "bf16", "fp32" or None (the
    neighbour mode's default), as the JAX package resolves it."""
    if value not in PE_DTYPES:
        raise ValueError(f"pe_dtype must be 'bf16', 'fp32', or None, got {value!r}")
    return PE_DTYPES[value]


def _check_config(cfg: Config) -> None:
    """The ``ValueError``s of a config no model runs: ``test_coarse_only``
    with ``fine_only`` (the matchers raise theirs on an unknown
    ``sim_type`` or ``pe_neighbor_mode``, the embedding on an unknown
    ``reduction_a``)."""
    if cfg.get("test_coarse_only", False) and cfg.get("fine_only", False):
        raise ValueError("test_coarse_only returns the coarse pose, which fine_only does not compute")


class UNOPose(nn.Module):
    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32, backbone_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        _check_config(cfg)
        self.coarse_npoint = cfg.coarse_npoint
        self.fine_npoint = cfg.fine_npoint
        self.use_ref_rad = cfg.get("use_ref_rad", False)
        self.test_coarse_only = bool(cfg.get("test_coarse_only", False))
        self.fine_only = bool(cfg.get("fine_only", False))
        self.dtype = dtype
        fe, ge = cfg.feature_extraction, cfg.geo_embedding
        cm, fm = cfg.coarse_point_matching, cfg.fine_point_matching
        self.nproposal1 = cm.get("nproposal1", 6000)
        self.nproposal2 = cm.get("nproposal2", 300)
        fused_attn = _on(fe.get("fused_attn"))
        # the auto gate of the JAX package: the fused solver rebuilds the cosine logits of normalised features
        self.fused_assignment = _on(cfg.get("fused_assignment"),
                                    fm.get("sim_type", "cosine") == "cosine" and fm.get("normalize_feat", True))
        self.fine_temp = fm.get("temp", 0.1)
        self.encoder = ViTEncoderOneRef(
            npoint=self.fine_npoint,
            vit_type=fe.get("vit_type", "vit_base_patch14_reg4_dinov2"),
            up_type=fe.get("up_type", "linear"),
            embed_dim=fe.get("embed_dim", 768),
            out_dim=fe.get("out_dim", 256),
            use_pyramid_feat=fe.get("use_pyramid_feat", True),
            img_size=fe.get("img_size", 224),
            dtype=backbone_dtype,
            fused_attn=fused_attn,
            int8_gemm=bool(fe.get("int8_gemm", False)),
            freeze_vit=bool(fe.get("freeze_vit", False)),
        )
        sigma_d = ge.get("sigma_d", 0.2)
        self.geo_embed = GeometricStructureEmbedding(
            hidden_dim=ge.get("hidden_dim", 256),
            sigma_d=sigma_d,
            sigma_a=ge.get("sigma_a", 15),
            angle_k=ge.get("angle_k", 3),
            reduction_a=ge.get("reduction_a", "max"),
            # LRF coordinates lie in the unit ball; with the (1, 1, 1) bg point
            # pairwise distances stay below 2 sqrt(3) (5% slack)
            d_index_max=None if self.use_ref_rad else float(2.1 * np.sqrt(3.0) / sigma_d),
            dtype=dtype,
            fused_table=ge.get("fused_table", 0),
            quant_int8=ge.get("quant_int8", False),
        )
        # fine_only has no coarse stage, and its variables no coarse_matching
        self.coarse_matching = None if self.fine_only else CoarsePointMatching(
            nblock=cm.get("nblock", 3),
            input_dim=cm.get("input_dim", 256),
            hidden_dim=cm.get("hidden_dim", 256),
            out_dim=cm.get("out_dim", 256),
            temp=cm.get("temp", 0.1),
            sim_type=cm.get("sim_type", "cosine"),
            normalize_feat=cm.get("normalize_feat", True),
            dtype=dtype,
        )
        self.fine_matching = FinePointMatching(
            nblock=fm.get("nblock", 3),
            input_dim=fm.get("input_dim", 256),
            hidden_dim=fm.get("hidden_dim", 256),
            out_dim=fm.get("out_dim", 256),
            temp=fm.get("temp", 0.1),
            sim_type=fm.get("sim_type", "cosine"),
            normalize_feat=fm.get("normalize_feat", True),
            focusing_factor=fm.get("focusing_factor", 3),
            pe_radius1=fm.get("pe_radius1", 0.1),
            pe_radius2=fm.get("pe_radius2", 0.2),
            nsample1=fm.get("nsample1", 64),
            nsample2=fm.get("nsample2", 256),
            pe_fused=_on(fm.get("pe_fused")),
            pe_neighbor_mode=fm.get("pe_neighbor_mode", "first_k"),
            pe_packed=fm.get("pe_packed", None),
            use_lrf=fm.get("use_lrf", True),
            use_xyz=fm.get("use_xyz", True),
            parity_gather=fm.get("parity_gather", False),
            pe_dtype=resolve_pe_dtype(fm.get("pe_dtype", None)),
            dtype=dtype,
        )

    @classmethod
    def from_config(cls, cfg: Config, dtype: torch.dtype = torch.float32,
                    backbone_dtype: torch.dtype = torch.bfloat16) -> "UNOPose":
        return cls(cfg, dtype, backbone_dtype)

    def _lrf(self, pts: torch.Tensor) -> torch.Tensor:
        if self.use_ref_rad:
            return global_lrf(pts, torch.ones(pts.shape[0], dtype=torch.float32, device=pts.device))
        return global_lrf(pts)

    @torch.no_grad()
    def encode_template(self, tem1_rgb: torch.Tensor, tem1_choose: torch.Tensor,
                        tem1_pts: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The template cache's entries for a batch of references: ``dense_po``
        (B, fine_npoint, 3) in meters, ``dense_fo`` (B, fine_npoint, out_dim)
        float32, ``dense_po_lrf`` (B, fine_npoint, 3) and ``tem1_radius`` (B,).

        As in the forward without the cache, the FPS runs on the cloud divided
        by the full cloud's radius (same indices). ``dense_po`` is gathered in
        meters and divided by the same radius in the forward, and a gather
        commutes with an elementwise division, so the values are bitwise those
        of the uncached path. ``dense_po_lrf`` is rows ``[:fine_npoint]`` of
        the full cloud's LRF, not the sampled rows: the uncached forward
        gathers the sampled indices, all below ``fine_npoint``, from the full
        cloud's LRF (the reference's own quirk)."""
        mean = tem1_pts.mean(dim=1, keepdim=True)
        radius = torch.linalg.vector_norm(tem1_pts - mean, dim=-1).amax(dim=-1)
        r = radius[:, None, None] + 1e-6
        tem_feat = self.encoder.get_img_feats(tem1_rgb, tem1_choose)
        idx = fps((tem1_pts / r).float(), self.fine_npoint)
        return dict(
            dense_po=gather_points(tem1_pts, idx),
            dense_fo=gather_points(tem_feat.float(), idx),
            dense_po_lrf=self._lrf(tem1_pts)[:, : self.fine_npoint],
            tem1_radius=radius,
        )

    def forward(
        self,
        inputs: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[torch.Tensor] = None,
        return_intermediates: bool = False,
        train: bool = False,
        pose_noise: Optional[PoseNoiseDraws] = None,
    ) -> Dict[str, torch.Tensor]:
        """inputs: rgb (B, H, W, 3), rgb_choose (B, P1), pts (B, P1, 3),
        tem1_rgb, tem1_choose (B, P2), tem1_pts (B, P2, 3), or in their place
        ``encode_template``'s four outputs; in training also rotation_label
        (B, 3, 3) and translation_label (B, 3).

        Inference (no autograd): the coarse search draws (B, 3 * nproposal1)
        uniforms from ``generator``, or uses ``uniforms``. Returns the pose
        keys (``POSE_KEYS``), plus every intermediate with
        ``return_intermediates``. Training: see ``forward_train``.
        """
        if train:
            return self.forward_train(inputs, pose_noise, generator)
        with torch.no_grad():
            return self._infer(inputs, generator, uniforms, return_intermediates)

    def _encode(self, inputs, train: bool):
        """Features, both clouds' FPS nodes and their geometric embeddings."""
        dense_pm, dense_fm, dense_po, dense_fo, radius = self.encoder(
            inputs["rgb"], inputs["rgb_choose"], inputs["pts"],
            inputs.get("tem1_rgb"), inputs.get("tem1_choose"), inputs.get("tem1_pts"),
            inputs.get("dense_po"), inputs.get("dense_fo"), inputs.get("tem1_radius"), train=train,
        )
        dense_fm = dense_fm.to(self.dtype)
        dense_fo = dense_fo.to(self.dtype)
        # LRFs of the raw clouds; the template's rows < fine_npoint are the
        # ones the FPS indices reach (the reference's own quirk), which the
        # template cache hands in as dense_po_lrf
        dense_pm_lrf = self._lrf(inputs["pts"])
        if inputs.get("dense_po_lrf") is not None:
            dense_po_lrf = inputs["dense_po_lrf"]
        elif inputs.get("tem1_pts") is not None:
            dense_po_lrf = self._lrf(inputs["tem1_pts"])
        else:
            dense_po_lrf = self._lrf(dense_po)
        B = dense_pm.shape[0]
        sparse_pm, sparse_pm_lrf, sparse_fm, fps_idx_m = sample_pts_feats_wlrf(
            dense_pm, dense_pm_lrf, dense_fm, self.coarse_npoint
        )
        sparse_po, sparse_po_lrf, sparse_fo, fps_idx_o = sample_pts_feats_wlrf(
            dense_po, dense_po_lrf, dense_fo, self.coarse_npoint
        )
        bg_point = torch.ones((B, 1, 3), dtype=torch.float32, device=dense_pm.device)
        geo_both = self.geo_embed(
            torch.cat([torch.cat([bg_point, sparse_pm_lrf], dim=1), torch.cat([bg_point, sparse_po_lrf], dim=1)], dim=0),
            train=train,
        )
        return dict(
            dense_pm=dense_pm, dense_fm=dense_fm, dense_po=dense_po, dense_fo=dense_fo, radius=radius,
            sparse_pm=sparse_pm, sparse_fm=sparse_fm, fps_idx_m=fps_idx_m,
            sparse_po=sparse_po, sparse_fo=sparse_fo, fps_idx_o=fps_idx_o, geo=geo_both,
        )

    def forward_train(self, inputs: Dict[str, torch.Tensor], pose_noise: Optional[PoseNoiseDraws] = None,
                      generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The network pass of a training step, on autograd: every block's
        coarse and fine outputs (``coarse_attens``, ``coarse_scores``,
        ``coarse_saliencies``, likewise ``fine_*``), the clouds, the radius
        and the noisy initial pose. The noise's draws are ``pose_noise``, or
        drawn from ``generator``. ``fine_only``: no coarse outputs, and the
        fine stage starts at the identity pose."""
        e = self._encode(inputs, train=True)
        B = e["dense_pm"].shape[0]
        geo_m, geo_o = e["geo"][:B], e["geo"][B:]
        radius = e["radius"]
        out = dict(radius=radius, dense_pm=e["dense_pm"], dense_po=e["dense_po"], sparse_pm=e["sparse_pm"],
                   sparse_po=e["sparse_po"])
        if self.fine_only:
            init_R, init_t = self._identity_pose(B, radius.device)
        else:
            c_attens, c_scores, c_sals = self.coarse_matching(e["sparse_fm"], geo_m, e["sparse_fo"], geo_o,
                                                              all_blocks=True)
            out.update(coarse_attens=c_attens, coarse_scores=c_scores, coarse_saliencies=c_sals)
            gt_r = inputs["rotation_label"].float()
            gt_t = inputs["translation_label"].float() / (radius[:, None] + 1e-6)
            if pose_noise is None:
                pose_noise = PoseNoiseDraws.draw(B, generator, device=gt_r.device)
            init_R, init_t = aug_pose_noise(gt_r, gt_t, pose_noise)
        f_attens, f_scores, f_sals = self.fine_matching(
            e["dense_pm"], e["dense_fm"], geo_m, e["fps_idx_m"], e["dense_po"], e["dense_fo"], geo_o, e["fps_idx_o"],
            init_R, init_t, train=True,
        )
        out.update(init_R=init_R, init_t=init_t, fine_attens=f_attens, fine_scores=f_scores, fine_saliencies=f_sals)
        return out

    @staticmethod
    def _identity_pose(B: int, device) -> tuple:
        """fine_only's initial pose: (B, 3, 3) identities and (B, 3) zeros."""
        eye = torch.eye(3, dtype=torch.float32, device=device).expand(B, 3, 3).contiguous()
        return eye, torch.zeros((B, 3), dtype=torch.float32, device=device)

    def _infer(self, inputs, generator, uniforms, return_intermediates: bool) -> Dict[str, torch.Tensor]:
        e = self._encode(inputs, train=False)
        dense_pm, dense_fm, dense_po, dense_fo, radius = (e[k] for k in ("dense_pm", "dense_fm", "dense_po",
                                                                         "dense_fo", "radius"))
        sparse_pm, sparse_fm, fps_idx_m = e["sparse_pm"], e["sparse_fm"], e["fps_idx_m"]
        sparse_po, sparse_fo, fps_idx_o = e["sparse_po"], e["sparse_fo"], e["fps_idx_o"]
        geo_both = e["geo"]
        B = dense_pm.shape[0]
        if isinstance(geo_both, tuple):
            # int8 embedding: one scale for both clouds. The codes go to the
            # model dtype once and serve all six RPE layers; int8 values are
            # exact in bf16 and float32, so this is numerically identical to
            # the JAX package's convert fused into each layer's einsum.
            codes, esc = geo_both
            codes = codes.to(self.dtype)
            geo_m, geo_o = (codes[:B], esc), (codes[B:], esc)
        else:
            geo_m, geo_o = geo_both[:B], geo_both[B:]

        out = dict(radius=radius)
        inter = dict(dense_pm=dense_pm, dense_po=dense_po, dense_fm=dense_fm, dense_fo=dense_fo, sparse_pm=sparse_pm,
                     sparse_po=sparse_po, fps_idx_m=fps_idx_m, fps_idx_o=fps_idx_o, geo=geo_both)
        if self.fine_only:
            init_R, init_t = self._identity_pose(B, radius.device)
        else:
            c_atten, c_score = self.coarse_matching(sparse_fm, geo_m, sparse_fo, geo_o)
            init_R, init_t, init_score = compute_coarse_Rt_overlap(
                c_atten, c_score, sparse_pm, sparse_po, self.nproposal1, self.nproposal2,
                uniforms=uniforms, generator=generator,
            )
            out["init_pose_score"] = init_score
            inter.update(coarse_atten=c_atten, coarse_score=c_score)
        out.update(init_R=init_R, init_t=init_t)
        if self.test_coarse_only:
            out.update(pred_R=init_R, pred_t=init_t * (radius[:, None] + 1e-6), pred_pose_score=init_score)
            return {**out, **inter} if return_intermediates else out
        f_atten, f_score = self.fine_matching(
            dense_pm, dense_fm, geo_m, fps_idx_m, dense_po, dense_fo, geo_o, fps_idx_o, init_R, init_t,
            return_proj=self.fused_assignment,
        )
        if self.fused_assignment:
            pred_R, pred_t, pred_score, max_w = compute_fine_Rt_overlap_fused(
                *f_atten, f_score, dense_pm, dense_po, temp=self.fine_temp
            )
        else:
            pred_R, pred_t, pred_score, max_w = compute_fine_Rt_overlap(f_atten, f_score, dense_pm, dense_po)
        out.update(pred_R=pred_R, pred_t=pred_t * (radius[:, None] + 1e-6), pred_pose_score=pred_score,
                   fine_wsvd_max_w=max_w)
        if return_intermediates:
            out.update(inter, fine_score=f_score, **{"fine_proj" if self.fused_assignment else "fine_atten": f_atten})
        return out


def compute_train_losses(outputs: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor], cfg: Config) -> Dict[str, torch.Tensor]:
    """Per-sample loss terms of both stages from ``UNOPose.forward_train``'s
    outputs (the fine stage's alone where they hold no coarse outputs: the
    ``fine_only`` model); ``cfg`` is the model section of the configuration."""
    radius = outputs["radius"]
    gt_r = inputs["rotation_label"].float()
    gt_t = inputs["translation_label"].float() / (radius[:, None] + 1e-6)
    terms = {}
    stages = (("coarse", ("sparse_pm", "sparse_po")), ("fine", ("dense_pm", "dense_po")))
    for stage, pts in stages[0 if "coarse_attens" in outputs else 1:]:
        m = cfg[f"{stage}_point_matching"]
        terms.update(compute_overlap_loss(
            outputs[f"{stage}_attens"], outputs[f"{stage}_scores"], outputs[f"{stage}_saliencies"],
            outputs[pts[0]], outputs[pts[1]], gt_r, gt_t,
            predator_thres=m.get("loss_predator_thres", 0.15), dis_thres=m.get("loss_dis_thres", 0.3),
            loss_str="coarse_hard" if stage == "coarse" else "fine",
        ))
    return terms
