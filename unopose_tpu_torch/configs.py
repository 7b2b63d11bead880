"""What the port runs: the model configurations and their synthetic inputs.

``slice_config()`` is the model section of the JAX package's
``configs/main_cfg.py:get_cfg()`` with the four switches that keep the
inference path off the TPU-only kernels, and ``use_ref_rad=False``:

- ``feature_extraction.fused_attn=False``: XLA attention (no int8 GEMMs,
  exact-erf GELU);
- ``geo_embedding.fused_table=0``: the exact sinusoid embedding;
- ``fine_point_matching.pe_fused=False``: the packed first_k PE with the
  plain MLP;
- ``fused_assignment=False``: the materialised fine solver.

``fused_matcher_config()`` turns the fused geometric embedding and the fused
PE back on, as in production. ``production_config()`` is ``get_cfg()``'s
model section with no switch: ``fused_attn``, ``pe_fused`` and
``fused_assignment`` are left out, which in the port means "on" (the JAX
package's ``None``, "on for TPU inference"), so the ViT runs ``mha_fused``
with the W8A8 ``DenseQ`` GEMMs (``int8_gemm=True``) and tanh-GELU, and the
fine solver runs the three ``fine_assignment_fused`` sweeps.
``subset_config()`` and ``firstk_unpacked_config()`` are ``production_config()``
with one key of the fine PE switched: ``pe_neighbor_mode="subset"``, or
``pe_packed=False``.

``eval_config()`` is the evaluation entry point's whole configuration
(``main_unopose.py --eval-only``): ``production_config()`` as its model
section, and ``get_cfg()``'s misc, test, test data loader and BOP
evaluation sections.

The values are written out here so that the port never imports the JAX
package; ``tests/test_torch_package.py``, ``tests/test_torch_fused.py``,
``tests/test_torch_production.py`` and ``tests/test_torch_eval_model.py``
hold them equal to ``get_cfg()`` (and ``get_tiny_cfg``) with the switches
applied. Only the keys the port reads are kept: the training data and
checkpoint settings stay in the JAX package.
"""

from __future__ import annotations

import ast
import os.path as osp
from typing import Iterable

import numpy as np

from unopose_tpu_torch.ops.rotation import random_rotation_np

PROJ_ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
# image side, query points, template points of one pair
FULL_SIZES = dict(img=224, npts=2048, ntem=5000)
# the tiny config of the CPU tests: the packed first_k PE still engages
# (256 points hold the 256-slot scale-2 budget)
TINY_SIZES = dict(img=28, npts=256, ntem=384)
# the tiny subset config's clouds: at the budgets 64/256 a slot has G = 8 and 2 candidates (1 at 256 points)
SUBSET_TINY_NPTS = 512


class Config(dict):
    """A dict with attribute access; nested dicts become Configs."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        for k, v in {**(d or {}), **kwargs}.items():
            self[k] = Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def apply_overrides(self, overrides: Iterable[str]) -> "Config":
        """Dotted ``key=value`` overrides (the launcher's command line): the
        value is read with ``ast.literal_eval`` where it parses, else kept as
        a string; missing sections are created."""
        for ov in overrides:
            key, _, raw = ov.partition("=")
            try:
                val = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                val = raw
            node = self
            parts = key.strip().split(".")
            for p in parts[:-1]:
                if not isinstance(node.get(p), Config):
                    node[p] = Config()
                node = node[p]
            node[parts[-1]] = Config(val) if isinstance(val, dict) else val
        return self

    def flatten(self, prefix: str = "") -> dict:
        out = {}
        for k, v in self.items():
            kk = f"{prefix}.{k}" if prefix else str(k)
            out.update(v.flatten(kk) if isinstance(v, Config) else {kk: v})
        return out


def slice_config(tiny: bool = False) -> Config:
    """The model config of the slice: full width (ViT-B/14-reg4 at 224 px,
    2048-point clouds, 196 coarse nodes, 6000/300 hypotheses), or with
    ``tiny`` the CPU tests' ``get_tiny_cfg(img_size=28, n_pts=256,
    coarse_npoint=16, n_tem=384)`` with the production PE budgets 64/256."""
    cfg = Config(
        coarse_npoint=196,
        fine_npoint=FULL_SIZES["npts"],
        use_ref_rad=False,
        fused_assignment=False,
        feature_extraction=dict(
            vit_type="vit_base_patch14_reg4_dinov2", up_type="linear", embed_dim=768, out_dim=256,
            use_pyramid_feat=True, img_size=FULL_SIZES["img"], fused_attn=False,
            int8_gemm=True,  # get_cfg()'s value; read only with fused_attn
        ),
        geo_embedding=dict(
            sigma_d=0.2, sigma_a=15, angle_k=3, reduction_a="max", hidden_dim=256, fused_table=0,
            quant_int8=True,  # get_cfg()'s value; read only by the fused embedding
        ),
        coarse_point_matching=dict(
            nblock=3, input_dim=256, hidden_dim=256, out_dim=256, temp=0.1, sim_type="cosine",
            normalize_feat=True, nproposal1=6000, nproposal2=300,
        ),
        fine_point_matching=dict(
            nblock=3, input_dim=256, hidden_dim=256, out_dim=256, pe_radius1=0.1, pe_radius2=0.2,
            focusing_factor=3, temp=0.1, sim_type="cosine", normalize_feat=True, use_lrf=True, use_xyz=True,
            nsample1=64, nsample2=256, pe_neighbor_mode="first_k", pe_fused=False,
        ),
    )
    if tiny:
        cfg.coarse_npoint = 16
        cfg.fine_npoint = TINY_SIZES["npts"]
        cfg.feature_extraction.update(vit_type="vit_tiny_test", embed_dim=32, out_dim=32, img_size=TINY_SIZES["img"])
        cfg.geo_embedding.hidden_dim = 32
        for k in ("coarse_point_matching", "fine_point_matching"):
            cfg[k].update(input_dim=32, hidden_dim=32, out_dim=32)
        cfg.coarse_point_matching.update(nproposal1=100, nproposal2=20)
    return cfg


def fused_matcher_config(tiny: bool = False) -> Config:
    """``slice_config(tiny)`` with the fused matchers of the production config
    on: the fused int8 geometric embedding (``geo_embedding.fused_table=128``,
    ``quant_int8=True``, kernel ``geo_rpe``) and the fused PE-v5
    (``fine_point_matching.pe_fused=True``, kernels ``pe_channels`` and
    ``pe_mlp_pool``). That is ``get_cfg()`` with only ``fused_attn=False``
    and ``fused_assignment=False``."""
    cfg = slice_config(tiny)
    cfg.geo_embedding.update(fused_table=128, quant_int8=True)
    cfg.fine_point_matching.pe_fused = True
    return cfg


def production_config(tiny: bool = False) -> Config:
    """``get_cfg()``'s model section with no switch (``use_ref_rad=False``
    as in the other two): ``fused_matcher_config(tiny)`` without its
    ``fused_attn``, ``pe_fused`` and ``fused_assignment`` keys, so all three
    take their "on" default."""
    cfg = fused_matcher_config(tiny)
    del cfg.feature_extraction["fused_attn"], cfg.fine_point_matching["pe_fused"], cfg["fused_assignment"]
    return cfg


def subset_config(tiny: bool = False) -> Config:
    """``production_config(tiny)`` with ``fine_point_matching.pe_neighbor_mode
    = "subset"``: both PE scales group by the subset mode (kernel
    ``ball_group_subset``) and run the masked PE (kernel ``pe_masked``).
    With ``tiny`` the clouds hold ``SUBSET_TINY_NPTS`` points (the JAX
    package's ``get_tiny_cfg(n_pts=512, n_tem=768)``)."""
    cfg = production_config(tiny)
    cfg.fine_point_matching.pe_neighbor_mode = "subset"
    if tiny:
        cfg.fine_npoint = SUBSET_TINY_NPTS
    return cfg


def firstk_unpacked_config(tiny: bool = False) -> Config:
    """``production_config(tiny)`` with ``fine_point_matching.pe_packed=False``:
    the unpacked first_k grouping (kernels ``first_k_select`` and
    ``gather_planar``) and the masked PE with all-ones masks (``pe_masked``)."""
    cfg = production_config(tiny)
    cfg.fine_point_matching.pe_packed = False
    return cfg


def production_s768_config(tiny: bool = False) -> Config:
    """``production_config(tiny)`` with ``fine_point_matching.nsample2=768``:
    a scale-2 budget the JAX package's gates admit (a multiple of 256 up to
    N) and PE-v5 does not take, so the fine PE runs the point-major packed
    layout (``pe_packed``), past one 512-slot window on its full blocks."""
    cfg = production_config(tiny)
    cfg.fine_point_matching.nsample2 = 768
    return cfg


# configs/main_cfg.py's schedule length: 3 epochs of the 2,008,971 training images at 8 per rank on 4 ranks
TRAIN_BATCH = 8
MAX_ITER = (2008971 // (TRAIN_BATCH * 4)) * 3


def train_config(tiny: bool = False) -> Config:
    """The training step's configuration: the model section is
    ``production_config(tiny)`` with ``freeze_vit``, and the train settings
    the step reads are ``get_cfg()``'s: Adam lr 1e-4, betas (0.5, 0.999),
    eps 1e-6, no weight decay, the flat-and-anneal schedule (linear warmup
    from 0.001 over 1000 iterations, cosine anneal to 0 from there), no
    gradient clipping, no model EMA, batch ``TRAIN_BATCH`` per card.

    ``pe_fused`` is left out, as in ``production_config``: in the port None
    means on, and in training that is the PE train kernels
    (``ops/pe_train.py``, K11-K14); the JAX package's None means its XLA
    formulation in training. Both compute the same function. The other
    auto switches follow the JAX package's train gates (see
    ``models/unopose.py``)."""
    model = production_config(tiny)
    model.feature_extraction.freeze_vit = True
    return Config(
        model=model,
        optimizer=dict(type="adam", lr=1e-4, betas=(0.5, 0.999), weight_decay=0.0, eps=1e-6),
        lr_multiplier=dict(
            warmup_method="linear", warmup_factor=0.001, warmup_iters=1000, total_iters=MAX_ITER,
            anneal_point=min(1000 / MAX_ITER, 1.0), anneal_method="cosine", target_lr_factor=0.0,
        ),
        train=dict(max_iter=MAX_ITER, clip_grad=dict(enabled=False, params=dict(max_norm=35, norm_type=2)), seed=1),
        batch_size=TRAIN_BATCH,
    )


def eval_config(tiny: bool = False) -> Config:
    """The evaluation entry point's configuration: ``model`` is
    ``production_config(tiny)``, and ``misc``, ``test``, ``dataloader.test``
    and ``bop_eval`` hold the keys of ``get_cfg()``'s that the launcher and
    the test reader read, at its values (the template cache on, 16
    instances a chunk, the YCB-V test set with the SAM detections and the
    cross-scene rot50 references under ``datasets/``). With ``tiny`` the
    test loader's crop side and point counts are the tiny model's, as
    ``get_tiny_cfg`` sets the train loader's. The launcher reads the two
    dtypes from a ``train`` section as the JAX launcher does (backbone
    bfloat16, matchers float32 when it is absent)."""
    sizes = TINY_SIZES if tiny else FULL_SIZES
    return Config(
        model=production_config(tiny),
        misc=dict(output_dir=osp.join(PROJ_ROOT, "output/main_cfg"), load_from="", exp_name="Pfoneref50"),
        test=dict(instance_batch_size=16, template_cache=True),
        dataloader=dict(test=dict(
            data_dir=osp.join(PROJ_ROOT, "datasets/BOP_DATASETS"),
            ref_targets_name="test_ref_targets_crossscene_rot50.json",
            img_size=sizes["img"], n_sample_observed_point=sizes["npts"], n_sample_template_point=sizes["ntem"],
            minimum_n_point=8, rgb_mask_flag=True, seg_filter_score=0.25, rgb_to_bgr=False, eval_dataset_name="ycbv",
            detection_path=osp.join(
                PROJ_ROOT,
                "datasets/segmentation/CustomSamAutomaticMaskGenerator_test_oneref_targets_crossscene_rot50_refvisib_ycbv.json",
            ),
        )),
        bop_eval=dict(split="test"),
    )


# the configurations by the name chip_smoke.py and tools/profile_slice.py give them
CONFIGS = {"slice": slice_config, "fused_matchers": fused_matcher_config, "production": production_config,
           "subset": subset_config, "firstk_unpacked": firstk_unpacked_config}


def surface_clouds(rng: np.random.Generator, batch: int, perm: np.ndarray) -> np.ndarray:
    """(batch, 2048, 3) float32 clouds on four spheres of 512 points each,
    for the fused PE's kernel checks: unlike the uniform clouds of
    ``synthetic_inputs`` their neighbourhoods are 2-D surfaces, as on depth
    maps, and the spheres' radii put each sphere's points in a different
    64-slot tier of the 0.2 m scale (~40, ~96, ~160 and ~216 hits, from
    n r^2 / (4 R^2) on a sphere). Each sphere is a Fibonacci lattice, turned
    at random, jittered tangentially by 1/5 of its spacing and radially by
    0.5 mm. ``perm`` is the PE's candidate permutation
    (``ops/ball_query.py:permutation``): lattice point k of a sphere is put
    in permuted chunk k % 4, so that every neighbourhood's hits spread evenly
    over the four 64-hit chunk budgets and the packed grouping never
    overflows."""
    n_sphere, r2 = 512, 0.2
    hits = np.array([40.0, 96.0, 160.0, 216.0])
    radii = r2 * np.sqrt(n_sphere / (4.0 * hits))
    centres = np.array([[-0.6, -0.6, 0.6], [0.6, -0.6, 0.6], [-0.6, 0.6, 0.6], [0.6, 0.6, 0.6]])
    k = np.arange(n_sphere)
    z = 1.0 - (2.0 * k + 1.0) / n_sphere
    phi = k * np.pi * (3.0 - np.sqrt(5.0))
    unit = np.stack([np.sqrt(1.0 - z * z) * np.cos(phi), np.sqrt(1.0 - z * z) * np.sin(phi), z], axis=-1)
    chunk, quarter = k % 4, n_sphere // 4
    out = np.empty((batch, 4 * n_sphere, 3), np.float32)
    for b in range(batch):
        for s, (R, c) in enumerate(zip(radii, centres)):
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            u = unit @ q.T + rng.normal(scale=0.2 * np.sqrt(4.0 * np.pi / n_sphere), size=unit.shape)
            u /= np.linalg.norm(u, axis=-1, keepdims=True)
            p = c + u * (R + rng.normal(scale=5e-4, size=(n_sphere, 1)))
            # permuted position of lattice point k: chunk k % 4, sphere s's quarter of that chunk
            out[b, perm[chunk * 4 * quarter + s * quarter + k // 4]] = p
    return out


def synthetic_inputs(rng: np.random.Generator, batch: int, tiny: bool = False, npts: int | None = None) -> dict:
    """A batch built like the bench's: random crops in [-1, 1], random pixel
    choices, uniform clouds in a 0.2 m cube 0.6 m from the camera. numpy
    arrays: rgb / tem1_rgb (B, H, W, 3) float32, rgb_choose (B, P1) and
    tem1_choose (B, P2) int32, pts (B, P1, 3) and tem1_pts (B, P2, 3) float32.
    ``npts`` sets P1 in place of the sizes' (a config's ``fine_npoint``),
    with P2 kept at the sizes' P2 / P1 ratio."""
    sizes = TINY_SIZES if tiny else FULL_SIZES
    npts = sizes["npts"] if npts is None else npts
    img, ntem = sizes["img"], sizes["ntem"] * npts // sizes["npts"]
    offset = np.array([0, 0, 0.6], np.float32)
    return dict(
        rgb=rng.uniform(-1, 1, size=(batch, img, img, 3)).astype(np.float32),
        rgb_choose=rng.integers(0, img * img, size=(batch, npts)).astype(np.int32),
        pts=rng.uniform(-0.1, 0.1, size=(batch, npts, 3)).astype(np.float32) + offset,
        tem1_rgb=rng.uniform(-1, 1, size=(batch, img, img, 3)).astype(np.float32),
        tem1_choose=rng.integers(0, img * img, size=(batch, ntem)).astype(np.int32),
        tem1_pts=rng.uniform(-0.1, 0.1, size=(batch, ntem, 3)).astype(np.float32) + offset,
    )


def synthetic_train_inputs(rng: np.random.Generator, batch: int, tiny: bool = False) -> dict:
    """A training batch built like the JAX package's ``synthetic_train_iter``
    (``data/loader.py``), draw for draw: random crops in [-1, 1], a template
    cloud uniform in a 0.16 m cube 0.6 m away, and the observed cloud the
    template's points under a random rotation and a translation near
    (0, 0, 0.55) m, plus 2 mm of noise; ``rotation_label`` (B, 3, 3) and
    ``translation_label`` (B, 3) are that pose. numpy arrays."""
    sizes = TINY_SIZES if tiny else FULL_SIZES
    img, npts, ntem = sizes["img"], sizes["npts"], sizes["ntem"]
    B = batch
    rgb = rng.uniform(-1, 1, size=(B, img, img, 3)).astype(np.float32)
    tem_rgb = rng.uniform(-1, 1, size=(B, img, img, 3)).astype(np.float32)
    tem_pts = rng.uniform(-0.08, 0.08, size=(B, ntem, 3)).astype(np.float32)
    tem_pts[..., 2] += 0.6
    R = np.stack([random_rotation_np(rng) for _ in range(B)])
    t = rng.uniform(-0.02, 0.02, size=(B, 3)).astype(np.float32)
    t[:, 2] += 0.55
    sel = rng.integers(0, ntem, size=(B, npts))
    pts = np.einsum("bij,bnj->bni", R, np.take_along_axis(tem_pts, sel[..., None], axis=1)) + t[:, None]
    pts = (pts + 0.002 * rng.standard_normal((B, npts, 3))).astype(np.float32)
    return dict(
        rgb=rgb,
        rgb_choose=rng.integers(0, img * img, size=(B, npts)).astype(np.int32),
        pts=pts,
        tem1_rgb=tem_rgb,
        tem1_choose=rng.integers(0, img * img, size=(B, ntem)).astype(np.int32),
        tem1_pts=tem_pts,
        rotation_label=R.astype(np.float32),
        translation_label=t,
    )


def pe_train_chans(rng: np.random.Generator, dev, b: int, p: int, s: int):
    """(b, 6, p, s) float32 PE channels on ``dev`` whose first third of
    slots per point holds distinct values and the rest duplicate slot 0, as
    the grouping's pads duplicate the first hit (so the max pool has ties to
    split): the train PE kernels' inputs in ``chip_smoke.py`` and
    ``tools/kernel_variants.py``."""
    import torch

    chans = torch.from_numpy(rng.standard_normal((b, 6, p, s)).astype(np.float32) * 0.3).to(dev)
    chans[..., s // 3:] = chans[..., :1]
    return chans.contiguous()


def pe_train_weights(dev, seed: int):
    """He-normal Ws, gammas near 1 and betas near 0 of one train PE scale
    (6 -> 32 -> 64 -> 128), seeded, on ``dev``."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    dims = (6, 32, 64, 128)
    Ws = [(torch.randn(a, b, generator=gen) * (2.0 / a) ** 0.5).to(dev) for a, b in zip(dims[:-1], dims[1:])]
    gammas = [(1.0 + 0.1 * torch.randn(d, generator=gen)).to(dev) for d in dims[1:]]
    betas = [(0.1 * torch.randn(d, generator=gen)).to(dev) for d in dims[1:]]
    return Ws, gammas, betas
