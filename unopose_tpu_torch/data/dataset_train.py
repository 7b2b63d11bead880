"""The training reader: MegaPose GSO + ShapeNetCore ``train_pbr_web`` shards
(counterpart of ``unopose_tpu/data/dataset_train.py``).

Per sample: a random valid instance of the epoch's image; its gt and
camera jsons, its visible mask (cross-dilated 4 times half the time),
the square crop, the backprojected depth with the points beyond 1.2x the
reference's radius dropped, 2048 observed points; a random reference frame
of the same object from the visib > 0.8 lists and its 5000-point cloud;
both crops colour-augmented (p 0.8), masked, resized to 224 and
ImageNet-normalised, channels last; the reference cloud turned by a random
rotation composed into the relative-pose label, the observed cloud shifted
by up to ``shift_range`` and jittered by 1 mm.

Every draw comes from the reader's ``np.random.Generator`` (seeded by the
caller), in the JAX package's order: the same files and seed give the same
samples.
"""

from __future__ import annotations

import logging
import os.path as osp
from typing import Dict, Optional

import numpy as np

from unopose_tpu_torch.data.color_aug import ColorAugmentor
from unopose_tpu_torch.data.preprocess import (
    backproject_np,
    dilate_mask,
    get_bbox,
    get_resize_rgb_choose,
    io_load_gt,
    io_load_masks,
    load_im,
    load_json,
    normalize_rgb,
    resize_linear,
    sample_choose,
)
from unopose_tpu_torch.ops.rotation import random_rotation_np

logger = logging.getLogger(__name__)

# the two shard trees under data_dir, and their reference lists and valid instances
DATA_PATHS = (osp.join("MegaPose-GSO", "train_pbr_web"), osp.join("MegaPose-ShapeNetCore", "train_pbr_web"))
TEMPLATES = {"GSO": "megapose_gso_fixed_obj_id_to_visib0_8_scene_im_inst_ids.json",
             "ShapeNetCore": "megapose_shapenetcore_fixed_obj_id_to_visib0_8_scene_im_inst_ids.json"}
VALID = {"GSO": "megapose_gso_fixed_valid_inst_ids.json",
         "ShapeNetCore": "megapose_shapenetcore_fixed_valid_inst_ids.json"}
FILES = (".camera.json", ".depth.png", ".gt.json", ".mask_visib.json", ".rgb.jpg")


class DatasetPoseFreeOneRef:
    """``len`` images an epoch (``num_img_per_epoch``, or every image with
    -1), resampled by ``reset()``; ``ds[i]`` reads epoch entry ``i`` and, where
    that image yields no sample, random entries until one does."""

    def __init__(self, cfg, num_img_per_epoch: int = -1, seed: int = 0):
        self.cfg = cfg
        self.data_dir = cfg.data_dir
        self.num_img_per_epoch = num_img_per_epoch
        self.dilate = cfg.get("dilate_mask", True)
        self.rgb_mask_flag = cfg.get("rgb_mask_flag", True)
        self.shift_range = cfg.get("shift_range", 0.01)
        self.img_size = cfg.get("img_size", 224)
        self.n_sample_observed_point = cfg.get("n_sample_observed_point", 2048)
        self.n_sample_template_point = cfg.get("n_sample_template_point", 5000)
        self.rgb_to_bgr = cfg.get("rgb_to_bgr", False)
        self.rng = np.random.default_rng(seed)

        self.dataset_paths = []
        for f in DATA_PATHS:
            key_json = osp.join(self.data_dir, f, "key_to_shard.json")
            if not osp.exists(key_json):
                continue
            key_shards = load_json(key_json)
            for k in key_shards:
                self.dataset_paths.append(osp.join(f, f"{key_shards[k]:06d}", k))
        self.length = len(self.dataset_paths)
        logger.info("Total %d images", self.length)

        def _maybe(name):
            path = osp.join(self.data_dir, name)
            return load_json(path) if osp.exists(path) else {}

        self.templates_infos = {k: _maybe(v) for k, v in TEMPLATES.items()}
        self.valid_insts = {k: _maybe(v) for k, v in VALID.items()}
        self.color_augmentor = ColorAugmentor()
        self.img_idx: Optional[np.ndarray] = None
        self.reset()

    def __len__(self):
        return self.length if self.num_img_per_epoch == -1 else self.num_img_per_epoch

    def reset(self):
        """Resample this epoch's image index list: every image once in a
        random order where the epoch holds fewer, else with replacement."""
        n_epoch = len(self)
        if self.length == 0:
            self.img_idx = np.zeros(0, np.int64)
        elif self.length <= n_epoch:
            self.img_idx = self.rng.choice(self.length, n_epoch)
        else:
            self.img_idx = self.rng.choice(self.length, n_epoch, replace=False)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        while True:
            out = self.read_data(int(self.img_idx[index]))
            if out is not None:
                return out
            index = int(self.rng.integers(0, len(self)))

    def read_data(self, index: int) -> Optional[Dict[str, np.ndarray]]:
        """One sample of image ``index``, or None where a file is missing, the
        image has no valid instance, the object no reference, the mask is
        empty or fewer than 32 points are left."""
        path_head = self.dataset_paths[index]
        dataset_type = path_head.split("/")[0][len("MegaPose-"):]
        full_head = osp.join(self.data_dir, path_head)
        if not all(osp.exists(full_head + suffix) for suffix in FILES):
            return None

        shard_name, key_name = path_head.split("/")[-2:]
        valid_idx = self.valid_insts[dataset_type].get(f"{shard_name}/{key_name}", [])
        if len(valid_idx) == 0:
            return None
        inst = int(valid_idx[self.rng.integers(0, len(valid_idx))])

        gt = io_load_gt(full_head + ".gt.json")[inst]
        tem_list = self.templates_infos[dataset_type].get(str(gt["obj_id"]), [])
        if not tem_list:
            return None
        pose_camtgt_obj = _pose(gt)

        camera = load_json(full_head + ".camera.json")
        K = np.asarray(camera["cam_K"], np.float32).reshape(3, 3)

        tem = self._get_template(dataset_type, tem_list)
        if tem is None:
            return None
        tem1_rgb, tem1_choose, tem1_pts, pose_camtem1_obj = tem

        pose_tgt_tem1 = pose_camtgt_obj @ np.linalg.inv(pose_camtem1_obj)
        tem1_pts_minus_mean = tem1_pts - tem1_pts.mean(0, keepdims=True)

        mask = io_load_masks(full_head + ".mask_visib.json")[inst]
        if mask.sum() == 0:
            return None
        if self.dilate and self.rng.random() < 0.5:
            mask = dilate_mask(mask)
        bbox = get_bbox(mask > 0)
        y1, y2, x1, x2 = bbox
        mask = mask[y1:y2, x1:x2]
        if mask.sum() == 0:
            return None
        choose = mask.astype(np.float32).flatten().nonzero()[0]

        depth = load_im(full_head + ".depth.png").astype(np.float32) * camera["depth_scale"] / 1000.0
        pts = backproject_np(depth, K, bbox).reshape(-1, 3)[choose]

        radius = np.linalg.norm(tem1_pts_minus_mean, axis=1).max()
        flag = np.linalg.norm(pts - pts.mean(0, keepdims=True), axis=1) < 1.2 * radius
        pts, choose = pts[flag], choose[flag]
        if len(choose) < 32:
            return None
        sel = sample_choose(self.rng, len(choose), self.n_sample_observed_point)
        choose, pts = choose[sel], pts[sel]

        rgb = self._crop_rgb(full_head, bbox, mask)
        rgb_choose = get_resize_rgb_choose(choose, bbox, self.img_size)

        # the reference cloud under a random rotation, composed into the label
        rand_pose = np.eye(4, dtype=np.float32)
        rand_pose[:3, :3] = random_rotation_np(self.rng)
        tem1_pts = tem1_pts @ rand_pose[:3, :3]
        target_pose = pose_tgt_tem1 @ rand_pose
        add_t = self.rng.uniform(-self.shift_range, self.shift_range, (1, 3))
        target_t = target_pose[:3, 3] + add_t[0]
        pts = pts + add_t + 0.001 * self.rng.standard_normal((pts.shape[0], 3))

        return dict(
            pts=pts.astype(np.float32),
            rgb=rgb.astype(np.float32),
            rgb_choose=rgb_choose.astype(np.int32),
            translation_label=target_t.astype(np.float32),
            rotation_label=target_pose[:3, :3].astype(np.float32),
            tem1_rgb=tem1_rgb.astype(np.float32),
            tem1_choose=tem1_choose.astype(np.int32),
            tem1_pts=tem1_pts.astype(np.float32),
            K=K,
        )

    def _crop_rgb(self, head: str, bbox, mask: np.ndarray) -> np.ndarray:
        """The image's square crop, colour-augmented with p 0.8, masked, resized and normalised."""
        y1, y2, x1, x2 = bbox
        rgb = load_im(head + ".rgb.jpg").astype(np.uint8)
        if self.rgb_to_bgr:
            rgb = rgb[..., ::-1]
        rgb = rgb[y1:y2, x1:x2, :]
        if self.rng.random() < 0.8:
            rgb = self.color_augmentor(self.rng, rgb)
        if self.rgb_mask_flag:
            rgb = rgb * (mask[:, :, None] > 0).astype(np.uint8)
        return normalize_rgb(resize_linear(rgb, self.img_size))

    def _get_template(self, dataset_type: str, tem_list):
        """A random reference frame of the object: (rgb, rgb_choose, cloud, pose), or None."""
        shard_idx, key_name, inst_id = tem_list[int(self.rng.integers(0, len(tem_list)))]
        dir_idx = 0 if dataset_type == "GSO" else 1
        head = osp.join(self.data_dir, DATA_PATHS[dir_idx], f"{shard_idx:06d}/{key_name}")

        try:
            mask = io_load_masks(head + ".mask_visib.json", instance_ids=[inst_id])[0]
        except (FileNotFoundError, KeyError):
            return None
        if mask.sum() == 0:
            return None
        bbox = get_bbox(mask)
        y1, y2, x1, x2 = bbox
        mask = mask[y1:y2, x1:x2]
        if mask.sum() == 0:
            return None

        rgb = self._crop_rgb(head, bbox, mask)
        choose = mask.astype(np.float32).flatten().nonzero()[0]
        choose = choose[sample_choose(self.rng, len(choose), self.n_sample_template_point)]

        camera = load_json(head + ".camera.json")
        K = np.asarray(camera["cam_K"], np.float32).reshape(3, 3)
        depth = load_im(head + ".depth.png").astype(np.float32) * camera["depth_scale"] / 1000.0
        xyz = backproject_np(depth, K, bbox).reshape(-1, 3)[choose]
        rgb_choose = get_resize_rgb_choose(choose, bbox, self.img_size)
        gt = io_load_gt(head + ".gt.json", instance_ids=[inst_id])[0]
        return rgb, rgb_choose, xyz.astype(np.float32), _pose(gt)


def _pose(gt: dict) -> np.ndarray:
    """(4, 4) float32 object-to-camera pose of a gt entry, the translation in meters."""
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(gt["cam_R_m2c"], np.float32).reshape(3, 3)
    pose[:3, 3] = np.asarray(gt["cam_t_m2c"], np.float32).reshape(3) / 1000.0
    return pose
