"""BOP test-set reader with SAM detections and cross-scene one-reference
assignments (counterpart of ``unopose_tpu/data/dataset_test.py``).

Per test image: one instance per detection with score > seg_filter_score
(else the best-scoring detection); per instance: the RLE segmentation AND
valid depth, a square crop, backprojection, a radius filter against the
assigned reference cloud and ``n_sample_observed_point`` points. The
reference view comes from ``test_ref_targets_*.json``, which maps
{scene}_{im}_{obj} -> {ref_scene}_{ref_im}, with its GT mask and pose from
``scene_gt.json`` (YCB-V references may live in ``train_real``). The
reference pose only composes the output into the object frame; the network
never sees it. Items are numpy arrays (``__getitem__``).
"""

from __future__ import annotations

import logging
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from unopose_tpu_torch.data.preprocess import (
    backproject_np,
    get_bbox,
    get_resize_rgb_choose,
    load_im,
    load_json,
    normalize_rgb,
    resize_linear,
    rle_to_binary_mask,
    sample_choose,
)

logger = logging.getLogger(__name__)

# per-dataset object id tables; ycbv: 21 objects
DATASET_OBJ_IDS = {
    "ycbv": list(range(1, 22)),
    "lm": list(range(1, 16)),
    "lmo": [1, 5, 6, 8, 9, 10, 11, 12],
    "tudl": [1, 2, 3],
    "tyol": list(range(1, 22)),
    "hb": list(range(1, 34)),
}


def decode_segmentation(seg: dict) -> np.ndarray:
    """COCO RLE (compressed string or uncompressed list) -> bool mask."""
    counts = seg["counts"]
    if isinstance(counts, list):
        return rle_to_binary_mask(seg)
    return _decode_compressed_rle(seg)


def _decode_compressed_rle(seg: dict) -> np.ndarray:
    """Decode COCO's LEB128-style compressed RLE (host library)."""
    from unopose_tpu_torch.data import native

    s = seg["counts"]
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts = native.rle_decompress_counts(s)
    return rle_to_binary_mask({"size": seg["size"], "counts": counts})


def get_bop_depth(data_folder: str, scene_id: int, img_id: int) -> np.ndarray:
    """Depth in meters."""
    p = osp.join(data_folder, f"{scene_id:06d}", "depth", f"{img_id:06d}")
    for ext in (".png", ".tif"):
        if osp.exists(p + ext):
            return load_im(p + ext).astype(np.float32) / 1000.0
    raise FileNotFoundError(p)


def get_bop_image(data_folder, scene_id, img_id, bbox, img_size, mask=None, rgb_to_bgr=False) -> np.ndarray:
    """Cropped, masked and resized uint8 RGB."""
    y1, y2, x1, x2 = bbox
    base = osp.join(data_folder, f"{scene_id:06d}")
    for rel in (f"rgb/{img_id:06d}.jpg", f"rgb/{img_id:06d}.png", f"gray/{img_id:06d}.tif"):
        p = osp.join(base, rel)
        if osp.exists(p):
            rgb = load_im(p).astype(np.uint8)
            break
    else:
        raise FileNotFoundError(base)
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, axis=2)
    if rgb_to_bgr:
        rgb = rgb[..., ::-1]
    rgb = rgb[y1:y2, x1:x2, :3]
    if mask is not None:
        rgb = rgb * (mask[:, :, None] > 0).astype(np.uint8)
    return resize_linear(rgb, img_size)


class BOPTestsetPoseFreeOneRef:
    def __init__(self, cfg, eval_dataset_name: str = "ycbv", detection_path: Optional[str] = None, seed: int = 0):
        assert detection_path is not None
        self.cfg = cfg
        self.dataset = eval_dataset_name
        self.data_dir = cfg.data_dir
        self.rgb_mask_flag = cfg.get("rgb_mask_flag", True)
        self.img_size = cfg.get("img_size", 224)
        self.n_sample_observed_point = cfg.get("n_sample_observed_point", 2048)
        self.n_sample_template_point = cfg.get("n_sample_template_point", 5000)
        self.minimum_n_point = cfg.get("minimum_n_point", 8)
        self.seg_filter_score = cfg.get("seg_filter_score", 0.25)
        self.rgb_to_bgr = cfg.get("rgb_to_bgr", False)
        self.rng = np.random.default_rng(seed)

        obj_ids = DATASET_OBJ_IDS.get(eval_dataset_name, list(range(1, 100)))
        self.obj_idxs = {obj_id: idx for idx, obj_id in enumerate(obj_ids)}
        self.data_folder = osp.join(self.data_dir, eval_dataset_name, "test")

        self.test_ref_target = self._load_ref(
            osp.join(self.data_dir, eval_dataset_name, cfg.get("ref_targets_name", "test_ref_targets.json"))
        )

        self._ref_cache: Dict[tuple, Optional[tuple]] = {}
        self._json_cache: Dict[str, dict] = {}
        self._depth_cache: Dict[tuple, np.ndarray] = {}

        dets = load_json(detection_path)
        self.det_keys: List[str] = []
        self.dets: Dict[str, list] = {}
        for det in dets:
            key = f"{det['scene_id']:06d}_{det['image_id']:06d}"
            if key not in self.dets:
                self.det_keys.append(key)
                self.dets[key] = []
            self.dets[key].append(det)
        logger.info("testing on %d images on %s", len(self.det_keys), eval_dataset_name)

    @staticmethod
    def _load_ref(path):
        mapping = {}
        for t in load_json(path):
            mapping[f"{t['scene_id']}_{t['im_id']}_{t['obj_id']}"] = f"{t['ref_scene_id']}_{t['ref_im_id']}"
        return mapping

    def __len__(self):
        return len(self.det_keys)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        dets = self.dets[self.det_keys[index]]
        instances, inst_ids = [], []
        for det_i, det in enumerate(dets):
            if det["score"] > self.seg_filter_score:
                inst = self.get_instance(det)
                if inst is not None:
                    instances.append(inst)
                    inst_ids.append(det_i)
        if not instances:
            best = int(np.argmax([d["score"] for d in dets]))
            inst = self.get_instance(dets[best])
            if inst is None:
                raise ValueError(f"no qualified instance in {self.det_keys[index]}")
            instances.append(inst)
            inst_ids.append(best)

        out = {k: np.stack([inst[k] for inst in instances]) for k in instances[0]}
        out["scene_id"] = np.asarray([int(self.det_keys[index][:6])], np.int32)
        out["img_id"] = np.asarray([int(self.det_keys[index][7:13])], np.int32)
        out["inst_ids"] = np.asarray(inst_ids, np.int32)
        out["seg_time"] = np.asarray([dets[0].get("time", 0.0)], np.float32)
        return out

    def _load_json_cached(self, path: str) -> dict:
        """scene_camera / scene_gt jsons, parsed once per file rather than per
        instance."""
        if path not in self._json_cache:
            if len(self._json_cache) > 64:
                self._json_cache.clear()
            self._json_cache[path] = load_json(path)
        return self._json_cache[path]

    def _depth_cached(self, data_folder: str, scene_id: int, img_id: int) -> np.ndarray:
        key = (data_folder, scene_id, img_id)
        if key not in self._depth_cache:
            if len(self._depth_cache) > 4:
                self._depth_cache.clear()
            self._depth_cache[key] = get_bop_depth(data_folder, scene_id, img_id)
        return self._depth_cache[key]

    def get_instance(self, det) -> Optional[Dict[str, np.ndarray]]:
        scene_id, img_id, obj_id = det["scene_id"], det["image_id"], det["category_id"]
        scene_folder = osp.join(self.data_folder, f"{scene_id:06d}")
        scene_camera = self._load_json_cached(osp.join(scene_folder, "scene_camera.json"))
        K = np.asarray(scene_camera[str(img_id)]["cam_K"], np.float64).reshape(3, 3)
        depth_scale = scene_camera[str(img_id)]["depth_scale"]
        depth = self._depth_cached(self.data_folder, scene_id, img_id) * depth_scale

        mask = decode_segmentation(det["segmentation"])
        mask = np.logical_and(mask, depth > 0)
        if mask.sum() <= self.minimum_n_point:
            return None
        bbox = get_bbox(mask)
        y1, y2, x1, x2 = bbox
        mask = mask[y1:y2, x1:x2]
        choose = mask.astype(np.float32).flatten().nonzero()[0]

        cloud = backproject_np(depth, K, bbox).reshape(-1, 3)[choose]
        center = cloud.mean(0)

        ref = self._get_ref_instance(scene_id, img_id, obj_id)
        if ref is None:
            return None
        tem_rgb, tem_choose, tem_pts, pose_camref_obj, ref_uid = ref

        radius = np.linalg.norm(tem_pts - tem_pts.mean(0, keepdims=True), axis=1).max()
        flag = np.linalg.norm(cloud - center[None], axis=1) < 1.2 * radius
        if flag.sum() < self.minimum_n_point:
            return None
        choose, cloud = choose[flag], cloud[flag]
        sel = sample_choose(self.rng, len(choose), self.n_sample_observed_point)
        choose, cloud = choose[sel], cloud[sel]

        rgb = get_bop_image(
            self.data_folder,
            scene_id,
            img_id,
            bbox,
            self.img_size,
            mask if self.rgb_mask_flag else None,
            self.rgb_to_bgr,
        )
        return dict(
            pts=cloud.astype(np.float32),
            rgb=normalize_rgb(rgb),
            rgb_choose=get_resize_rgb_choose(choose, bbox, self.img_size).astype(np.int32),
            obj=np.asarray([self.obj_idxs.get(obj_id, 0)], np.int32),
            obj_id=np.asarray([obj_id], np.int32),
            score=np.asarray([det["score"]], np.float32),
            tem1_rgb=tem_rgb.astype(np.float32) if tem_rgb.dtype != np.float32 else tem_rgb,
            tem1_choose=tem_choose.astype(np.int32),
            tem1_pts=tem_pts.astype(np.float32),
            tem1_pose=pose_camref_obj,
            # identity of the reference this instance uses — the engine's
            # TemplateCache key (refs repeat heavily in the cross-scene map)
            ref_key=np.asarray(ref_uid, np.int64),
        )

    def _get_ref_instance(self, scene_id, img_id, obj_id):
        key = f"{scene_id}_{img_id}_{obj_id}"
        if key not in self.test_ref_target:
            return None
        ref_scene_id, ref_im_id = (int(v) for v in self.test_ref_target[key].split("_"))

        # one fetch per distinct reference: the cross-scene rot50 map points
        # many query images at the same (ref_scene, ref_im, obj), and the
        # engine's template cache keys on it
        cache_key = (ref_scene_id, ref_im_id, obj_id)
        if cache_key not in self._ref_cache:
            if len(self._ref_cache) > 512:
                self._ref_cache.clear()
            self._ref_cache[cache_key] = self._fetch_ref_instance(ref_scene_id, ref_im_id, obj_id)
        return self._ref_cache[cache_key]

    def _fetch_ref_instance(self, ref_scene_id, ref_im_id, obj_id):

        data_folder = self.data_folder
        if self.dataset == "ycbv" and ref_scene_id not in range(48, 60):
            data_folder = osp.join(self.data_dir, self.dataset, "train_real")
        elif self.dataset == "tudl":
            data_folder = osp.join(self.data_dir, self.dataset, "train_real")

        scene_folder = osp.join(data_folder, f"{ref_scene_id:06d}")
        scene_camera = self._load_json_cached(osp.join(scene_folder, "scene_camera.json"))
        K = np.asarray(scene_camera[str(ref_im_id)]["cam_K"], np.float64).reshape(3, 3)
        scene_gt = self._load_json_cached(osp.join(scene_folder, "scene_gt.json"))

        pose_camref_obj = None
        for i, info in enumerate(scene_gt[str(ref_im_id)]):
            if info["obj_id"] == obj_id:
                pose_camref_obj = np.eye(4, dtype=np.float32)
                pose_camref_obj[:3, :3] = np.asarray(info["cam_R_m2c"], np.float32).reshape(3, 3)
                pose_camref_obj[:3, 3] = np.asarray(info["cam_t_m2c"], np.float32).reshape(3) * 0.001
                mask_path = osp.join(data_folder, f"{ref_scene_id:06d}/mask_visib/{ref_im_id:06d}_{i:06d}.png")
                break
        if pose_camref_obj is None:
            return None

        depth_scale = scene_camera[str(ref_im_id)]["depth_scale"]
        depth = (get_bop_depth(data_folder, ref_scene_id, ref_im_id) * depth_scale).astype(np.float32)
        mask = load_im(mask_path).astype(bool)

        bbox = get_bbox(mask)
        y1, y2, x1, x2 = bbox
        mask = mask[y1:y2, x1:x2]

        ref_xyz = backproject_np(depth, K, bbox)
        ref_xyz = ref_xyz * mask.astype(np.float32)[:, :, None]

        ref_rgb = get_bop_image(
            data_folder,
            ref_scene_id,
            ref_im_id,
            bbox,
            self.img_size,
            mask if self.rgb_mask_flag else None,
            self.rgb_to_bgr,
        )
        choose = (mask > 0).astype(np.float32).flatten().nonzero()[0]
        sel = sample_choose(self.rng, len(choose), self.n_sample_template_point)
        choose = choose[sel]
        ref_xyz = ref_xyz.reshape(-1, 3)[choose]
        rgb_choose = get_resize_rgb_choose(choose, bbox, self.img_size)
        return (
            normalize_rgb(ref_rgb),
            rgb_choose,
            ref_xyz.astype(np.float32),
            pose_camref_obj,
            (ref_scene_id, ref_im_id, obj_id),
        )
