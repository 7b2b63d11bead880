"""Per-dataset metadata of BOP-format datasets (counterpart of
``unopose_tpu/data/dataset_refs.py``): the object-name tables and the
symmetric objects of the datasets the evaluation knows, and ``DatasetRef``,
which reads diameters, meshes and cameras from a dataset's
``models_info.json`` and ``camera.json`` when asked."""

from __future__ import annotations

import os.path as osp
from dataclasses import dataclass, field
from typing import Dict, Optional

from unopose_tpu_torch.data.preprocess import load_json

ID2OBJ: Dict[str, Dict[int, str]] = {
    "ycbv": {
        1: "002_master_chef_can", 2: "003_cracker_box", 3: "004_sugar_box",
        4: "005_tomato_soup_can", 5: "006_mustard_bottle", 6: "007_tuna_fish_can",
        7: "008_pudding_box", 8: "009_gelatin_box", 9: "010_potted_meat_can",
        10: "011_banana", 11: "019_pitcher_base", 12: "021_bleach_cleanser",
        13: "024_bowl", 14: "025_mug", 15: "035_power_drill", 16: "036_wood_block",
        17: "037_scissors", 18: "040_large_marker", 19: "051_large_clamp",
        20: "052_extra_large_clamp", 21: "061_foam_brick",
    },
    "lm": {i: n for i, n in enumerate(
        ["ape", "benchvise", "bowl", "camera", "can", "cat", "cup", "driller",
         "duck", "eggbox", "glue", "holepuncher", "iron", "lamp", "phone"], 1)},
    "lmo": {1: "ape", 5: "can", 6: "cat", 8: "driller", 9: "duck", 10: "eggbox", 11: "glue", 12: "holepuncher"},
    "tudl": {1: "dragon", 2: "frog", 3: "can"},
    "tyol": {i: f"obj_{i:02d}" for i in range(1, 22)},
    "hb": {i: f"obj_{i:02d}" for i in range(1, 34)},
    "hb_bop19": {i: f"obj_{i:02d}" for i in (1, 3, 4, 8, 9, 10, 12, 15, 17, 18, 19, 22, 23, 29, 32, 33)},
    "gso": {},          # MegaPose GSO: ids from gso_models.json
    "gso_bop23": {},
    "shapenet_bop23": {},
    "wildrgbd": {},
}

# objects treated as symmetric in the classic (pre-BOP19) protocols
SYM_OBJS: Dict[str, list] = {
    "ycbv": [13, 16, 19, 20, 21],
    "lm": [3, 7, 10, 11],
    "lmo": [10, 11],
    "tudl": [],
    "hb": [6, 10, 11, 12, 13, 14, 18, 24, 29],
}


@dataclass
class DatasetRef:
    """Lazily-loaded metadata for one BOP-format dataset."""

    name: str
    dataset_root: str  # e.g. datasets/BOP_DATASETS/ycbv
    model_dir_name: str = "models_eval"
    _models_info: Optional[dict] = field(default=None, repr=False)

    @property
    def id2obj(self) -> Dict[int, str]:
        return ID2OBJ.get(self.name, {})

    @property
    def objects(self):
        return list(self.id2obj.values())

    @property
    def obj2id(self) -> Dict[str, int]:
        return {v: k for k, v in self.id2obj.items()}

    @property
    def model_dir(self) -> str:
        return osp.join(self.dataset_root, self.model_dir_name)

    @property
    def models_info(self) -> dict:
        if self._models_info is None:
            self._models_info = {
                int(k): v for k, v in load_json(osp.join(self.model_dir, "models_info.json")).items()
            }
        return self._models_info

    def diameter(self, obj_id: int) -> float:
        return self.models_info[obj_id]["diameter"]

    def model_ply(self, obj_id: int) -> str:
        return osp.join(self.model_dir, f"obj_{obj_id:06d}.ply")

    def targets_path(self, targets_name: str = "test_targets_bop19.json") -> str:
        return osp.join(self.dataset_root, targets_name)

    @property
    def camera(self) -> dict:
        return load_json(osp.join(self.dataset_root, "camera.json"))


def get_ref(name: str, bop_root: str) -> DatasetRef:
    """The metadata of dataset ``name`` under the BOP root ``bop_root``."""
    if name not in ID2OBJ:
        raise KeyError(f"unknown dataset {name}; known: {sorted(ID2OBJ)}")
    return DatasetRef(name, osp.join(bop_root, name))
