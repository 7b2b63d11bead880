"""BOP19 evaluation: CSV estimates -> VSD / MSSD / MSPD -> AR (counterpart
of ``unopose_tpu/eval/bop_eval.py``): bop_toolkit's
eval_pose_results_more.py, eval_calc_errors.py and eval_calc_scores.py and
the per-object tables in one module, errors for every threshold computed in
one pass over the estimates.

Protocol (BOP19):
  * errors: VSD (delta 15 mm, taus 0.05:0.05:0.5, diameter-normalised),
    MSSD, MSPD
  * thresholds of correctness: VSD/MSSD tau in 0.05:0.05:0.5 (MSSD relative
    to the object diameter), MSPD 5:5:50 px scaled by r = width/640
  * n_top = -1: per (scene, im, obj) the estimates are truncated to the
    top ``inst_count`` by score before the errors and the matching
    (eval_calc_errors.py:216-243); n_top = 0 keeps all, n_top > 0 keeps
    that many
  * valid GTs: visib_gt_min = -1 (the toolkit default,
    eval_calc_scores.py:56-59): the ``inst_count`` most visible GT poses per
    (im, obj) are valid; with visib_gt_min >= 0 a GT is valid iff it is
    targeted and visib_fract >= visib_gt_min (eval_calc_scores.py:194-214)
  * greedy score-ordered matching per (scene, im, obj) against valid
    unmatched GTs (pose_matching.py:40-89)
  * extra error families on request (add/adi/ad, ABS*/AUC* variants, re,
    te, rete, proj: eval_pose_results_more.py:78-159) with the toolkit's
    threshold sets; the headline AR stays the BOP19 mean
  * recalls averaged over thresholds; AR = mean(AR_vsd, AR_mssd, AR_mspd);
    per-object table and overall weighted by the per-object sums of the
    targets' inst_count
"""

from __future__ import annotations

import json
import logging
import os.path as osp
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from unopose_tpu_torch.data.preprocess import load_im, load_json
from unopose_tpu_torch.eval.pose_error import (
    add,
    adi,
    depth_im_to_dist_im,
    get_symmetry_transformations,
    mspd,
    mssd,
    proj,
    re,
    te,
    vsd_from_dists,
)
from unopose_tpu_torch.eval.ply import load_ply
from unopose_tpu_torch.eval.renderer import MeshRasterRenderer

logger = logging.getLogger(__name__)

VSD_TAUS = [0.05 * i for i in range(1, 11)]
VSD_DELTA = 15.0
REL_THRESHOLDS = [0.05 * i for i in range(1, 11)]  # vsd / mssd
MSPD_THRESHOLDS = [5.0 * i for i in range(1, 11)]  # px, scaled by width/640

# Extra error families of bop_toolkit's evaluator
# (eval_pose_results_more.py:78-159). Thresholds are its
# verbatim config values; families in _DIAMETER_NORMALIZED divide the raw
# mm error by the object diameter before thresholding
# (eval_calc_scores.py:52-53,222-227). The ABS*/AUC*/te thresholds are
# compared against RAW errors exactly as the toolkit does (it performs no
# cm->mm conversion despite the "[cm]" comments in its config).
EXTRA_CORRECT_TH = {
    "add": [0.02, 0.05, 0.1],  # fractions of diameter
    "adi": [0.02, 0.05, 0.1],
    "ad": [0.02, 0.05, 0.1],  # adi for symmetric objects, add otherwise
    "ABSadd": [2.0],
    "ABSadi": [2.0],
    "ABSad": [2.0],
    "AUCadd": [float(th) for th in range(1, 11)],  # 10-point recall curve
    "AUCadi": [float(th) for th in range(1, 11)],
    "AUCad": [float(th) for th in range(1, 11)],
    "re": [2.0, 5.0, 10.0],  # degrees
    "te": [2.0, 5.0, 10.0],
    "rete": [[2.0, 2.0], [5.0, 5.0], [10.0, 10.0]],  # both must pass
    "proj": [2.0, 5.0, 10.0],  # px
}
_DIAMETER_NORMALIZED = {"ad", "add", "adi"}  # (+ mssd, handled inline)
# base surface-distance error behind each family ("ad" resolved per object)
_AD_BASE = {
    "add": "add", "ABSadd": "add", "AUCadd": "add",
    "adi": "adi", "ABSadi": "adi", "AUCadi": "adi",
    "ad": "ad", "ABSad": "ad", "AUCad": "ad",
}

# bop_toolkit dataset_params.py:93-107 — objects evaluated with ADI under
# the "ad" family ("ID's of objects with ambiguous views").
SYMMETRIC_OBJ_IDS = {
    "lm": [3, 7, 10, 11],
    "lmo": [10, 11],
    "tless": list(range(1, 31)),
    "tudl": [],
    "tyol": [3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 15, 16, 17, 18, 19, 21],
    "ruapc": [8, 9, 12, 13],
    "icmi": [1, 2, 6],
    "icbin": [1],
    "itodd": [2, 3, 4, 5, 7, 8, 9, 11, 12, 14, 17, 18, 19, 23, 24, 25, 27, 28],
    "hbs": [10, 12, 18, 29],
    "hb": [6, 10, 11, 12, 13, 14, 18, 24, 29],
    "ycbv": [1, 13, 14, 16, 18, 19, 20, 21],
}


def load_estimates_csv(path: str) -> List[Dict]:
    ests = []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("scene_id"):
            continue
        parts = line.split(",")
        ests.append(
            dict(
                scene_id=int(parts[0]),
                im_id=int(parts[1]),
                obj_id=int(parts[2]),
                score=float(parts[3]),
                R=np.fromstring(parts[4], sep=" ").reshape(3, 3),
                t=np.fromstring(parts[5], sep=" "),  # mm
                time=float(parts[6]) if len(parts) > 6 else -1.0,
            )
        )
    return ests


class ModelStore:
    """Lazy per-object meshes + info + renderer registration."""

    def __init__(self, models_dir: str, renderer=None, n_mspd_pts: int = 0):
        self.models_dir = models_dir
        self.info = {int(k): v for k, v in load_json(osp.join(models_dir, "models_info.json")).items()}
        self.renderer = renderer
        self._pts: Dict[int, np.ndarray] = {}
        self._syms: Dict[int, list] = {}
        self.n_mspd_pts = n_mspd_pts

    def pts(self, obj_id: int) -> np.ndarray:
        if obj_id not in self._pts:
            ply = load_ply(osp.join(self.models_dir, f"obj_{obj_id:06d}.ply"))
            pts = ply["pts"]
            if self.n_mspd_pts and len(pts) > self.n_mspd_pts:
                sel = np.linspace(0, len(pts) - 1, self.n_mspd_pts).astype(int)
                pts = pts[sel]
            self._pts[obj_id] = pts
            if self.renderer is not None:
                self.renderer.add_object(obj_id, ply["pts"], ply["faces"], self.info[obj_id]["diameter"])
        return self._pts[obj_id]

    def syms(self, obj_id: int) -> list:
        if obj_id not in self._syms:
            self._syms[obj_id] = get_symmetry_transformations(self.info[obj_id], max_sym_disc_step=0.01)
        return self._syms[obj_id]

    def diameter(self, obj_id: int) -> float:
        return self.info[obj_id]["diameter"]


def _match_recall(errs_by_gt: Dict[int, List], n_valid_gts: int, thresh) -> int:
    """Greedy score-ordered matching (pose_matching.py:9-88); returns the
    number of matched GTs at the given threshold.

    errs_by_gt: list of (score, {gt_id: err}) per estimate. ``thresh`` and
    the errors may be multi-element lists (e.g. "rete" = [deg, mm]): a GT
    beats the current best only if ALL elements are lower
    (pose_matching.py:63-66)."""
    multi = isinstance(thresh, (list, tuple))
    matched = set()
    n = 0
    for score, errors in errs_by_gt:
        if multi:
            best_gt, best_err = -1, list(thresh)
            for gt_id, err in errors.items():
                if gt_id not in matched and all(err[i] < best_err[i] for i in range(len(best_err))):
                    best_gt, best_err = gt_id, err
        else:
            best_gt, best_err = -1, thresh
            for gt_id, err in errors.items():
                if gt_id not in matched and err < best_err:
                    best_gt, best_err = gt_id, err
        if best_gt >= 0:
            matched.add(best_gt)
            n += 1
    return n


def evaluate_bop(
    result_csv: str,
    dataset_dir: str,
    models_dir: Optional[str] = None,
    split: str = "test",
    error_types: Sequence[str] = ("vsd", "mssd", "mspd"),
    targets_name: str = "test_targets_bop19.json",
    visib_gt_min: float = -1.0,
    n_top: int = -1,
    im_size=(480, 640),
    max_images: Optional[int] = None,
    dataset_name: Optional[str] = None,
) -> Dict:
    """Evaluate a BOP19 CSV against a BOP dataset directory.

    ``error_types`` may include, beyond the BOP19 gate (vsd/mssd/mspd),
    every extra family bop_toolkit's evaluator configures
    (eval_pose_results_more.py:78-159): add/adi/ad, ABSadd/ABSadi/ABSad,
    AUCadd/AUCadi/AUCad, re, te, rete, proj. ``dataset_name`` selects the
    SYMMETRIC_OBJ_IDS row for the "ad" variants (default: the basename of
    ``dataset_dir``).

    Returns {error_type: {"per_object": {obj: AR}, "average": instance-
    weighted AR}, "AR": mean over error types, ...}. "AR" averages ONLY
    the BOP19 types present: the headline metric.
    """
    models_dir = models_dir or osp.join(dataset_dir, "models_eval")
    dataset_name = dataset_name or osp.basename(osp.normpath(dataset_dir))
    sym_obj_ids = set(SYMMETRIC_OBJ_IDS.get(dataset_name, []))
    need_vsd = "vsd" in error_types
    renderer = MeshRasterRenderer(im_size[0], im_size[1]) if need_vsd else None
    store = ModelStore(models_dir, renderer)

    targets = load_json(osp.join(dataset_dir, targets_name))
    target_set = {}  # (scene, im, obj) -> inst_count
    # pre-index by image: per-image work must not rescan the full target
    # list (O(images x targets) on real YCB-V: ~900 x ~4000)
    targets_by_image = defaultdict(dict)  # (scene, im) -> {obj: inst_count}
    for t in targets:
        target_set[(t["scene_id"], t["im_id"], t["obj_id"])] = t.get("inst_count", 1)
        targets_by_image[(t["scene_id"], t["im_id"])][t["obj_id"]] = t.get("inst_count", 1)

    ests = load_estimates_csv(result_csv)
    by_image = defaultdict(list)
    for e in ests:
        if (e["scene_id"], e["im_id"], e["obj_id"]) in target_set:
            by_image[(e["scene_id"], e["im_id"])].append(e)

    # group target images by scene
    scene_images = defaultdict(set)
    for s, i, o in target_set:
        scene_images[s].add(i)

    # error accumulators: err_type -> obj -> list of (n_valid, [matched@thresh...])
    per_obj = {et: defaultdict(lambda: [0, None]) for et in error_types}
    ths = {
        "vsd": REL_THRESHOLDS,
        "mssd": REL_THRESHOLDS,
        "mspd": MSPD_THRESHOLDS,
        **EXTRA_CORRECT_TH,
    }
    unknown = [et for et in error_types if et not in ths]
    if unknown:
        raise ValueError(f"unknown error types: {unknown}")

    gt_cache = {}
    target_insts: Dict[int, int] = {}  # obj -> total targeted inst_count seen
    n_images_done = 0
    for scene_id, images in sorted(scene_images.items()):
        scene_folder = osp.join(dataset_dir, split, f"{scene_id:06d}")
        if scene_id not in gt_cache:
            gt_cache = {
                scene_id: (
                    load_json(osp.join(scene_folder, "scene_gt.json")),
                    load_json(osp.join(scene_folder, "scene_gt_info.json")),
                    load_json(osp.join(scene_folder, "scene_camera.json")),
                )
            }
        scene_gt, scene_gt_info, scene_camera = gt_cache[scene_id]

        for im_id in sorted(images):
            if max_images is not None and n_images_done >= max_images:
                break
            n_images_done += 1
            gts = scene_gt[str(im_id)]
            gt_infos = scene_gt_info[str(im_id)]
            K = np.asarray(scene_camera[str(im_id)]["cam_K"], np.float64).reshape(3, 3)
            depth_scale = scene_camera[str(im_id)].get("depth_scale", 1.0)
            depth_test = None

            img_ests = by_image.get((scene_id, im_id), [])
            objs_here = targets_by_image[(scene_id, im_id)]
            gt_depth_cache = {}  # gt index -> rendered depth (per image)
            for obj_id in sorted(objs_here):
                inst_count = objs_here[obj_id]
                gt_ids = [g for g, gt in enumerate(gts) if gt["obj_id"] == obj_id]
                if visib_gt_min >= 0:
                    # eval_calc_scores.py:194-200: targeted + visib >= min
                    valid = {g: gt_infos[g]["visib_fract"] >= visib_gt_min for g in gt_ids}
                else:
                    # eval_calc_scores.py:202-214: the inst_count most
                    # visible GTs are valid (stable sort, ties by gt_id)
                    by_visib = sorted(gt_ids, key=lambda g: -gt_infos[g]["visib_fract"])
                    valid = {g: False for g in gt_ids}
                    for g in by_visib[:inst_count]:
                        valid[g] = True
                n_valid = sum(valid.values())
                if n_valid == 0:
                    continue
                target_insts[obj_id] = target_insts.get(obj_id, 0) + inst_count
                # sort by score desc (stable: ties keep CSV order,
                # eval_calc_errors.py:239-243), then n_top truncation
                obj_ests = sorted(
                    (e for e in img_ests if e["obj_id"] == obj_id), key=lambda e: -e["score"]
                )
                n_top_curr = inst_count if n_top == -1 else (n_top if n_top > 0 else None)
                obj_ests = obj_ests[slice(0, n_top_curr)]

                # compute errors per estimate per GT
                errs = {et: [] for et in error_types}
                for e in obj_ests:
                    e_errs = {et: {} for et in error_types}
                    for g in gt_ids:
                        if not valid[g]:
                            continue
                        gt = gts[g]
                        R_g = np.asarray(gt["cam_R_m2c"], np.float64).reshape(3, 3)
                        t_g = np.asarray(gt["cam_t_m2c"], np.float64)
                        pts = store.pts(obj_id)
                        syms = store.syms(obj_id)
                        if "mssd" in error_types:
                            e_errs["mssd"][g] = mssd(e["R"], e["t"], R_g, t_g, pts, syms) / store.diameter(obj_id)
                        if "mspd" in error_types:
                            r = im_size[1] / 640.0
                            e_errs["mspd"][g] = mspd(e["R"], e["t"], R_g, t_g, K, pts, syms) / r
                        if need_vsd:
                            if depth_test is None:
                                depth_test = depth_im_to_dist_im(
                                    load_im(osp.join(scene_folder, "depth", f"{im_id:06d}.png")).astype(np.float64)
                                    * depth_scale,
                                    K,
                                )
                            d_est = depth_im_to_dist_im(renderer.render_depth(obj_id, e["R"], e["t"], K), K)
                            if g not in gt_depth_cache:
                                gt_depth_cache[g] = depth_im_to_dist_im(
                                    renderer.render_depth(obj_id, R_g, t_g, K), K
                                )
                            d_gt = gt_depth_cache[g]
                            vsd_errs = vsd_from_dists(
                                d_est, d_gt, depth_test, VSD_DELTA, VSD_TAUS, True, store.diameter(obj_id)
                            )
                            e_errs["vsd"][g] = vsd_errs  # list over taus
                        # ---- extra families (eval_pose_results_more.py:78-159)
                        ad_vals = {}  # base ("add"/"adi") -> raw mm error
                        for et in error_types:
                            base = _AD_BASE.get(et)
                            if base is None:
                                continue
                            if base == "ad":
                                base = "adi" if obj_id in sym_obj_ids else "add"
                            if base not in ad_vals:
                                # bounding-spheres shortcut: infinite error
                                # when the spheres cannot overlap
                                # (eval_calc_errors.py:271-276,307-313)
                                if np.linalg.norm(np.asarray(e["t"]).reshape(3) - t_g.reshape(3)) >= store.diameter(obj_id):
                                    ad_vals[base] = float("inf")
                                else:
                                    fn = add if base == "add" else adi
                                    ad_vals[base] = fn(e["R"], e["t"], R_g, t_g, pts)
                            err = ad_vals[base]
                            if et in _DIAMETER_NORMALIZED:
                                err = err / store.diameter(obj_id)
                            e_errs[et][g] = err
                        if "re" in error_types:
                            e_errs["re"][g] = re(e["R"], R_g)
                        if "te" in error_types:
                            e_errs["te"][g] = te(e["t"], t_g)
                        if "rete" in error_types:
                            e_errs["rete"][g] = [re(e["R"], R_g), te(e["t"], t_g)]
                        if "proj" in error_types:
                            e_errs["proj"][g] = proj(e["R"], e["t"], R_g, t_g, K, pts)
                    for et in error_types:
                        errs[et].append((e["score"], e_errs[et]))

                # matching + recall counting per threshold
                for et in error_types:
                    slot = per_obj[et][obj_id]
                    if slot[1] is None:
                        slot[1] = np.zeros(len(ths[et]) if et != "vsd" else len(ths["vsd"]) * len(VSD_TAUS))
                    if et == "vsd":
                        # recall over (threshold, tau) pairs, averaged later
                        k = 0
                        for ti, tau in enumerate(VSD_TAUS):
                            per_tau = [(s, {g: v[ti] for g, v in d.items()}) for s, d in errs[et]]
                            for th in ths[et]:
                                slot[1][k] += _match_recall(per_tau, n_valid, th)
                                k += 1
                        slot[0] += n_valid
                    else:
                        for k, th in enumerate(ths[et]):
                            slot[1][k] += _match_recall(errs[et], n_valid, th)
                        slot[0] += n_valid

    # aggregate: per-object AR (mean recall over thresholds [x taus]),
    # overall = mean of per-object recalls weighted by the object's total
    # targeted inst_count
    out = {}
    for et in error_types:
        per_object = {}
        w_num, w_den = 0.0, 0.0
        for obj_id, (n_valid, matched) in sorted(per_obj[et].items()):
            if n_valid == 0 or matched is None:
                continue
            recalls = matched / n_valid
            per_object[obj_id] = float(np.mean(recalls))
            w = target_insts.get(obj_id, n_valid)
            w_num += w * per_object[obj_id]
            w_den += w
        out[et] = {"per_object": per_object, "average": float(w_num / max(w_den, 1e-9))}
    # headline AR stays the BOP19 mean even when extra families are computed
    ar_types = [et for et in ("vsd", "mssd", "mspd") if et in error_types] or list(error_types)
    out["AR"] = float(np.mean([out[et]["average"] for et in ar_types]))
    out["n_images"] = n_images_done
    return out


def _plain_tab(rows):
    """tabulate(tablefmt='plain') equivalent: space-padded columns."""
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    return "\n".join("  ".join(c.ljust(widths[i]) for i, c in enumerate(r)).rstrip() for r in rows)


def format_per_object_tables(res, id2obj=None):
    """Human-readable per-object AR tables, objects-in-columns and
    objects-in-rows, for the console and the ``{result}_tab_obj_{row,col}.txt``
    dumps. Values are percent recalls;
    the rightmost column / bottom row is the instance-weighted average.

    Returns (objects_in_columns_str, objects_in_rows_str)."""
    ets = [et for et, v in res.items() if isinstance(v, dict) and "per_object" in v]
    objs = sorted({o for et in ets for o in res[et]["per_object"]})

    def oname(o):
        return str(id2obj[o]) if id2obj and o in id2obj else str(o)

    rows = [["objects"] + [oname(o) for o in objs] + ["Avg"]]
    for et in ets:
        po = res[et]["per_object"]
        rows.append(
            [et]
            + [f"{100.0 * po[o]:.2f}" if o in po else "-" for o in objs]
            + [f"{100.0 * res[et]['average']:.2f}"]
        )
    if "AR" in res:
        rows.append(["AR"] + [""] * len(objs) + [f"{100.0 * res['AR']:.2f}"])
    cols = [list(r) for r in zip(*rows)]  # objects in rows
    return _plain_tab(rows), _plain_tab(cols)


def write_per_object_tables(res, csv_path, id2obj=None):
    """Write `{result}_tab_obj_row.txt` / `_tab_obj_col.txt` next to the
    result CSV.
    Returns the two paths."""
    by_col, by_row = format_per_object_tables(res, id2obj=id2obj)
    base = csv_path[:-4] if csv_path.endswith(".csv") else csv_path
    paths = []
    for suffix, tab_str in (("row", by_row), ("col", by_col)):
        path = f"{base}_tab_obj_{suffix}.txt"
        with open(path, "w") as f:
            f.write(tab_str + "\n")
        paths.append(path)
    return paths


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="BOP19 evaluation (VSD/MSSD/MSPD)")
    p.add_argument("result_csv")
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--models-dir", default=None)
    p.add_argument("--split", default="test")
    p.add_argument("--error-types", default="vsd,mssd,mspd")
    p.add_argument("--targets-name", default="test_targets_bop19.json")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    res = evaluate_bop(
        args.result_csv,
        args.dataset_dir,
        models_dir=args.models_dir,
        split=args.split,
        error_types=tuple(args.error_types.split(",")),
        targets_name=args.targets_name,
    )
    print(json.dumps(res, indent=2))
    by_col, _ = format_per_object_tables(res)
    print(by_col)
    write_per_object_tables(res, args.result_csv)
    if args.out:
        json.dump(res, open(args.out, "w"), indent=2)


if __name__ == "__main__":
    main()
