"""The port's launcher, ``python -m unopose_tpu_torch.main_unopose
--eval-only``, end to end on the CPU at the tiny config: a synthetic BOP
tree (``tests/test_launcher_e2e.py:bop_e2e``'s layout, PNGs by the port's
stdlib writer, more detections and images) -> the test reader -> the
template cache and the chunked forward -> the BOP19 CSV and JSON -> the
evaluator's scores JSON and per-object tables."""

import json
import os

import numpy as np
import pytest

from unopose_tpu_torch import main_unopose
from unopose_tpu_torch.data.png import write_png
from unopose_tpu_torch.data.preprocess import binary_mask_to_rle

K = np.array([[572.4, 0, 320.0], [0, 573.6, 240.0], [0, 0, 1.0]])
H, W = 480, 640
IMAGES, REF_IMAGE = (1, 2), 3
SCORES = (0.9, 0.6, 0.1, 0.8)  # a query image's detections; 0.1 is under the 0.25 filter
KEPT = 3


@pytest.fixture
def bop_tree(tmp_path):
    return write_tree(tmp_path)


def write_tree(tmp_path):
    """Scene 48, query images 1 and 2 with a detection of object 5 at each of
    ``SCORES`` (its mask shifted by its index), all on the reference
    (48, 3, 5); a cube mesh and the BOP19 targets. Returns the BOP root and
    the detections' path."""
    rng = np.random.default_rng(7)
    root = tmp_path / "BOP_DATASETS"
    scene = root / "ycbv" / "test" / "000048"
    for sub in ("depth", "rgb", "mask_visib"):
        os.makedirs(scene / sub)
    depth = np.zeros((H, W), np.uint16)
    mask = np.zeros((H, W), bool)
    depth[180:300, 260:380] = 900
    mask[180:300, 260:380] = True
    gts, infos, cams = {}, {}, {}
    for im_id in IMAGES + (REF_IMAGE,):
        write_png(scene / "depth" / f"{im_id:06d}.png", depth)
        write_png(scene / "rgb" / f"{im_id:06d}.png", rng.integers(0, 255, (H, W, 3)).astype(np.uint8))
        write_png(scene / "mask_visib" / f"{im_id:06d}_000000.png", (mask * 255).astype(np.uint8))
        gts[str(im_id)] = [dict(obj_id=5, cam_R_m2c=np.eye(3).reshape(-1).tolist(), cam_t_m2c=[0, 0, 900.0])]
        infos[str(im_id)] = [dict(visib_fract=1.0)]
        cams[str(im_id)] = dict(cam_K=K.reshape(-1).tolist(), depth_scale=1.0)
    for name, d in (("scene_gt", gts), ("scene_gt_info", infos), ("scene_camera", cams)):
        json.dump(d, open(scene / f"{name}.json", "w"))
    json.dump([dict(scene_id=48, im_id=i, obj_id=5, ref_scene_id=48, ref_im_id=REF_IMAGE) for i in IMAGES],
              open(root / "ycbv" / "test_ref_targets_crossscene_rot50.json", "w"))
    dets = [dict(scene_id=48, image_id=i, category_id=5, score=s, time=0.1,
                 segmentation=binary_mask_to_rle(np.roll(mask, k, axis=1)))
            for i in IMAGES for k, s in enumerate(SCORES)]
    json.dump(dets, open(root / "dets.json", "w"))
    json.dump([dict(scene_id=48, im_id=i, obj_id=5, inst_count=1) for i in IMAGES],
              open(root / "ycbv" / "test_targets_bop19.json", "w"))
    models = root / "ycbv" / "models_eval"
    os.makedirs(models)
    s = 30.0
    pts = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)])
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                      [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    with open(models / "obj_000005.ply", "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(pts)}\nproperty float x\nproperty float y\n"
                f"property float z\nelement face {len(faces)}\nproperty list uchar int vertex_indices\nend_header\n")
        f.writelines(f"{x} {y} {z}\n" for x, y, z in pts)
        f.writelines(f"3 {a} {b} {c}\n" for a, b, c in faces)
    json.dump({"5": {"diameter": float(np.linalg.norm(pts[0] - pts[7]))}}, open(models / "models_info.json", "w"))
    return str(root), str(root / "dets.json")


def _argv(root, det_path, out_dir, *extra):
    return ["--eval-only", "--device", "cpu", "--config", "unopose_tpu_torch.configs:eval_config",
            f"misc.output_dir={out_dir!r}", "misc.exp_name='e2e'",
            "test.instance_batch_size=2", f"dataloader.test.data_dir={root!r}",
            f"dataloader.test.detection_path={det_path!r}", *extra]


def _tiny():
    """The tiny eval config's model and loader sizes as command-line overrides."""
    from unopose_tpu_torch.configs import eval_config

    cfg = eval_config(tiny=True)
    test = cfg.dataloader.test
    return [f"model={dict(cfg.model)!r}"] + [f"dataloader.test.{k}={test[k]}" for k in
                                             ("img_size", "n_sample_observed_point", "n_sample_template_point")]


def _rows(csv):
    return [ln.split(",") for ln in open(csv).read().splitlines() if ln]


def test_launcher_eval_only_end_to_end(bop_tree, tmp_path, capsys):
    """One seven-column row per kept detection (the one under 0.25 dropped),
    finite orthonormal poses, the reference encoded once and reused by the
    other five instances, the scores JSON with a finite AR over both images
    and the stdout line, the per-object tables; and the same run with the
    template cache off gives the same rows (poses within 1e-4, the cache
    test's gate), with every reference through the forward."""
    root, det_path = bop_tree
    out = main_unopose.main(_argv(root, det_path, str(tmp_path / "out")) + _tiny())
    rows = _rows(out["csv"])
    assert out["rows"] == len(rows) == 2 * KEPT and all(len(r) == 7 for r in rows)
    assert {(int(r[0]), int(r[1]), int(r[2])) for r in rows} == {(48, i, 5) for i in IMAGES}
    R = np.stack([np.fromstring(r[4], sep=" ").reshape(3, 3) for r in rows])
    t = np.stack([np.fromstring(r[5], sep=" ") for r in rows])
    assert np.isfinite(R).all() and np.isfinite(t).all()
    assert np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max() < 1e-4
    stats = out["stats"]
    assert (stats["images"], stats["chunks"]) == (2, 4)  # 3 instances an image: a chunk of 2, one padded
    assert (stats["templates_encoded"], stats["template_calls"], stats["cache_hits"]) == (1, 1, 2 * KEPT - 1)
    scores = json.load(open(out["csv"].replace(".csv", "_scores.json")))
    assert scores == json.loads(json.dumps(out["scores"])) and np.isfinite(scores["AR"]) and scores["n_images"] == 2
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == {"AR": scores["AR"], "n_images": 2}
    for suffix in ("row", "col"):
        tab = open(out["csv"][:-4] + f"_tab_obj_{suffix}.txt").read()
        assert "Avg" in tab and "AR" in tab and "006_mustard_bottle" in tab
    dets = json.load(open(out["csv"].replace(".csv", ".json")))
    assert sum("pred_R" in d for v in dets.values() for d in v) == len(rows)

    plain = main_unopose.main(_argv(root, det_path, str(tmp_path / "plain"), "test.template_cache=False") + _tiny())
    assert "cache_hits" not in plain["stats"]
    for a, b in zip(rows, _rows(plain["csv"])):
        assert a[:3] == b[:3]
        for col in (3, 4, 5):
            assert np.abs(np.fromstring(a[col], sep=" ") - np.fromstring(b[col], sep=" ")).max() <= 1e-4 * (
                1000.0 if col == 5 else 1.0)


def test_launcher_refusals(bop_tree, tmp_path, monkeypatch):
    """More ranks than cards raise before any rank is spawned; an explicit
    ``misc.load_from`` that holds no checkpoint raises; the card is the
    default device and its absence raises, for training and for
    ``--eval-only``."""
    import torch

    root, det_path = bop_tree
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        m.setattr(main_unopose.mesh, "free_port", lambda: pytest.fail("a rank was to be spawned"))
        with pytest.raises(RuntimeError, match="fewer cards than ranks"):
            main_unopose.main(["--num-devices", "2", "--synthetic-data"])
    os.makedirs(tmp_path / "ckpt")
    with pytest.raises(FileNotFoundError, match="holds no restorable checkpoint"):
        main_unopose.main(_argv(root, det_path, str(tmp_path / "o"), f"misc.load_from={str(tmp_path / 'ckpt')!r}")
                          + _tiny())
    args = main_unopose.parse_args(["--eval-only"])
    assert args.device == "cuda" and args.config == main_unopose.DEFAULT_CONFIG
    if not torch.cuda.is_available():
        for argv in (["--eval-only"], ["--synthetic-data"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main_unopose.main(argv)
