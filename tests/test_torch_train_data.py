"""The training launcher's host side against the JAX package (CPU): the
launcher's config, the train-side preprocessing, the colour augmentation,
the MegaPose reader, the loaders, the metric writers and the drawing
helpers. Same files, same seeds, same draws: every array is held bitwise
equal to JAX's unless a test says otherwise."""

import importlib
import json
import logging
import os
import sys
import threading
import time

import numpy as np
import pytest

import cv2

from test_datasets import K, _write_sample, fake_megapose  # noqa: F401  (fixture)
from test_torch_package import _assert_subset
from unopose_tpu.utils.config import CN
from unopose_tpu_torch import configs
from unopose_tpu_torch.configs import TINY_SIZES, main_config, train_config
from unopose_tpu_torch.data import color_aug, dataset_train, loader, preprocess
from unopose_tpu_torch.utils import vis, writer

jpre = importlib.import_module("unopose_tpu.data.preprocess")
jaug = importlib.import_module("unopose_tpu.data.color_aug")
jds = importlib.import_module("unopose_tpu.data.dataset_train")
jloader = importlib.import_module("unopose_tpu.data.loader")
jwriter = importlib.import_module("unopose_tpu.utils.writer")
jvis = importlib.import_module("unopose_tpu.utils.vis")


def assert_same(a, b, path=""):
    """Two samples or batches: the same keys, each array bitwise equal with the same dtype."""
    if a is None or b is None:
        assert a is None and b is None, path
        return
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (path, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}{k}")


# ------------------------------------------------------------------ the config
@pytest.mark.parametrize("tiny", [False, True])
def test_main_config_is_get_cfg(tiny):
    """Every key of ``main_config`` equals ``get_cfg()``'s (or the tiny
    form's, ``get_tiny_cfg`` at the tiny sizes with the PE budgets 64/256),
    with the model section ``train_config``'s and the test sections
    ``eval_config``'s; ``get_cfg()``'s train loader keys are all there."""
    from unopose_tpu.configs.main_cfg import get_cfg, get_tiny_cfg

    cfg = main_config(tiny)
    if tiny:
        ref = get_tiny_cfg(img_size=TINY_SIZES["img"], n_pts=TINY_SIZES["npts"], coarse_npoint=16,
                           n_tem=TINY_SIZES["ntem"])
        ref.model.fine_point_matching.merge(dict(nsample1=64, nsample2=256))
        ref.dataloader.test.merge({k: ref.dataloader.train[k] for k in ("img_size", "n_sample_observed_point",
                                                                         "n_sample_template_point")})
    else:
        ref = get_cfg()
    ref.model.use_ref_rad = False
    model = train_config(tiny).model
    model.feature_extraction.update(pretrained=not tiny, vit_ckpt=configs.VIT_CKPT)
    assert cfg.model == model
    assert set(cfg) == {"model", "optimizer", "lr_multiplier", "train", "misc", "test", "dataloader", "bop_eval"}
    for section in ("lr_multiplier", "train", "misc", "test", "bop_eval"):
        _assert_subset(cfg[section], ref[section], f"{section}.")
    _assert_subset({k: v for k, v in cfg.optimizer.items() if k != "betas"}, ref.optimizer, "optimizer.")
    assert tuple(cfg.optimizer.betas) == tuple(ref.optimizer.betas)
    _assert_subset(cfg.model, ref.model, "model.")
    assert set(cfg.dataloader) == {"train", "test"}
    assert cfg.dataloader.train == ref.dataloader.train
    _assert_subset(cfg.dataloader.test, ref.dataloader.test, "dataloader.test.")
    assert set(cfg.train) == {"max_iter", "eval_period", "checkpointer", "clip_grad", "seed", "log_period",
                              "vis_img_tbx", "backbone_dtype", "matcher_dtype"}
    assert (cfg.misc.train_batch_size, cfg.misc.world_size, cfg.train.checkpointer.period) == (32, 4, 5000)
    assert cfg.model.feature_extraction.pretrained == (not tiny)


# ------------------------------------------------------------------ preprocessing
def test_train_preprocess_matches_jax(tmp_path):
    """``dilate_mask``, ``io_load_gt`` and ``io_load_masks`` (all instances
    and chosen ones) bitwise equal to JAX's on a random mask file."""
    rng = np.random.default_rng(3)
    masks = {str(i): jpre.binary_mask_to_rle(rng.random((37, 53)) < 0.2 * (i + 1)) for i in range(3)}
    json.dump(masks, open(tmp_path / "m.json", "w"))
    gts = [dict(obj_id=i, cam_R_m2c=list(range(9)), cam_t_m2c=[0, 0, i]) for i in range(3)]
    json.dump(gts, open(tmp_path / "g.json", "w"))
    for ids in (None, [2], [0, 2]):
        np.testing.assert_array_equal(preprocess.io_load_masks(tmp_path / "m.json", ids),
                                      jpre.io_load_masks(tmp_path / "m.json", ids))
        assert preprocess.io_load_gt(tmp_path / "g.json", ids) == jpre.io_load_gt(tmp_path / "g.json", ids)
    m = preprocess.io_load_masks(tmp_path / "m.json")[0]
    for it in (1, 4):
        got, want = preprocess.dilate_mask(m, it), jpre.dilate_mask(m, it)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_load_im_reads_jpeg_without_imageio(tmp_path, monkeypatch):
    """With ``imageio`` hidden (the card's machine) the port reads the
    training shards' JPEGs with ``cv2``: bitwise equal to JAX's ``load_im``
    (imageio, Pillow's decoder) on random 240 x 320 images and a grey one
    (cv2 5.0.0 and Pillow 12.1.0 here agree bit for bit); PNGs still go
    through ``data/png.py``."""
    import imageio.v2 as imageio

    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        img = rng.integers(0, 255, (240, 320, 3)).astype(np.uint8)
        img[:120] = cv2.GaussianBlur(img[:120], (9, 9), 3)  # smooth and noisy halves
        paths.append(tmp_path / f"{i}.rgb.jpg")
        imageio.imwrite(paths[-1], img)
    paths.append(tmp_path / "grey.jpg")
    imageio.imwrite(paths[-1], rng.integers(0, 255, (40, 30)).astype(np.uint8))
    monkeypatch.setattr(preprocess, "imageio", None)
    for p in paths:
        got, want = preprocess.load_im(p), jpre.load_im(p)
        assert got.dtype == want.dtype and got.shape == want.shape, p
        np.testing.assert_array_equal(got, want)
    depth = rng.integers(0, 4000, (20, 30)).astype(np.uint16)
    imageio.imwrite(tmp_path / "d.png", depth)
    np.testing.assert_array_equal(preprocess.load_im(tmp_path / "d.png"), depth)
    with pytest.raises(FileNotFoundError):
        preprocess.load_im(tmp_path / "missing.jpg")


# ------------------------------------------------------------------ colour augmentation
@pytest.mark.parametrize("seed", range(20))
def test_color_augmentor_matches_jax(seed):
    """The whole augmentor on a random crop, draw for draw from one seed: the
    image bitwise equal and both generators left in the same state."""
    img = np.random.default_rng(100 + seed).integers(0, 255, (61, 47, 3)).astype(np.uint8)
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    got, want = color_aug.ColorAugmentor()(r1, img), jaug.ColorAugmentor()(r2, img)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert r1.random() == r2.random()


class Fixed:
    """A generator whose ``uniform`` returns one end of its range."""

    def __init__(self, end):
        self.end = end

    def uniform(self, lo, hi):
        return lo if self.end == "lo" else hi


@pytest.mark.parametrize("end", ["lo", "hi"])
def test_color_enhancers_at_their_range_ends_match_jax(end):
    """Each of the four PIL enhancers at either end of its factor range,
    bitwise equal to JAX's ``_pil_enhance`` with the same enhancer."""
    from PIL import ImageEnhance

    img = np.random.default_rng(5).integers(0, 255, (33, 29, 3)).astype(np.uint8)
    names = dict(sharpness=ImageEnhance.Sharpness, contrast=ImageEnhance.Contrast,
                 brightness=ImageEnhance.Brightness, color=ImageEnhance.Color)
    for name, (enhancer, lo, hi) in color_aug.ENHANCERS.items():
        assert enhancer is names[name]
        got = color_aug._enhance(name)(Fixed(end), img)
        want = jaug._pil_enhance(Fixed(end), img, names[name], lo, hi)
        np.testing.assert_array_equal(got, want, err_msg=name)
    # the ranges are JAX's: its op list holds the same (lo, hi) pairs in the same order
    jops = jaug.ColorAugmentor().ops
    probe = Fixed(end)
    for i, name in zip(range(2, 6), color_aug.ENHANCERS):
        np.testing.assert_array_equal(jops[i][1](probe, img), color_aug.ColorAugmentor().ops[i][1](probe, img))


# ------------------------------------------------------------------ the MegaPose reader
def _extend(root, rng):
    """Add to ``tests/test_datasets.py``'s fake tree (keys 0-1 of object 3, a
    reference list naming key 1) an image for each ``None`` path: a missing
    file (2), no valid instance (3), an object with no reference (4), an
    empty mask (5), fewer than 32 points (6); a second object (7) whose
    reference lies in a key with no files (so ``_get_template`` fails), and
    a ShapeNetCore shard (8) with a reference of its own."""
    gso = os.path.join(root, "MegaPose-GSO", "train_pbr_web")
    shard = os.path.join(gso, "000000")
    keys = [f"000000_{i:06d}" for i in range(9)]
    for i in range(2, 8):
        _write_sample(os.path.join(shard, keys[i]), rng, obj_id=9 if i == 4 else 5 if i == 7 else 3)
    os.remove(os.path.join(shard, keys[2] + ".rgb.jpg"))
    for i, box in ((5, None), (6, (100, 104, 150, 154))):  # empty mask; a 4 x 4 one (16 points)
        m = np.zeros((240, 320), bool)
        if box:
            m[box[0]:box[1], box[2]:box[3]] = True
        json.dump({"0": jpre.binary_mask_to_rle(m)}, open(os.path.join(shard, keys[i] + ".mask_visib.json"), "w"))
    json.dump({k: 0 for k in keys[:8]}, open(os.path.join(gso, "key_to_shard.json"), "w"))
    json.dump({"3": [[0, keys[1], 0], [0, keys[0], 0]], "5": [[0, "000000_999999", 0]]},
              open(os.path.join(root, "megapose_gso_fixed_obj_id_to_visib0_8_scene_im_inst_ids.json"), "w"))
    json.dump({f"000000/{k}": ([] if i == 3 else [0]) for i, k in enumerate(keys[:8])},
              open(os.path.join(root, "megapose_gso_fixed_valid_inst_ids.json"), "w"))
    snc = os.path.join(root, "MegaPose-ShapeNetCore", "train_pbr_web")
    os.makedirs(os.path.join(snc, "000003"))
    _write_sample(os.path.join(snc, "000003", keys[8]), rng, obj_id=11, z=0.6)
    json.dump({keys[8]: 3}, open(os.path.join(snc, "key_to_shard.json"), "w"))
    json.dump({"11": [[3, keys[8], 0]]},
              open(os.path.join(root, "megapose_shapenetcore_fixed_obj_id_to_visib0_8_scene_im_inst_ids.json"), "w"))
    json.dump({f"000003/{keys[8]}": [0]}, open(os.path.join(root, "megapose_shapenetcore_fixed_valid_inst_ids.json"),
                                                "w"))
    return root


@pytest.fixture
def megapose_tree(fake_megapose):  # noqa: F811
    return _extend(fake_megapose, np.random.default_rng(1))


def _reader_cfg(root, **kw):
    return dict(data_dir=root, img_size=32, n_sample_observed_point=64, n_sample_template_point=96, shift_range=0.01,
                rgb_mask_flag=True, dilate_mask=True, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_megapose_reader_matches_jax(megapose_tree, seed):
    """``DatasetPoseFreeOneRef`` on the fake tree: the same images in the same
    order, ``reset()``'s epoch list, ``read_data`` of every image (``None``
    at the same five kinds of image, the same samples elsewhere), and
    ``ds[i]`` with its retries over the epoch, all from one seed."""
    cfg = _reader_cfg(megapose_tree)
    ours = dataset_train.DatasetPoseFreeOneRef(configs.Config(cfg), seed=seed)
    ref = jds.DatasetPoseFreeOneRef(CN(cfg), seed=seed)
    assert ours.dataset_paths == ref.dataset_paths and len(ours) == len(ref) == 9
    np.testing.assert_array_equal(ours.img_idx, ref.img_idx)
    nones = []
    for i in range(len(ours)):
        a, b = ours.read_data(i), ref.read_data(i)
        assert_same(a, b, f"read_data({i}).")
        if a is None:
            nones.append(i)
    # image 6's 16 points stay under 32 unless the draw dilates its mask (seed 0 does not)
    assert nones in ([2, 3, 4, 5, 6, 7], [2, 3, 4, 5, 7]) and (seed or 6 in nones), nones
    for i in range(len(ours)):
        assert_same(ours[i], ref[i], f"ds[{i}].")
    for n_epoch in (4, 20):  # fewer images than the tree (without replacement), more (with)
        ours.num_img_per_epoch = ref.num_img_per_epoch = n_epoch
        ours.reset(), ref.reset()
        assert len(ours.img_idx) == n_epoch
        np.testing.assert_array_equal(ours.img_idx, ref.img_idx)
    assert ours.rng.random() == ref.rng.random()


def test_megapose_reader_without_imageio_and_bgr(megapose_tree, monkeypatch):
    """The reader with ``imageio`` hidden (JPEGs through cv2) and
    ``rgb_to_bgr``, still sample for sample JAX's."""
    cfg = _reader_cfg(megapose_tree, rgb_to_bgr=True)
    monkeypatch.setattr(preprocess, "imageio", None)
    ours = dataset_train.DatasetPoseFreeOneRef(configs.Config(cfg), num_img_per_epoch=3, seed=4)
    ref = jds.DatasetPoseFreeOneRef(CN(cfg), num_img_per_epoch=3, seed=4)
    for i in range(3):
        assert_same(ours[i], ref[i], f"ds[{i}].")


# ------------------------------------------------------------------ the loaders
def test_synthetic_train_iter_matches_jax():
    """Three batches of ``synthetic_train_iter`` at two sizes, JAX's draw for draw (the camera included)."""
    for kw in (dict(batch_size=2, img_size=28, n_pts=64, n_tem=96, seed=3), dict(batch_size=1, seed=0)):
        ours, ref = loader.synthetic_train_iter(**kw), jloader.synthetic_train_iter(**kw)
        for _ in range(3 if "img_size" in kw else 1):
            assert_same(next(ours), next(ref))
    assert loader.synthetic_train_iter is not None and configs.synthetic_train_inputs.__module__ == configs.__name__


def _loader_threads(before):
    return [t for t in threading.enumerate() if t not in before]


def test_train_loader_matches_jax_and_stops(megapose_tree):
    """``train_loader`` over the reader with one worker: the same batches as
    JAX's loader over JAX's reader. The feeder's ``reset()`` and the worker's
    reads draw from the reader's one generator, so the epoch (40 images) is
    longer than what the feeder can queue ahead of 3 batches: no reset runs
    while the compared samples are read, and one worker keeps the order.
    Closing the generator stops the feeder and the worker within 2 s, though
    both wait on full queues."""
    cfg = _reader_cfg(megapose_tree)
    before = set(threading.enumerate())
    ours = loader.train_loader(dataset_train.DatasetPoseFreeOneRef(configs.Config(cfg), num_img_per_epoch=40, seed=2),
                               batch_size=2, num_workers=1, seed=7)
    ref = jloader.train_loader(jds.DatasetPoseFreeOneRef(CN(cfg), num_img_per_epoch=40, seed=2), batch_size=2,
                               num_workers=1, seed=7)
    try:
        first = next(ours)  # the generator starts its threads here
        threads = _loader_threads(before)
        assert len(threads) == 2
        assert_same(first, next(ref))
        for _ in range(2):
            assert_same(next(ours), next(ref))
        time.sleep(0.6)  # the queues fill: both threads wait to put
        t0 = time.perf_counter()
        ours.close()
        for t in threads:
            t.join(timeout=max(0.0, 2.0 - (time.perf_counter() - t0)))
        assert not any(t.is_alive() for t in threads), threads
    finally:
        ref.close()


def test_train_loader_resamples_each_epoch_and_raises_worker_errors():
    """The feeder calls ``reset()`` before each pass over the epoch and walks
    each epoch's indices in a random order, every index once (4 images an
    epoch, 5 batches of 2: JAX's ``test_train_loader_epoch_resample``); a
    sample that raises in a worker raises in the consumer."""

    class Fake:
        def __init__(self):
            self.resets = 0

        def __len__(self):
            return 4

        def reset(self):
            self.resets += 1

        def __getitem__(self, i):
            return {"x": np.full((2,), i, np.float32)}

    ds = Fake()
    it = loader.train_loader(ds, batch_size=2, num_workers=1, seed=0)
    xs = np.concatenate([next(it)["x"][:, 0] for _ in range(5)])
    it.close()
    assert ds.resets >= 2 and sorted(xs[:4]) == sorted(xs[4:8]) == [0, 1, 2, 3]

    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            raise ValueError(f"bad sample {i}")

    it = loader.train_loader(Broken(), batch_size=2, num_workers=2)
    with pytest.raises(RuntimeError, match="worker failed"):
        next(it)
    it.close()


# ------------------------------------------------------------------ the writers
def test_writers_match_jax(tmp_path, monkeypatch, caplog):
    """``JSONWriter``'s bytes and ``ConsolePrinter``'s lines (on one fake
    clock) equal JAX's; ``MultiWriter`` leaves out ``None`` and reaches only
    the writers with ``write_image``; ``TensorboardWriter`` is a no-op where
    ``torch.utils.tensorboard`` does not import."""
    metrics = [{"loss": 1.5, "grad_norm": np.float32(2.25), "fine_acc": 0.5}, {"loss": float("nan"), "iter_time": 3}]
    for mod, name in ((writer, "ours"), (jwriter, "ref")):
        w = mod.JSONWriter(str(tmp_path / name / "metrics.json"))
        for i, m in enumerate(metrics):
            w.write(10 * i, m)
        w.close()
    assert (tmp_path / "ours" / "metrics.json").read_bytes() == (tmp_path / "ref" / "metrics.json").read_bytes()

    clock = iter(np.arange(0.0, 100.0, 1.5))
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    lines = {}
    for mod in (writer, jwriter):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            p = mod.ConsolePrinter(max_iter=100)
            for i, m in enumerate(metrics):
                p.write(5 + 10 * i, {**m, "iter_time": 0.25})
        lines[mod] = [r.getMessage() for r in caplog.records]
    assert lines[writer] == lines[jwriter] and len(lines[writer]) == 2, lines

    class Images:
        def __init__(self):
            self.images = []

        def write(self, step, m):
            pass

        def write_image(self, step, tag, img):
            self.images.append((step, tag))

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tb = writer.TensorboardWriter(str(tmp_path / "tb"))
    assert tb.tb is None
    img = Images()
    multi = writer.MultiWriter(None, writer.JSONWriter(str(tmp_path / "m.json")), None, img, tb)
    assert len(multi.writers) == 3
    multi.write(0, {"loss": 1.0})
    multi.write_image(0, "input_image", np.zeros((2, 2, 3), np.uint8))
    multi.write_histogram(0, "h", [1.0])
    multi.close()
    assert img.images == [(0, "input_image")] and json.loads((tmp_path / "m.json").read_text()) == {
        "iteration": 0, "loss": 1.0}


def test_vis_matches_jax():
    """``project_bbox3d`` and ``draw_projected_box3d`` equal JAX's."""
    rng = np.random.default_rng(0)
    box = np.array([[x, y, z] for z in (-0.05, 0.05) for x, y in ((-1, -1), (1, -1), (1, 1), (-1, 1))]) * 0.05
    R = configs.random_rotation_np(rng)
    t = np.array([0.01, -0.02, 0.7])
    qs = vis.project_bbox3d(box, K, R, t)
    np.testing.assert_array_equal(qs, jvis.project_bbox3d(box, K, R, t))
    img = rng.integers(0, 255, (240, 320, 3)).astype(np.uint8)
    got = vis.draw_projected_box3d(img.copy(), qs, color=(255, 0, 0), thickness=1)
    np.testing.assert_array_equal(got, jvis.draw_projected_box3d(img.copy(), qs, color=(255, 0, 0), thickness=1))
    assert (got != img).any()
