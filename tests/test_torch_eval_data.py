"""The evaluation entry point's host side, PyTorch port against the JAX
package (CPU): the stdlib PNG reader and writer (against ``imageio``), the
crop resize, the preprocessing, the host library and
its numpy versions, the BOP test reader's items, the inference engine with
fake model functions, the PLY reader and the BOP19 evaluator.

Everything here is numpy on the host, computed by the same formulas in
both packages, so the gates are equality unless a test says otherwise.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from test_eval import _write_csv, cube_mesh, mini_bop, multi_det_bop  # noqa: F401 (fixtures)
from test_inference import FakeDataset, _fake_infer_fn, _fake_template_fn, _strip_time
from unopose_tpu_torch.data import native as tnative
from unopose_tpu_torch.data import preprocess as tpre
from unopose_tpu_torch.data.png import read_png, write_png
from unopose_tpu_torch.engine import inference as tinf
from unopose_tpu_torch.eval import bop_eval as tbop
from unopose_tpu_torch.eval.ply import load_ply

imageio = pytest.importorskip("imageio.v2")
jnative = importlib.import_module("unopose_tpu.data.native")
jpre = importlib.import_module("unopose_tpu.data.preprocess")
jinf = importlib.import_module("unopose_tpu.engine.inference")
jbop = importlib.import_module("unopose_tpu.eval.bop_eval")

K = np.array([[572.4, 0, 320.0], [0, 573.6, 240.0], [0, 0, 1.0]])
H, W = 480, 640
K_SMALL = np.array([[572.4, 0, 80.0], [0, 573.6, 60.0], [0, 0, 1.0]])  # the rasteriser's 160 x 120 image


# ------------------------------------------------------------------ PNG and resize
def _png_with_filter(path, img: np.ndarray, kind: int) -> None:
    """A PNG of an 8-bit (H, W, C) image whose every row uses filter ``kind``
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), encoded by the PNG formulas."""
    import struct
    import zlib

    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        cc = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if kind == 0:
            f = x
        elif kind == 1:
            f = x - a
        elif kind == 2:
            f = x - prev
        elif kind == 3:
            f = x - (a + prev) // 2
        else:
            p = a + prev - cc
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - cc)
            f = x - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, cc))
        out.append(bytes([kind]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = x

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_every_filter(tmp_path, channels):
    """Each of the five row filters, at 1-4 samples a pixel: ``read_png``
    equals the image and ``imageio``'s reading of the file."""
    img = np.random.default_rng(channels).integers(0, 256, (9, 13, channels)).astype(np.uint8)
    for kind in range(5):
        path = tmp_path / f"f{kind}.png"
        _png_with_filter(path, img, kind)
        got = read_png(path)
        want = img[..., 0] if channels == 1 else img
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, imageio.imread(path))


def test_png_reader_and_writer_against_imageio(tmp_path):
    """BOP's three kinds (8-bit RGB, 8-bit mask, 16-bit depth) written by
    ``imageio`` read equal by ``read_png``, and written by ``write_png`` read
    equal by ``imageio``; ``load_im`` without ``imageio`` reads the same."""
    rng = np.random.default_rng(0)
    cases = dict(rgb=rng.integers(0, 256, (48, 64, 3)).astype(np.uint8),
                 mask=(rng.uniform(size=(48, 64)) > 0.5).astype(np.uint8) * 255,
                 depth=rng.integers(0, 65536, (48, 64)).astype(np.uint16),
                 smooth=(np.add.outer(np.arange(48), np.arange(64)) % 256).astype(np.uint8))
    for name, img in cases.items():
        theirs, ours = tmp_path / f"{name}.png", tmp_path / f"{name}_own.png"
        imageio.imwrite(theirs, img)
        write_png(ours, img)
        for path in (theirs, ours):
            got = read_png(path)
            assert got.dtype == img.dtype
            np.testing.assert_array_equal(got, img)
            np.testing.assert_array_equal(imageio.imread(path), img)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tpre, "imageio", None)
            np.testing.assert_array_equal(tpre.load_im(theirs), img)
    with pytest.raises(ValueError):
        write_png(tmp_path / "x.png", np.zeros((4, 4), np.float32))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2, 3), (7, 7), (28, 28, 3), (55, 55, 3), (56, 56), (111, 111, 3),
                                   (120, 120, 3), (224, 224, 3), (300, 300), (448, 448, 3), (480, 480, 3), (37, 90, 3)])
def test_crop_resize_matches_jax(shape):
    """The reader's crop resize on uint8 crops growing and shrinking to 28,
    32 and 224, and the remap of a crop's flat indices into the resized
    crop: equal to JAX's, pixel for pixel and index for index."""
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape).astype(np.uint8)
    bbox = [3, 3 + shape[0], 5, 5 + shape[1]]
    choose = rng.integers(0, shape[0] * shape[1], 200)
    for size in (28, 32, 224):
        got = tpre.resize_linear(img, size)
        assert got.shape[:2] == (size, size) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jpre.resize_linear(img, size))
        np.testing.assert_array_equal(tpre.get_resize_rgb_choose(choose, bbox, size),
                                      jpre.get_resize_rgb_choose(choose, bbox, size))


# ------------------------------------------------------------------ preprocessing and the host library
def test_preprocess_matches_jax():
    """The preprocessing functions on seeded inputs equal JAX's."""
    rng = np.random.default_rng(2)
    mask = np.zeros((H, W), bool)
    mask[100:180, 250:300] = rng.uniform(size=(80, 50)) > 0.2
    rle = tpre.binary_mask_to_rle(mask)
    assert rle == jpre.binary_mask_to_rle(mask)
    np.testing.assert_array_equal(tpre.rle_to_binary_mask(rle), jpre.rle_to_binary_mask(rle))
    np.testing.assert_array_equal(tpre.rle_to_binary_mask(rle), mask)
    for m in (mask, np.pad(np.ones((5, 9), bool), ((0, H - 5), (W - 9, 0)))):
        assert tpre.get_bbox(m) == jpre.get_bbox(m)
    depth = rng.uniform(0.5, 2, (H, W)).astype(np.float32)
    bbox = tpre.get_bbox(mask)
    np.testing.assert_array_equal(tpre.backproject_np(depth, K, bbox), jpre.backproject_np(depth, K, bbox))
    choose = rng.integers(0, 80 * 80, 500)
    np.testing.assert_array_equal(tpre.get_resize_rgb_choose(choose, bbox, 224),
                                  jpre.get_resize_rgb_choose(choose, bbox, 224))
    rgb = rng.integers(0, 256, (50, 50, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tpre.normalize_rgb(rgb), jpre.normalize_rgb(rgb))
    np.testing.assert_array_equal(tpre.resize_linear(rgb, 32), jpre.resize_linear(rgb, 32))
    for n_avail in (10, 5000):
        np.testing.assert_array_equal(tpre.sample_choose(np.random.default_rng(3), n_avail, 100),
                                      jpre.sample_choose(np.random.default_rng(3), n_avail, 100))


def _compressed_rle(counts) -> str:
    """COCO's compressed RLE string of uncompressed counts."""
    s = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c & 0x10)) and not (x == -1 and (c & 0x10))
            s.append(chr((c | 0x20 if more else c) + 48))
    return "".join(s)


def _native_outputs():
    rng = np.random.default_rng(5)
    mask = rng.uniform(size=(37, 53)) > 0.6
    rle = tpre.binary_mask_to_rle(mask)
    depth = rng.uniform(0.5, 2.0, size=(80, 90)).astype(np.float32)
    choose = rng.integers(0, depth.size, 300)
    pts, faces = cube_mesh(60.0)
    cam = (pts @ np.diag([1.0, -1.0, -1.0]).T + [10.0, -5.0, 700.0]).astype(np.float32)
    return dict(
        rle=tnative.rle_decode(rle["counts"], rle["size"]),
        counts=tnative.rle_decompress_counts(_compressed_rle([0, 4, 17, 1000, 3, 2, 70000, 1])),
        nonzero=tnative.mask_nonzero(mask.astype(np.uint8)),
        backproject=tnative.backproject_choose(depth, [100, 180, 200, 290], choose, K),
        raster=tnative.rasterize_depth(cam, faces, K_SMALL, 120, 160),
    ), (mask, rle, depth, choose, cam, faces)


def test_native_library_matches_jax():
    """The port's library (built from its own copy of the source) against the
    JAX package's library: every entry point equal."""
    assert tnative.have_native() and jnative.have_native()
    got, (mask, rle, depth, choose, cam, faces) = _native_outputs()
    np.testing.assert_array_equal(got["rle"], mask)
    np.testing.assert_array_equal(got["rle"], jnative.rle_decode(rle["counts"], rle["size"]))
    np.testing.assert_array_equal(got["counts"], [0, 4, 17, 1000, 3, 2, 70000, 1])
    np.testing.assert_array_equal(got["nonzero"], jnative.mask_nonzero(mask.astype(np.uint8)))
    np.testing.assert_array_equal(got["backproject"], jnative.backproject_choose(depth, [100, 180, 200, 290], choose, K))
    np.testing.assert_array_equal(got["raster"], jnative.rasterize_depth(cam, faces, K_SMALL, 120, 160))
    assert (got["raster"] > 0).sum() > 100


def test_native_numpy_versions_match_the_library(monkeypatch):
    """With the library off, the numpy versions give the library's results:
    equal, the backprojection within 1e-6 relative (float32 products in
    another order) and the rasteriser's numpy oracle within 1e-3 mm of the
    float32 depths (``eval/renderer.py:rasterize_exact`` in float64)."""
    from unopose_tpu_torch.eval.renderer import MeshRasterRenderer

    assert tnative.have_native()
    lib_out, (_, _, _, _, _, faces) = _native_outputs()
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    got, _ = _native_outputs()
    for k in ("rle", "counts", "nonzero"):
        np.testing.assert_array_equal(got[k], lib_out[k])
    np.testing.assert_allclose(got["backproject"], lib_out["backproject"], rtol=1e-6, atol=1e-7)
    assert got["raster"] is None
    pts, _ = cube_mesh(60.0)
    rend = MeshRasterRenderer(120, 160)
    rend.add_object(1, pts, faces)
    oracle = rend.render_depth(1, np.diag([1.0, -1.0, -1.0]), np.array([10.0, -5.0, 700.0]), K_SMALL)
    np.testing.assert_array_equal(oracle > 0, lib_out["raster"] > 0)
    assert np.abs(oracle - lib_out["raster"]).max() < 1e-3


# ------------------------------------------------------------------ the BOP test reader
@pytest.fixture
def bop_tree(tmp_path):
    """A BOP test scene (``test_datasets.fake_bop``'s layout at 480 x 640):
    images 1-3, image 3 the reference of both objects, detections with
    uncompressed and compressed RLE, one below ``seg_filter_score``, one
    image whose only detections are below it (the best-score fallback)."""
    rng = np.random.default_rng(1)
    root = tmp_path / "BOP_DATASETS"
    scene = root / "ycbv" / "test" / "000048"
    for sub in ("depth", "rgb", "mask_visib"):
        os.makedirs(scene / sub)
    depth = np.full((H, W), 1400, np.uint16)
    masks = {5: np.zeros((H, W), bool), 6: np.zeros((H, W), bool)}
    depth[90:150, 130:210] = 900
    masks[5][90:150, 130:210] = True
    depth[200:260, 300:350] = 800
    masks[6][200:260, 300:350] = True
    gt, cams = {}, {}
    for im_id in (1, 2, 3):
        imageio.imwrite(scene / "depth" / f"{im_id:06d}.png", depth)
        imageio.imwrite(scene / "rgb" / f"{im_id:06d}.png", rng.integers(0, 255, (H, W, 3)).astype(np.uint8))
        gt[str(im_id)] = []
        for i, (obj, z) in enumerate(((5, 900.0), (6, 800.0))):
            imageio.imwrite(scene / "mask_visib" / f"{im_id:06d}_{i:06d}.png", (masks[obj] * 255).astype(np.uint8))
            gt[str(im_id)].append(dict(obj_id=obj, cam_R_m2c=np.eye(3).reshape(-1).tolist(), cam_t_m2c=[0, 0, z]))
        cams[str(im_id)] = dict(cam_K=K.reshape(-1).tolist(), depth_scale=1.0)
    json.dump(gt, open(scene / "scene_gt.json", "w"))
    json.dump(cams, open(scene / "scene_camera.json", "w"))
    json.dump([dict(scene_id=48, im_id=i, obj_id=o, ref_scene_id=48, ref_im_id=3) for i in (1, 2) for o in (5, 6)],
              open(root / "ycbv" / "test_ref_targets_crossscene_rot50.json", "w"))
    shifted = np.roll(masks[5], (3, -2), axis=(0, 1))
    compressed = tpre.binary_mask_to_rle(masks[6])
    compressed["counts"] = _compressed_rle(compressed["counts"])
    dets = [
        dict(scene_id=48, image_id=1, category_id=5, score=0.9, time=0.1, segmentation=tpre.binary_mask_to_rle(masks[5])),
        dict(scene_id=48, image_id=1, category_id=6, score=0.7, time=0.1, segmentation=compressed),
        dict(scene_id=48, image_id=1, category_id=5, score=0.2, time=0.1, segmentation=tpre.binary_mask_to_rle(shifted)),
        dict(scene_id=48, image_id=1, category_id=5, score=0.5, time=0.1, segmentation=tpre.binary_mask_to_rle(shifted)),
        dict(scene_id=48, image_id=2, category_id=6, score=0.1, time=0.2, segmentation=tpre.binary_mask_to_rle(masks[6])),
        dict(scene_id=48, image_id=2, category_id=5, score=0.2, time=0.2, segmentation=tpre.binary_mask_to_rle(masks[5])),
    ]
    det_path = root / "dets.json"
    json.dump(dets, open(det_path, "w"))
    return str(root), str(det_path)


def _reader_cfg(root):
    return dict(data_dir=root, ref_targets_name="test_ref_targets_crossscene_rot50.json", img_size=32,
                n_sample_observed_point=128, n_sample_template_point=256, minimum_n_point=8, rgb_mask_flag=True,
                seg_filter_score=0.25)


def _items(module, cfg_cls, root, det_path):
    ds = module.BOPTestsetPoseFreeOneRef(cfg_cls(_reader_cfg(root)), eval_dataset_name="ycbv",
                                         detection_path=det_path)
    return ds, [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("host", ["imageio_cv2", "stdlib"])
def test_bop_test_reader_matches_jax(bop_tree, monkeypatch, host):
    """``BOPTestsetPoseFreeOneRef``'s items, array for array, equal JAX's
    (same seed, same draws), with ``imageio``, and with the port's stdlib
    PNG reader and numpy host functions in place of ``imageio`` and the
    host library."""
    from unopose_tpu.data import dataset_test as jds
    from unopose_tpu.utils.config import CN
    from unopose_tpu_torch.configs import Config
    from unopose_tpu_torch.data import dataset_test as tds

    root, det_path = bop_tree
    jds_, want = _items(jds, CN, root, det_path)
    if host == "stdlib":
        monkeypatch.setattr(tpre, "imageio", None)
        monkeypatch.setattr(tnative, "_lib", None)
        monkeypatch.setattr(tnative, "_tried", True)
    tds_, got = _items(tds, Config, root, det_path)
    assert tds_.det_keys == jds_.det_keys and tds_.dets == jds_.dets
    assert len(got) == 2 and got[0]["pts"].shape == (3, 128, 3) and got[1]["inst_ids"].tolist() == [1]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ------------------------------------------------------------------ the engine
def _fake_infer_gen(inputs, generator):
    return _fake_infer_fn(inputs, generator)


@pytest.mark.parametrize("cached", [False, True])
def test_run_inference_matches_jax(tmp_path, cached):
    """``run_inference`` with ``test_inference.py``'s fake model functions,
    padded chunks of 2, with and without the template cache: the CSV's rows
    equal JAX's byte for byte apart from the time column, and the JSON
    dumps equal."""
    ds = FakeDataset()
    kw = dict(instance_batch_size=2, num_shards=1, shard_index=0)
    tem_fn = _fake_template_fn if cached else None
    want = jinf.run_inference(_fake_infer_fn, ds, str(tmp_path / "jax.csv"), template_fn=tem_fn, **kw)
    stats = {}
    got = tinf.run_inference(_fake_infer_gen, ds, str(tmp_path / "port.csv"), template_fn=tem_fn, stats=stats, **kw)
    assert _strip_time(got) == _strip_time(want) and len(got) == 12
    assert _strip_time(open(tmp_path / "port.csv").read().splitlines(True)) == _strip_time(want)
    assert json.load(open(tmp_path / "port.json")) == json.load(open(tmp_path / "jax.json"))
    assert stats["images"] == 4 and stats["chunks"] == 8 and len(stats["chunk_ms"]) == 8
    ends = stats["image_end_s"]
    assert len(ends) == 4 and ends == sorted(ends) and 0 < ends[-1] <= stats["seconds"]
    if cached:
        assert (stats["templates_encoded"], stats["template_calls"], stats["cache_hits"]) == (2, 1, 10)


def test_run_inference_draws_and_shards(tmp_path):
    """One draw per chunk from a generator seeded ``rng_seed + shard_index``
    on ``infer_fn.device``; shard 1 of 2 takes its contiguous images and
    writes ``.rank1``, and ``merge_csv_shards`` joins the shards as JAX's."""
    ds = FakeDataset(n_images=5)
    seen = []

    def infer(inputs, generator):
        seen.append(torch.rand(1, generator=generator).item())
        return _fake_infer_fn(inputs, None)

    infer.device = torch.device("cpu")
    paths = {}
    for package, run in (("port", tinf.run_inference), ("jax", jinf.run_inference)):
        base = str(tmp_path / f"{package}.csv")
        for r in range(2):
            fn = infer if package == "port" else _fake_infer_fn
            run(fn, ds, base, instance_batch_size=2, rng_seed=3, num_shards=2, shard_index=r)
        paths[package] = base
    assert os.path.exists(paths["port"] + ".rank1")
    gen = torch.Generator().manual_seed(3)
    first = [torch.rand(1, generator=gen).item() for _ in range(6)]
    gen = torch.Generator().manual_seed(4)
    assert seen == first + [torch.rand(1, generator=gen).item() for _ in range(4)]
    tinf.merge_csv_shards(paths["port"], 2)
    jinf.merge_csv_shards(paths["jax"], 2)
    port, jax_ = (open(paths[p]).read().splitlines() for p in ("port", "jax"))
    assert _strip_time(port) == _strip_time(jax_) and len(port) == 15
    assert json.load(open(paths["port"].replace(".csv", ".json"))) == json.load(
        open(paths["jax"].replace(".csv", ".json")))
    assert list(tinf.shard_indices(10, 3, 1)) == list(jinf.shard_indices(10, 3, 1)) == [4, 5, 6]


def test_template_cache_and_shard_merge_like_jax(tmp_path):
    """``TemplateCache`` encodes each reference once in one padded batch and
    evicts the oldest past ``max_entries``; it stacks tensor entries;
    ``merge_csv_shards`` raises on a missing shard unless ``strict=False``
    (``test_inference.py``'s cases)."""
    ds = FakeDataset()
    calls = []
    cache = tinf.TemplateCache(lambda tem: calls.append(len(tem["tem1_pts"])) or _fake_template_fn(tem), 2)
    for i in range(len(ds)):
        cache.ensure(ds[i])
    assert calls == [2] and len(cache._store) == 2 and cache.hits == 10
    small = tinf.TemplateCache(lambda tem: {k: torch.from_numpy(v) for k, v in _fake_template_fn(tem).items()}, 4,
                               max_entries=2)
    data = dict(tem1_rgb=np.zeros((3, 4, 4, 3), np.float32), tem1_choose=np.zeros((3, 8), np.int32),
                tem1_pts=np.random.default_rng(0).normal(size=(3, 8, 3)).astype(np.float32),
                ref_key=np.asarray([[1, 1, 1], [2, 2, 2], [3, 3, 3]], np.int64))
    small.ensure(data)
    assert list(small._store) == [(2, 2, 2), (3, 3, 3)]
    out = small.gather(data, range(1, 3))
    assert torch.is_tensor(out["dense_po"]) and out["dense_po"].shape == (2, 4, 3)
    assert tinf.pad_to(out["dense_po"], 4).shape == (4, 4, 3) and torch.equal(tinf.pad_to(out["dense_po"], 4)[3],
                                                                                out["dense_po"][1])
    p = tmp_path / "result.csv"
    p.write_text("a\n")
    (tmp_path / "result.csv.rank2").write_text("c\n")
    with pytest.raises(FileNotFoundError, match="rank1"):
        tinf.merge_csv_shards(str(p), 3)
    tinf.merge_csv_shards(str(p), 3, strict=False)
    assert p.read_text() == "a\nc\n"


# ------------------------------------------------------------------ PLY and the evaluator
def test_ply_reader_matches_jax(tmp_path):
    """ASCII and binary little-endian PLYs read equal to JAX's reader."""
    from unopose_tpu.eval.ply import load_ply as jload

    pts, faces = cube_mesh()
    ascii_path, bin_path = tmp_path / "a.ply", tmp_path / "b.ply"
    with open(ascii_path, "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(pts)}\nproperty float x\nproperty float y\n"
                f"property float z\nelement face {len(faces)}\nproperty list uchar int vertex_indices\nend_header\n")
        f.writelines(f"{x} {y} {z}\n" for x, y, z in pts)
        f.writelines(f"3 {a} {b} {c}\n" for a, b, c in faces)
    with open(bin_path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\nelement vertex {len(pts)}\nproperty float x\n"
                 f"property float y\nproperty float z\nproperty uchar red\nelement face {len(faces)}\n"
                 f"property list uchar int vertex_indices\nend_header\n").encode())
        rec = np.zeros(len(pts), dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("r", "u1")])
        rec["x"], rec["y"], rec["z"] = pts.T
        f.write(rec.tobytes())
        for fc in faces:
            f.write(np.uint8(3).tobytes() + fc.astype("<i4").tobytes())
    for path in (ascii_path, bin_path):
        got, want = load_ply(str(path)), jload(str(path))
        for k in ("pts", "faces"):
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_allclose(got["pts"], pts)


def test_evaluate_bop_matches_jax_mini(mini_bop, tmp_path):
    """``evaluate_bop`` on ``test_eval.py``'s mini tree with its perfect,
    garbage and partial CSVs: every score equal to JAX's."""
    root, rngR = mini_bop
    rows = {
        "perfect": [(1, 1, 1, 0.9, rngR[0], [0, 0, 700.0]), (1, 2, 1, 0.9, rngR[1], [0, 0, 750.0])],
        "garbage": [(1, 1, 1, 0.9, rngR[0], [500, 500, 2000.0]), (1, 2, 1, 0.9, rngR[1], [-500, 0, 3000.0])],
        "partial": [(1, 1, 1, 0.9, rngR[0], [0, 0, 700.0]), (1, 2, 1, 0.9, rngR[1], [25.0, 0, 750.0])],
    }
    for name, r in rows.items():
        csv = tmp_path / f"{name}.csv"
        _write_csv(csv, r)
        got, want = tbop.evaluate_bop(str(csv), str(root)), jbop.evaluate_bop(str(csv), str(root))
        assert got == want, name
    assert got["mssd"]["average"] > 0.3


def test_evaluate_bop_matches_jax_multi_det(multi_det_bop, tmp_path):
    """``evaluate_bop`` on ``test_eval.py``'s multi-detection tree (n_top
    truncation, the most-visible GT rule, duplicate detections) with every
    extra error family, and a visibility threshold: equal to JAX's; the
    per-object tables and their dumps equal JAX's."""
    root, csv, *_ = multi_det_bop
    types = ("vsd", "mssd", "mspd", "add", "adi", "ad", "ABSad", "AUCad", "re", "te", "rete", "proj")
    for kw in (dict(error_types=types), dict(visib_gt_min=0.1, n_top=0)):
        got, want = tbop.evaluate_bop(csv, str(root), **kw), jbop.evaluate_bop(csv, str(root), **kw)
        assert got == want, kw
    id2obj = {1: "cube60", 2: "cube40"}
    assert tbop.format_per_object_tables(got, id2obj) == jbop.format_per_object_tables(want, id2obj)
    ours = tbop.write_per_object_tables(got, str(tmp_path / "ours.csv"), id2obj)
    theirs = jbop.write_per_object_tables(want, str(tmp_path / "theirs.csv"), id2obj)
    assert [open(p).read() for p in ours] == [open(p).read() for p in theirs]
    assert [os.path.basename(p) for p in ours] == ["ours_tab_obj_row.txt", "ours_tab_obj_col.txt"]
