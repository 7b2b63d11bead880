"""The evaluation pipeline and its BOP19 CSV writer (counterpart of
``unopose_tpu/engine/inference.py``).

Per test image: the detected instances are cut into chunks of
``instance_batch_size`` pairs, the last chunk padded by repeating its last
pair so that every model call has one shape; each predicted relative pose
is composed with the reference's camera pose into the object frame
(pose_tgt_obj = pose_tgt_ref @ pose_camref_obj) and written as a BOP19 CSV
row ``scene_id,im_id,obj_id,score,R(9),t(mm),time``, the time being the
image's wall clock plus its segmentation time. With a ``template_fn``
(``make_template_fn``) each distinct reference is encoded once, in padded
batches, and its outputs are reused by every chunk and image that names
it (``TemplateCache``).

The model side runs in torch on the model's device (``make_infer_fn``,
``make_template_fn``); the rest is numpy on the host, as in the JAX
package, and the outputs come back as numpy float32 before the same
composition and formatting, so that equal poses give byte-equal rows.
"""

from __future__ import annotations

import json
import logging
import time
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def pad_to(x, n: int):
    """Pad dim 0 of a numpy array or a tensor to ``n`` by repeating its last row."""
    if x.shape[0] == n:
        return x
    if torch.is_tensor(x):
        return torch.cat([x, x[-1:].expand(n - x.shape[0], *x.shape[1:])])
    return np.concatenate([x, np.repeat(x[-1:], n - x.shape[0], axis=0)], axis=0)


def shard_indices(n: int, num_shards: int, shard_index: int) -> range:
    """Shard ``shard_index``'s contiguous part of an exact split of [0, n)."""
    sizes = [n // num_shards + (1 if r < n % num_shards else 0) for r in range(num_shards)]
    start = sum(sizes[:shard_index])
    return range(start, start + sizes[shard_index])


def prefetch_items(dataset, indices=None, depth: int = 2):
    """``dataset[i]`` read ahead on a background thread, so that the host's
    reading (RLE decode, crop, backprojection) overlaps the model. An error
    in the reader is raised here, at the item it stopped on."""
    import queue
    import threading

    if indices is None:
        indices = range(len(dataset))
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    SENTINEL = object()

    def worker():
        try:
            for i in indices:
                q.put((dataset[i], None))
        except Exception as e:  # handed to the consumer, which raises it
            q.put((None, e))
        finally:
            q.put((SENTINEL, None))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item, error = q.get()
        if error is not None:
            raise error
        if item is SENTINEL:
            return
        yield item


def _timed(items, waited: list):
    """``items``, adding to ``waited[0]`` the seconds spent waiting for each."""
    it = iter(items)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            waited[0] += time.perf_counter() - t0
        yield item


class TemplateCache:
    """LRU of ``template_fn``'s outputs per reference, keyed by the
    instance's ``ref_key`` (ref_scene_id, ref_im_id, obj_id). An entry is a
    row of each output: numpy arrays, or tensors on the model's device.
    ``encoded`` counts the references encoded, ``calls`` the calls of
    ``template_fn`` and ``hits`` the instances served without encoding."""

    def __init__(self, template_fn: Callable, batch_size: int = 16, max_entries: int = 256):
        self.template_fn = template_fn
        self.bs = batch_size
        self.max_entries = max_entries
        self._store: "OrderedDict[tuple, Dict]" = OrderedDict()
        self.encoded = self.calls = self.hits = 0

    def ensure(self, data: Dict[str, np.ndarray]) -> None:
        """Encode and store every reference of this image's instances that
        the cache does not hold, ``batch_size`` at a time (padded)."""
        keys = [tuple(int(v) for v in k) for k in data["ref_key"]]
        missing, seen = [], set()
        for j, k in enumerate(keys):
            if k not in self._store and k not in seen:
                missing.append(j)
                seen.add(k)
        self.hits += len(keys) - len(missing)
        for start in range(0, len(missing), self.bs):
            rows = missing[start: start + self.bs]
            tem = {k: pad_to(data[k][rows], self.bs) for k in ("tem1_rgb", "tem1_choose", "tem1_pts")}
            out = self.template_fn(tem)
            self.calls += 1
            self.encoded += len(rows)
            for jj, row in enumerate(rows):
                self._store[keys[row]] = {k: v[jj] for k, v in out.items()}
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)

    def gather(self, data: Dict[str, np.ndarray], rows: range) -> Dict:
        entries = [self._store[tuple(int(v) for v in data["ref_key"][j])] for j in rows]
        stack = torch.stack if torch.is_tensor(next(iter(entries[0].values()))) else np.stack
        return {k: stack([e[k] for e in entries]) for k in entries[0]}


def run_inference(
    infer_fn: Callable,
    dataset,
    save_path: str,
    instance_batch_size: int = 16,
    rng_seed: int = 0,
    num_shards: int = 1,
    shard_index: int = 0,
    template_fn: Optional[Callable] = None,
    stats: Optional[dict] = None,
) -> List[str]:
    """``infer_fn(inputs, generator)``: inputs a dict of (B, ...) arrays ->
    dict of numpy ``pred_R`` (B, 3, 3), ``pred_t`` (B, 3) [m] and
    ``pred_pose_score`` (B,); its coarse search draws once per chunk from
    ``generator``, a ``torch.Generator`` on ``infer_fn.device`` (the CPU
    where it has none) seeded ``rng_seed + shard_index``.

    ``dataset``: a ``BOPTestsetPoseFreeOneRef``. Writes the BOP19 CSV to
    ``save_path`` and the detections with their predicted poses to the
    ``.json`` beside it; returns the CSV's lines. With ``template_fn``
    (``make_template_fn``) the references go through a ``TemplateCache``.
    Shard ``shard_index`` of ``num_shards`` takes its contiguous part of
    the images and writes ``save_path`` with a ``.rank<N>`` suffix where
    N > 0 (``merge_csv_shards`` joins them). ``stats``, if given, receives
    the images, chunks, each chunk's ms (the call and its outputs' return
    to the host), the seconds from the start to each image's end
    (``image_end_s``), the total seconds, the seconds spent waiting for the
    reader (``wait_s``) and the cache's counts.
    """
    my_indices = shard_indices(len(dataset), num_shards, shard_index)
    if num_shards > 1 and shard_index > 0:
        save_path = f"{save_path}.rank{shard_index}"

    bs = instance_batch_size
    lines: List[str] = []
    dets_out = {k: [dict(d) for d in v] for k, v in dataset.dets.items()}
    generator = torch.Generator(device=getattr(infer_fn, "device", "cpu"))
    generator.manual_seed(rng_seed + shard_index)

    cache = TemplateCache(template_fn, bs) if template_fn is not None else None
    model_keys = ("pts", "rgb", "rgb_choose", "tem1_rgb", "tem1_choose", "tem1_pts")
    if cache is not None:
        model_keys = ("pts", "rgb", "rgb_choose")
    chunk_ms: List[float] = []
    image_end_s: List[float] = []
    waited = [0.0]
    t_start = time.perf_counter()
    for i, data in enumerate(_timed(prefetch_items(dataset, my_indices), waited)):
        t0 = time.perf_counter()
        n_instance = data["pts"].shape[0]
        n_chunks = int(np.ceil(n_instance / bs))
        if cache is not None:
            cache.ensure(data)

        pred_Rs, pred_Ts, pred_scores = [], [], []
        for j in range(n_chunks):
            sl = slice(j * bs, min((j + 1) * bs, n_instance))
            n_valid = sl.stop - sl.start
            inputs = {k: pad_to(data[k][sl], bs) for k in model_keys}
            if cache is not None:
                inputs.update({k: pad_to(v, bs) for k, v in cache.gather(data, range(sl.start, sl.stop)).items()})
            tc = time.perf_counter()
            out = infer_fn(inputs, generator)
            pred_R = np.asarray(out["pred_R"])[:n_valid]
            pred_t = np.asarray(out["pred_t"])[:n_valid]
            score = np.asarray(out["pred_pose_score"])[:n_valid]
            chunk_ms.append((time.perf_counter() - tc) * 1e3)

            pose_ref_obj = data["tem1_pose"][sl]  # (n, 4, 4)
            pose_tgt_ref = np.tile(np.eye(4, dtype=np.float32), (n_valid, 1, 1))
            pose_tgt_ref[:, :3, :3] = pred_R
            pose_tgt_ref[:, :3, 3] = pred_t
            pose_tgt_obj = pose_tgt_ref @ pose_ref_obj
            pred_Rs.append(pose_tgt_obj[:, :3, :3])
            pred_Ts.append(pose_tgt_obj[:, :3, 3])
            pred_scores.append(score)

        pred_Rs = np.concatenate(pred_Rs).reshape(-1, 9)
        pred_Ts = np.concatenate(pred_Ts) * 1000.0  # m -> mm
        pred_scores = np.concatenate(pred_scores) * data["score"][:, 0]
        image_time = time.perf_counter() - t0 + float(data["seg_time"][0])

        scene_id = int(data["scene_id"][0])
        img_id = int(data["img_id"][0])
        det_key = f"{scene_id:06d}_{img_id:06d}"
        for k in range(n_instance):
            inst_i = int(data["inst_ids"][k])
            dets_out[det_key][inst_i]["pred_R"] = pred_Rs[k].tolist()
            dets_out[det_key][inst_i]["pred_t"] = pred_Ts[k].tolist()
            lines.append(
                ",".join(
                    (
                        str(scene_id),
                        str(img_id),
                        str(int(data["obj_id"][k, 0])),
                        str(pred_scores[k]),
                        " ".join(str(v) for v in pred_Rs[k]),
                        " ".join(str(v) for v in pred_Ts[k]),
                        f"{image_time}\n",
                    )
                )
            )
        image_end_s.append(time.perf_counter() - t_start)
        if (i + 1) % 50 == 0:
            logger.info("inference [%d/%d]", i + 1, len(my_indices))

    with open(save_path, "w") as f:
        f.writelines(lines)
    logger.info("saved to %s", save_path)
    Path(save_path.replace(".csv", ".json")).write_text(json.dumps(dets_out))
    if stats is not None:
        stats.update(images=len(my_indices), chunks=len(chunk_ms), chunk_ms=chunk_ms, image_end_s=image_end_s,
                     seconds=time.perf_counter() - t_start, wait_s=waited[0])
        if cache is not None:
            stats.update(templates_encoded=cache.encoded, template_calls=cache.calls, cache_hits=cache.hits)
    return lines


def merge_csv_shards(save_path: str, num_shards: int, strict: bool = True) -> None:
    """Join the shards' CSVs (shard 0 is ``save_path`` itself) into
    ``save_path``, and their detection JSONs into shard 0's ``.json``. A
    missing shard means its process died before writing; scoring a partial
    CSV would misreport the recall, so ``strict`` raises."""
    parts = [Path(save_path)] + [Path(f"{save_path}.rank{r}") for r in range(1, num_shards)]
    missing = [str(p) for p in parts if not p.exists()]
    if missing:
        msg = f"missing {len(missing)}/{num_shards} result shard(s): {missing}"
        if strict:
            raise FileNotFoundError(msg)
        logger.error("%s; merging the rest anyway (strict=False)", msg)
    text = "".join(p.read_text() for p in parts if p.exists())
    Path(save_path).write_text(text)

    # every shard dumps the whole detection table with the poses of its own
    # images: take each detection's pose from the shard that has it
    json_parts = [Path(str(p).replace(".csv", ".json")) for p in parts]
    if json_parts[0].exists():
        merged = json.loads(json_parts[0].read_text())
        for p in json_parts[1:]:
            if not p.exists():
                continue
            for det_key, dets in json.loads(p.read_text()).items():
                for i, d in enumerate(dets):
                    if "pred_R" in d and "pred_R" not in merged[det_key][i]:
                        merged[det_key][i] = d
        json_parts[0].write_text(json.dumps(merged))


def _to_device(inputs: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in inputs.items()}


def make_infer_fn(model, device):
    """``run_inference``'s ``infer_fn`` for ``model`` on ``device``: the
    padded chunk to the device, one inference forward drawing from the
    generator, the poses back as numpy float32. ``.device`` names the
    device of its draws."""
    device = torch.device(device)

    def infer(inputs, generator):
        out = model(_to_device(inputs, device), generator=generator)
        return {k: out[k].float().cpu().numpy() for k in ("pred_R", "pred_t", "pred_pose_score")}

    infer.device = device
    return infer


def make_template_fn(model, device):
    """``run_inference``'s ``template_fn`` for ``model`` on ``device``:
    ``model.encode_template`` of a padded batch of references; its outputs
    stay on the device, where the cache keeps them."""
    device = torch.device(device)

    def encode(tem_inputs):
        t = _to_device(tem_inputs, device)
        return model.encode_template(t["tem1_rgb"], t["tem1_choose"], t["tem1_pts"])

    encode.device = device
    return encode
