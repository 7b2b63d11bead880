"""Host-side batching for training (counterpart of
``unopose_tpu/data/loader.py``): ``train_loader``, an infinite shuffled
stream of a dataset's samples read by worker threads (cv2, PIL and numpy
release the interpreter lock for the heavy work) and collated into
channels-last numpy batches; ``synthetic_train_iter``, the in-memory
batches of smoke runs."""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, Iterator

import numpy as np

from unopose_tpu_torch.configs import synthetic_train_inputs

logger = logging.getLogger(__name__)


def collate(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def train_loader(dataset, batch_size: int, num_workers: int = 4, seed: int = 0,
                 prefetch: int = 4) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of ``batch_size`` batches. A feeder thread walks each
    epoch's index list in a random order (``seed``), calling the dataset's
    ``reset()`` before each epoch to resample its images; ``num_workers``
    threads read the samples. Closing the generator (or dropping it) sets a
    stop event that every thread watches, also while it waits on a full
    queue, so that no thread outlives the consumer for long. A sample that
    raises in a worker raises in the consumer."""
    rng = np.random.default_rng(seed)
    index_q: "queue.Queue[int]" = queue.Queue(maxsize=batch_size * 4)
    sample_q: "queue.Queue" = queue.Queue(maxsize=batch_size * prefetch)
    stop = threading.Event()

    def put_or_stop(q, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def feeder():
        epoch = 0
        while not stop.is_set():
            if hasattr(dataset, "reset"):
                dataset.reset()
                logger.info("train epoch %d: resampled %d images", epoch, len(dataset))
            epoch += 1
            for idx in rng.permutation(len(dataset)):
                if not put_or_stop(index_q, int(idx)):
                    return

    def worker():
        while not stop.is_set():
            try:
                idx = index_q.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                sample = dataset[idx]
            except Exception as e:  # handed to the consumer, which raises it
                sample = e
            if not put_or_stop(sample_q, sample):
                return

    threads = [threading.Thread(target=feeder, daemon=True)]
    threads += [threading.Thread(target=worker, daemon=True) for _ in range(max(1, num_workers))]
    for t in threads:
        t.start()
    try:
        while True:
            samples = [sample_q.get() for _ in range(batch_size)]
            for s in samples:
                if isinstance(s, Exception):
                    raise RuntimeError("a train loader worker failed") from s
            yield collate(samples)
    finally:
        stop.set()


def synthetic_train_iter(batch_size: int, img_size: int = 224, n_pts: int = 2048, n_tem: int = 5000,
                         seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless ``configs.synthetic_train_inputs`` batches from one generator
    seeded ``seed``: the observed cloud an SE(3) transform of a subset of the
    template cloud plus noise, with its pose as the labels."""
    rng = np.random.default_rng(seed)
    while True:
        yield synthetic_train_inputs(rng, batch_size, img=img_size, npts=n_pts, ntem=n_tem)
