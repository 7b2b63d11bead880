"""The launcher's logging and the training metric writers (counterpart of
``unopose_tpu/utils/writer.py``): each writer is an object with
``write(step, metrics)`` and ``close()``; ``MultiWriter`` fans out to
several, and ``write_image`` / ``write_histogram`` reach those that have
them."""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
import time
from typing import Dict, Optional

logger = logging.getLogger("unopose_tpu_torch")


class JSONWriter:
    """``metrics.json``: one JSON object a logged step, ``{"iteration": step, ...}``, appended."""

    def __init__(self, path: str):
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        self.path = path
        self._fh = open(path, "a")

    def write(self, step: int, metrics: Dict[str, float]):
        rec = {"iteration": step, **{k: float(v) for k, v in metrics.items()}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()


class ConsolePrinter:
    """A log line a logged step: the iteration, the ETA from the rate since the
    first logged step, the loss terms, the gradient norm and the step time."""

    def __init__(self, max_iter: int):
        self.max_iter = max_iter
        self._t0 = time.perf_counter()
        self._step0: Optional[int] = None

    def write(self, step: int, metrics: Dict[str, float]):
        if self._step0 is None:
            self._step0 = step
        done = max(step - self._step0, 1)
        rate = (time.perf_counter() - self._t0) / done
        eta = rate * (self.max_iter - step)
        keys = [k for k in sorted(metrics) if "loss" in k or k in ("grad_norm", "iter_time")]
        msg = "  ".join(f"{k}: {metrics[k]:.4g}" for k in keys)
        logger.info("iter %d/%d  eta %.0fs  %s", step, self.max_iter, eta, msg)


class TensorboardWriter:
    """Scalars, images and histograms to TensorBoard event files; a no-op
    where ``torch.utils.tensorboard`` does not import."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self.tb = None
        else:
            self.tb = SummaryWriter(log_dir)

    def write(self, step: int, metrics: Dict[str, float]):
        if self.tb is None:
            return
        for k, v in metrics.items():
            self.tb.add_scalar(k, float(v), step)

    def write_image(self, step: int, tag: str, img):
        """img: (H, W, 3) uint8, or float in [0, 1]."""
        if self.tb is not None:
            self.tb.add_image(tag, img, step, dataformats="HWC")

    def write_histogram(self, step: int, tag: str, values):
        if self.tb is not None:
            import numpy as np

            self.tb.add_histogram(tag, np.asarray(values).reshape(-1), step)

    def close(self):
        if self.tb is not None:
            self.tb.close()


class MultiWriter:
    """The given writers, ``None`` ones left out."""

    def __init__(self, *writers):
        self.writers = [w for w in writers if w is not None]

    def write(self, step: int, metrics: Dict[str, float]):
        for w in self.writers:
            w.write(step, metrics)

    def write_image(self, step: int, tag: str, img):
        for w in self.writers:
            if hasattr(w, "write_image"):
                w.write_image(step, tag, img)

    def write_histogram(self, step: int, tag: str, values):
        for w in self.writers:
            if hasattr(w, "write_histogram"):
                w.write_histogram(step, tag, values)

    def close(self):
        for w in self.writers:
            if hasattr(w, "close"):
                w.close()


def setup_logger(output_dir: Optional[str] = None, rank: int = 0, name: str = "unopose_tpu_torch"):
    """The ``name`` logger at INFO: to stderr, and to ``output_dir/log.txt``
    (``log.rank<N>.txt`` on rank N > 0) when ``output_dir`` is given."""
    fmt = logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s", datefmt="%H:%M:%S")
    root = logging.getLogger(name)
    root.setLevel(logging.INFO)
    if not root.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        root.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        suffix = f".rank{rank}" if rank else ""
        path = osp.abspath(osp.join(output_dir, f"log{suffix}.txt"))
        if not any(getattr(h, "baseFilename", None) == path for h in root.handlers):
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            root.addHandler(fh)
    return root
