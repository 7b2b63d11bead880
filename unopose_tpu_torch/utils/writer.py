"""Logging of the launcher (counterpart of ``unopose_tpu/utils/writer.py``;
the training metric writers are not ported yet)."""

from __future__ import annotations

import logging
import os
import os.path as osp
from typing import Optional


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
