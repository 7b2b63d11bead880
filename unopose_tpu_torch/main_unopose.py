"""Launcher (counterpart of ``unopose_tpu/main_unopose.py``)::

    python -m unopose_tpu_torch.main_unopose --eval-only
        [--config unopose_tpu_torch.configs:eval_config] [--device cuda] [key=value ...]

Loads the config, applies the dotted overrides, builds the model on the
card (``--device cpu`` for the plain versions) and runs the evaluation:
the BOP test reader -> ``engine/inference.py:run_inference`` (through the
template cache when ``test.template_cache`` is set) -> the BOP19 CSV and
the detections JSON -> ``eval/bop_eval.py:evaluate_bop`` when the dataset
holds ``test_targets_bop19.json`` -> the scores JSON, a stdout line with
AR and the image count, and the per-object tables. Training is not ported
to the launcher yet.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
import os.path as osp
from typing import Optional

import torch

logger = logging.getLogger("unopose_tpu_torch")

DEFAULT_CONFIG = "unopose_tpu_torch.configs:eval_config"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="unopose_tpu_torch launcher")
    p.add_argument("--config", default=DEFAULT_CONFIG, help="module:function returning the config")
    p.add_argument("--eval-only", action="store_true", help="run inference, write the BOP CSV and score it")
    p.add_argument("--device", default="cuda", help="the model's device (cpu for the plain versions)")
    p.add_argument("opts", nargs="*", help="dotted config overrides key=value")
    return p.parse_args(argv)


def load_cfg(spec: str):
    mod_name, _, fn_name = spec.partition(":")
    return getattr(importlib.import_module(mod_name), fn_name or "eval_config")()


def main(argv=None) -> Optional[dict]:
    """Run the launcher; with ``--eval-only`` returns ``run_eval``'s result."""
    args = parse_args(argv)
    cfg = load_cfg(args.config).apply_overrides(args.opts)
    if not args.eval_only:
        raise NotImplementedError("the train launcher is not ported yet (ROADMAP Queue 1 item 5); use --eval-only")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the launcher runs on the card (--device cpu for the plain versions)")

    from unopose_tpu_torch.models import UNOPose
    from unopose_tpu_torch.utils.writer import setup_logger

    out_dir = cfg.misc.output_dir
    setup_logger(out_dir)
    logger.info("config: %s", cfg.flatten())
    train = cfg.get("train", {})
    torch.manual_seed(0)  # the random weights' seed where no checkpoint is read
    model = UNOPose.from_config(cfg.model, dtype=DTYPES[train.get("matcher_dtype", "float32")],
                                backbone_dtype=DTYPES[train.get("backbone_dtype", "bfloat16")])
    restore_eval_variables(model, cfg)
    return run_eval(model.to(device).eval(), cfg, out_dir, device)


def restore_eval_variables(model, cfg) -> None:
    """The eval weights: a trained checkpoint (``misc.load_from``) is not
    readable by the port yet and raises; without one the model keeps its
    seeded random weights, a pipeline test only, and says so."""
    load_from = cfg.misc.get("load_from", "")
    if load_from:
        raise NotImplementedError(
            f"misc.load_from={load_from!r}: the port does not read trained checkpoints yet (ROADMAP Queue 1 item 3)")
    logger.warning("no trained checkpoint (misc.load_from unset): evaluating with fully random weights; results are a "
                   "pipeline test only")


def run_eval(model, cfg, out_dir: str, device, tag: str = "") -> dict:
    """Inference over the test set, the CSV and JSON, and the BOP19 scores
    where the targets are on disk. Returns the CSV's path and line count,
    ``run_inference``'s stats and the scores (None without targets)."""
    from unopose_tpu_torch.data.dataset_test import BOPTestsetPoseFreeOneRef
    from unopose_tpu_torch.engine.inference import make_infer_fn, make_template_fn, run_inference

    test = cfg.dataloader.test
    dataset = BOPTestsetPoseFreeOneRef(test, eval_dataset_name=test.eval_dataset_name,
                                       detection_path=test.detection_path)
    infer_fn = make_infer_fn(model, device)
    template_fn = make_template_fn(model, device) if cfg.test.get("template_cache", True) else None
    name = test.eval_dataset_name
    save_path = osp.join(out_dir, f"result_{cfg.misc.exp_name}{tag}_{name}-test.csv")
    os.makedirs(out_dir, exist_ok=True)
    stats: dict = {}
    lines = run_inference(infer_fn, dataset, save_path, instance_batch_size=cfg.test.instance_batch_size,
                          template_fn=template_fn, stats=stats)
    result = dict(csv=save_path, rows=len(lines), stats=stats, scores=None)

    from unopose_tpu_torch.eval.bop_eval import evaluate_bop, format_per_object_tables, write_per_object_tables

    dataset_dir = osp.join(test.data_dir, name)
    if osp.exists(osp.join(dataset_dir, "test_targets_bop19.json")):
        scores = evaluate_bop(save_path, dataset_dir, split=cfg.bop_eval.get("split", "test"))
        with open(save_path.replace(".csv", "_scores.json"), "w") as f:
            json.dump(scores, f, indent=2)
        print(json.dumps({k: v for k, v in scores.items() if k in ("AR", "n_images")}))
        from unopose_tpu_torch.data.dataset_refs import get_ref

        try:
            id2obj = get_ref(name, test.data_dir).id2obj
        except KeyError:
            id2obj = None
        by_col, _ = format_per_object_tables(scores, id2obj=id2obj)
        print(by_col)
        write_per_object_tables(scores, save_path, id2obj=id2obj)
        result["scores"] = scores
    return result


if __name__ == "__main__":
    main()
