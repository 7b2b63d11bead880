"""Launcher (counterpart of ``unopose_tpu/main_unopose.py``)::

    python -m unopose_tpu_torch.main_unopose [--eval-only] [--synthetic-data]
        [--config unopose_tpu_torch.configs:main_config] [--device cuda] [key=value ...]

Loads the config, applies the dotted overrides and builds the model on the
card (``--device cpu`` for the plain versions). Training (the default):
the MegaPose reader through the threaded loader (or, with
``--synthetic-data``, in-memory synthetic batches) at the global batch
``misc.train_batch_size`` on the one card, the pretrained ViT grafted
before it is frozen, resume from the latest checkpoint under
``output_dir/ckpt``, a checkpoint every ``train.checkpointer.period``
iterations (the last ``max_to_keep`` kept), the metric writers (console,
``metrics.json``, TensorBoard) and, where the test set and its detections
are on disk, an evaluation every ``train.eval_period`` iterations on the
current weights. ``--eval-only``: the weights of a checkpoint
(``restore_eval_variables``), then the BOP test reader ->
``engine/inference.py:run_inference`` (through the template cache when
``test.template_cache`` is set) -> the BOP19 CSV and the detections JSON ->
``eval/bop_eval.py:evaluate_bop`` when the dataset holds
``test_targets_bop19.json`` -> the scores JSON, a stdout line with AR and
the image count, and the per-object tables.
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

DEFAULT_CONFIG = "unopose_tpu_torch.configs:main_config"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="unopose_tpu_torch launcher")
    p.add_argument("--config", default=DEFAULT_CONFIG, help="module:function returning the config")
    p.add_argument("--eval-only", action="store_true", help="run inference, write the BOP CSV and score it")
    p.add_argument("--synthetic-data", action="store_true", help="train on the synthetic in-memory batches")
    p.add_argument("--resume", action="store_true",
                   help="accepted for the JAX launcher's command line: training resumes whenever a checkpoint exists")
    p.add_argument("--num-devices", type=int, default=None, help="cards to train on (one is ported)")
    p.add_argument("--device", default="cuda", help="the model's device (cpu for the plain versions)")
    p.add_argument("opts", nargs="*", help="dotted config overrides key=value")
    return p.parse_args(argv)


def load_cfg(spec: str):
    mod_name, _, fn_name = spec.partition(":")
    return getattr(importlib.import_module(mod_name), fn_name or "main_config")()


def main(argv=None) -> Optional[dict]:
    """Run the launcher. Returns ``run_eval``'s result with ``--eval-only``,
    else the trainer and the loop's ``stats`` (``engine/train.py:train_loop``)."""
    args = parse_args(argv)
    cfg = load_cfg(args.config).apply_overrides(args.opts)
    if args.num_devices is not None and args.num_devices > 1:
        raise NotImplementedError("training on several cards is not ported yet (ROADMAP Queue 1 item 6)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the launcher runs on the card (--device cpu for the plain versions)")

    from unopose_tpu_torch.models import UNOPose
    from unopose_tpu_torch.utils.writer import setup_logger

    out_dir = cfg.misc.output_dir
    setup_logger(out_dir)
    logger.info("config: %s", cfg.flatten())
    train = cfg.get("train", {})
    torch.manual_seed(0)  # the random weights' seed where no checkpoint or pretrained file is read
    model = UNOPose.from_config(cfg.model, dtype=DTYPES[train.get("matcher_dtype", "float32")],
                                backbone_dtype=DTYPES[train.get("backbone_dtype", "bfloat16")])
    if args.eval_only:
        restore_eval_variables(model, cfg)
        return run_eval(model.to(device).eval(), cfg, out_dir, device)
    return run_train(model.to(device).train(), cfg, out_dir, device, synthetic=args.synthetic_data)


def run_train(model, cfg, out_dir: str, device, synthetic: bool = False) -> dict:
    """The train branch of ``main``: the data iterator, the checkpointer,
    the writers and the periodic evaluation around ``train_loop``."""
    from unopose_tpu_torch.data.loader import synthetic_train_iter, train_loader
    from unopose_tpu_torch.engine.train import train_loop
    from unopose_tpu_torch.utils.checkpoint import Checkpointer
    from unopose_tpu_torch.utils.writer import ConsolePrinter, JSONWriter, MultiWriter, TensorboardWriter

    data = cfg.dataloader.train
    if synthetic:
        data_iter = synthetic_train_iter(cfg.misc.train_batch_size, img_size=data.img_size,
                                         n_pts=data.n_sample_observed_point, n_tem=data.n_sample_template_point)
    else:
        from unopose_tpu_torch.data.dataset_train import DatasetPoseFreeOneRef

        dataset = DatasetPoseFreeOneRef(data, num_img_per_epoch=data.get("num_img_per_epoch", -1),
                                        seed=cfg.train.seed)
        data_iter = train_loader(dataset, cfg.misc.train_batch_size, num_workers=data.get("num_workers", 8),
                                 seed=cfg.train.seed)
    ckpt = Checkpointer(osp.join(out_dir, "ckpt"), max_to_keep=cfg.train.checkpointer.max_to_keep,
                        period=cfg.train.checkpointer.period)
    writer = MultiWriter(ConsolePrinter(cfg.train.max_iter), JSONWriter(osp.join(out_dir, "metrics.json")),
                         TensorboardWriter(osp.join(out_dir, "tb")))

    eval_fn = None
    test = cfg.dataloader.test
    if cfg.train.get("eval_period", 0) and osp.isdir(osp.join(test.data_dir, test.eval_dataset_name)) \
            and osp.exists(test.detection_path):

        def eval_fn(trainer, step):
            # inference on the current weights in eval mode, then back to training
            model.eval()
            try:
                run_eval(model, cfg, out_dir, device, tag=f"_iter{step:07d}")
            finally:
                model.train()

    stats: dict = {}
    try:
        trainer = train_loop(model, cfg, data_iter, writer=writer, checkpointer=ckpt, eval_fn=eval_fn, stats=stats)
    finally:
        data_iter.close()
        writer.close()
    return dict(trainer=trainer, stats=stats)


def restore_eval_variables(model, cfg) -> None:
    """The eval weights, the JAX launcher's rule: an explicit
    ``misc.load_from`` is authoritative (the latest step of that checkpoint
    directory, or of its ``ckpt/``; none raises ``FileNotFoundError``);
    without it the latest step under ``output_dir/ckpt``; without any
    checkpoint the pretrained backbone where the config names one
    (``maybe_load_pretrained_vit``) and random matchers, a pipeline test
    only, with a warning."""
    from unopose_tpu_torch.utils.checkpoint import Checkpointer, maybe_load_pretrained_vit

    load_from = cfg.misc.get("load_from", "")
    candidates = [load_from, osp.join(load_from, "ckpt")] if load_from else [osp.join(cfg.misc.output_dir, "ckpt")]
    for cand in candidates:
        ckpt = Checkpointer(cand)
        step = ckpt.latest_step()
        if step is None:
            continue
        model.load_state_dict(ckpt.load(step)["model"], strict=True)
        logger.info("restored trained checkpoint step %d from %s", step, cand)
        return
    if load_from:
        raise FileNotFoundError(f"misc.load_from={load_from!r} holds no restorable checkpoint")
    loaded = maybe_load_pretrained_vit(model, cfg.model.feature_extraction)
    logger.warning("no trained checkpoint found (misc.load_from unset, none under %s): evaluating with %s; results "
                   "are a pipeline test only", cfg.misc.output_dir,
                   "pretrained backbone + random matchers" if loaded else "fully random weights")


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
