"""Launcher (counterpart of ``unopose_tpu/main_unopose.py``)::

    python -m unopose_tpu_torch.main_unopose [--eval-only] [--synthetic-data]
        [--config unopose_tpu_torch.configs:main_config] [--device cuda] [--num-devices N] [key=value ...]
    torchrun --nproc_per_node N -m unopose_tpu_torch.main_unopose [...]

Loads the config, applies the dotted overrides and builds the model on the
card (``--device cpu`` for the plain versions). Several ranks
(``parallel/mesh.py``), one process each: under torchrun's environment
each rank joins an NCCL group on card ``LOCAL_RANK`` (gloo with ``--device
cpu``); with ``--num-devices N > 1`` and no such environment the launcher
spawns N ranks on cards 0..N-1 (N gloo ranks on the CPU with ``--device
cpu``) and returns None; a process group the caller initialised is used
as it is. Training (the default): the MegaPose reader through the threaded
loader (each rank ``misc.train_batch_size // R`` samples a step from a
dataset seeded ``train.seed + rank``) or, with ``--synthetic-data``,
in-memory synthetic batches (every rank draws the global batch and keeps
its rows) at the global batch ``misc.train_batch_size``, the pretrained ViT
grafted before it is frozen, resume from the latest checkpoint under
``output_dir/ckpt``, a checkpoint every ``train.checkpointer.period``
iterations (the last ``max_to_keep`` kept), the metric writers (console,
``metrics.json``, TensorBoard) and, where the test set and its detections
are on disk, an evaluation every ``train.eval_period`` iterations on the
current weights. Rank 0 alone saves the checkpoints and writes the metrics
(``metrics.json``, TensorBoard, the console); every rank logs to
``log.txt`` / ``log.rank<N>.txt``. ``--eval-only``: the weights of a
checkpoint (``restore_eval_variables``), then the BOP test reader ->
``engine/inference.py:run_inference`` (through the template cache when
``test.template_cache`` is set; rank r of R takes shard r of the images)
-> the BOP19 CSV and the detections JSON (rank 0 merges the shards after a
barrier) -> ``eval/bop_eval.py:evaluate_bop`` on rank 0 when the dataset
holds ``test_targets_bop19.json`` -> the scores JSON, a stdout line with AR
and the image count, and the per-object tables.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
import os.path as osp
import sys
from typing import Optional

import torch

from unopose_tpu_torch.parallel import mesh

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
    p.add_argument("--num-devices", type=int, default=None,
                   help="ranks to spawn, one a card (or gloo ranks on the CPU), where torchrun started none")
    p.add_argument("--device", default="cuda", help="the model's device (cpu for the plain versions)")
    p.add_argument("opts", nargs="*", help="dotted config overrides key=value")
    return p.parse_args(argv)


def load_cfg(spec: str):
    mod_name, _, fn_name = spec.partition(":")
    return getattr(importlib.import_module(mod_name), fn_name or "main_config")()


def main(argv=None) -> Optional[dict]:
    """Run the launcher. Returns ``run_eval``'s result with ``--eval-only``,
    else the trainer and the loop's ``stats`` (``engine/train.py:train_loop``);
    None where it spawned the ranks."""
    args = parse_args(argv)
    cfg = load_cfg(args.config).apply_overrides(args.opts)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the launcher runs on the card (--device cpu for the plain versions)")
    ranks = args.num_devices or 1
    if ranks > 1 and not mesh.initialized() and "RANK" not in os.environ:
        spawn_ranks(sys.argv[1:] if argv is None else list(argv), ranks, device)
        return None
    owned = not mesh.initialized()
    device = mesh.init_distributed(device)
    try:
        if args.num_devices is not None and mesh.world_size() != args.num_devices:
            raise ValueError(f"--num-devices {args.num_devices} in a group of {mesh.world_size()} ranks")
        return _run(args, cfg, device)
    finally:
        if owned and mesh.initialized():
            torch.distributed.destroy_process_group()


def _run(args, cfg, device) -> dict:
    from unopose_tpu_torch.models import UNOPose
    from unopose_tpu_torch.utils.writer import setup_logger

    out_dir = cfg.misc.output_dir
    setup_logger(out_dir, mesh.rank())
    logger.info("config: %s", cfg.flatten())
    train = cfg.get("train", {})
    torch.manual_seed(0)  # the random weights' seed where no checkpoint or pretrained file is read
    model = UNOPose.from_config(cfg.model, dtype=DTYPES[train.get("matcher_dtype", "float32")],
                                backbone_dtype=DTYPES[train.get("backbone_dtype", "bfloat16")])
    if args.eval_only:
        restore_eval_variables(model, cfg)
        model = model.to(device).eval()
        mesh.broadcast_state(model)
        return run_eval(model, cfg, out_dir, device)
    return run_train(model.to(device).train(), cfg, out_dir, device, synthetic=args.synthetic_data)


def spawn_ranks(argv, ranks: int, device: torch.device) -> None:
    """``ranks`` processes (start method ``spawn``), each ``main(argv)`` under
    torchrun's environment on this host: rank r on card r, or a gloo rank on
    the CPU. Raises with fewer cards than ranks, and where a rank fails."""
    if device.type == "cuda" and torch.cuda.device_count() < ranks:
        raise RuntimeError(f"{ranks} ranks and {torch.cuda.device_count()} cards: fewer cards than ranks")
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(argv, ranks, mesh.free_port()), nprocs=ranks, join=True)


def _rank_main(index: int, argv, ranks: int, port: int) -> None:
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index), WORLD_SIZE=str(ranks), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    main(argv)


def run_train(model, cfg, out_dir: str, device, synthetic: bool = False) -> dict:
    """The train branch of ``main``: the data iterator (this rank's rows of
    the global batch), the checkpointer, the writers (rank 0's) and the
    periodic evaluation around ``train_loop``."""
    from unopose_tpu_torch.data.loader import synthetic_train_iter, train_loader
    from unopose_tpu_torch.engine.train import train_loop
    from unopose_tpu_torch.utils.checkpoint import Checkpointer
    from unopose_tpu_torch.utils.writer import ConsolePrinter, JSONWriter, MultiWriter, TensorboardWriter

    data = cfg.dataloader.train
    batch, ranks = cfg.misc.train_batch_size, mesh.world_size()
    if batch % ranks:
        raise ValueError(f"misc.train_batch_size {batch} does not split over {ranks} ranks")
    if synthetic:
        data_iter = synthetic_train_iter(batch, img_size=data.img_size, n_pts=data.n_sample_observed_point,
                                         n_tem=data.n_sample_template_point, rows=mesh.local_batch_slice(batch))
    else:
        from unopose_tpu_torch.data.dataset_train import DatasetPoseFreeOneRef

        dataset = DatasetPoseFreeOneRef(data, num_img_per_epoch=data.get("num_img_per_epoch", -1),
                                        seed=cfg.train.seed + mesh.rank())
        data_iter = train_loader(dataset, batch // ranks, num_workers=data.get("num_workers", 8),
                                 seed=cfg.train.seed)
    ckpt = Checkpointer(osp.join(out_dir, "ckpt"), max_to_keep=cfg.train.checkpointer.max_to_keep,
                        period=cfg.train.checkpointer.period)
    # every rank passes a writer, so that every rank takes part in the logged metrics' mean
    writer = MultiWriter(ConsolePrinter(cfg.train.max_iter), JSONWriter(osp.join(out_dir, "metrics.json")),
                         TensorboardWriter(osp.join(out_dir, "tb"))) if mesh.is_main_process() else MultiWriter()

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
    ``run_inference``'s stats and the scores (None without targets). On R
    ranks rank r writes shard r of the images (``.rank<r>`` past 0); after a
    barrier rank 0 merges the shards and scores the merged CSV, the others
    return their shard's."""
    from unopose_tpu_torch.data.dataset_test import BOPTestsetPoseFreeOneRef
    from unopose_tpu_torch.engine.inference import make_infer_fn, make_template_fn, merge_csv_shards, run_inference

    test = cfg.dataloader.test
    dataset = BOPTestsetPoseFreeOneRef(test, eval_dataset_name=test.eval_dataset_name,
                                       detection_path=test.detection_path)
    infer_fn = make_infer_fn(model, device)
    template_fn = make_template_fn(model, device) if cfg.test.get("template_cache", True) else None
    name = test.eval_dataset_name
    save_path = osp.join(out_dir, f"result_{cfg.misc.exp_name}{tag}_{name}-test.csv")
    os.makedirs(out_dir, exist_ok=True)
    stats: dict = {}
    ranks, rank = mesh.world_size(), mesh.rank()
    lines = run_inference(infer_fn, dataset, save_path, instance_batch_size=cfg.test.instance_batch_size,
                          template_fn=template_fn, stats=stats, num_shards=ranks, shard_index=rank)
    result = dict(csv=save_path, rows=len(lines), stats=stats, scores=None)
    if ranks > 1:
        mesh.sync_processes("eval")
        if rank != 0:
            result["csv"] = f"{save_path}.rank{rank}"
            return result
        merge_csv_shards(save_path, ranks)
        with open(save_path) as f:
            result["rows"] = sum(1 for line in f if line.strip())

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
