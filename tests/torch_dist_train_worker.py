"""Worker of the two-rank training tests (``tests/test_torch_distributed.py``
and ``tests/test_torch_train_step.py``): one gloo rank of the port's
data-parallel training.

Started one process a rank under torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) by the tests. Two modes:

- ``loop``: ``train_loop`` on ``tiny_config()`` for ``--steps`` iterations
  on this rank's rows of ``synthetic_train_iter(--global-batch)`` (every
  rank draws the global batch), logged each iteration; the model seeded as
  the test's one-process run seeds it;
- ``step``: one ``Trainer.step`` of ``train_config(tiny=True)`` from the
  state dict, global batch and pose-noise draws in ``--inputs`` (a
  ``torch.save`` file), on this rank's rows.

Writes ``--out`` with a ``.rank<N>`` suffix (``torch.save``): the logged
metrics (the ranks' mean), the model's state dict after training, the
first step's averaged gradients (``loop``) and the collectives it launched.
"""

import argparse
import os.path as osp
import sys

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)

SMALL = dict(npts=64, ntem=96, nsample1=8, nsample2=16)  # get_tiny_cfg's own point and PE budgets


def tiny_config():
    """``main_config(tiny=True)`` at ``get_tiny_cfg``'s own budgets (64 / 96
    points, PE 8 / 16), logged every iteration, no evaluation."""
    from unopose_tpu_torch.configs import main_config

    cfg = main_config(tiny=True)
    cfg.model.fine_npoint = SMALL["npts"]
    cfg.model.fine_point_matching.update(nsample1=SMALL["nsample1"], nsample2=SMALL["nsample2"])
    cfg.dataloader.train.update(n_sample_observed_point=SMALL["npts"], n_sample_template_point=SMALL["ntem"])
    cfg.train.update(log_period=1, eval_period=0)
    return cfg


def tiny_model(cfg):
    import torch

    from unopose_tpu_torch.models import UNOPose

    torch.manual_seed(0)
    return UNOPose.from_config(cfg.model, torch.float32, torch.float32)


class Records:
    """A writer that keeps the logged metrics."""

    def __init__(self):
        self.lines = []

    def write(self, step, metrics):
        self.lines.append((step, metrics))


def train(cfg, model, global_batch: int, steps: int, rows=slice(None)):
    """``train_loop`` on ``rows`` of each synthetic global batch: (records,
    trainer, the first step's gradients by parameter name). The first step's
    gradients (averaged over the ranks) scale with the gradient, where the
    parameters after a few warm-up steps, at learning rates near 1e-7, do
    not; at later steps the ranks' rounding has moved the weights and the
    pipeline's discrete selections with them."""
    from unittest import mock

    from unopose_tpu_torch.data.loader import synthetic_train_iter
    from unopose_tpu_torch.engine.train import Trainer, train_loop

    tr = cfg.dataloader.train
    data = synthetic_train_iter(global_batch, img_size=tr.img_size, n_pts=tr.n_sample_observed_point,
                                n_tem=tr.n_sample_template_point, seed=3, rows=rows)
    rec, first, plain = Records(), {}, Trainer.step

    def step(self, *args, **kwargs):
        metrics = plain(self, *args, **kwargs)
        if not first:  # the next step zeroes them
            first.update({name: p.grad.detach().clone() for name, p in self.params})
        return metrics

    with mock.patch.object(Trainer, "step", step):
        trainer = train_loop(model, cfg, data, max_iter=steps, writer=rec)
    return rec, trainer, first


def step(inputs: dict):
    """One ``Trainer.step`` of ``train_config(tiny=True)`` on this rank's rows: its metrics (the ranks' mean)."""
    import torch

    from unopose_tpu_torch.configs import train_config
    from unopose_tpu_torch.engine.train import Trainer
    from unopose_tpu_torch.models import UNOPose
    from unopose_tpu_torch.ops.rotation import PoseNoiseDraws
    from unopose_tpu_torch.parallel import mesh

    cfg = train_config(tiny=True)
    model = UNOPose.from_config(cfg.model, torch.float32, torch.float32)
    model.load_state_dict(inputs["state"], strict=True)
    trainer = Trainer(model, cfg)
    rows = mesh.local_batch_slice(inputs["batch"]["pts"].shape[0])
    metrics = trainer.step({k: v[rows] for k, v in inputs["batch"].items()},
                           pose_noise=PoseNoiseDraws(*inputs["draws"]))
    return {k: float(v) for k, v in mesh.mean_across_ranks(metrics).items()}, model


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=("loop", "step"), required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--inputs")
    p.add_argument("--global-batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args()

    import torch

    from unopose_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init_distributed("cpu")
    try:
        if args.mode == "loop":
            cfg = tiny_config()
            rec, trainer, first = train(cfg, tiny_model(cfg), args.global_batch, args.steps,
                                        rows=mesh.local_batch_slice(args.global_batch))
            metrics, model = rec.lines, trainer.model
        else:
            (metrics, model), first = step(torch.load(args.inputs, weights_only=False)), None
        torch.save(dict(metrics=metrics, state={k: v.clone() for k, v in model.state_dict().items()}, grads=first,
                        reductions=dict(mesh.REDUCTIONS)), f"{args.out}.rank{mesh.rank()}")
        mesh.sync_processes("done")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
