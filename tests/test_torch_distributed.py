"""The port's data-parallel layer on the CPU: two gloo ranks, each a process
under torchrun's environment (``tests/torch_dist_*_worker.py``), against
one process on the same global batch (the counterparts of
``tests/test_distributed.py``), and the launcher's ``--num-devices 2
--device cpu``, which spawns its ranks itself. The fine PE's synced stack
against JAX is in ``test_torch_distributed_pe.py``; the two-rank tiny step
against JAX in ``test_torch_train_step.py`` (beside its fixture)."""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import torch

from test_inference import FakeDataset, _fake_infer_fn, _strip_time
from test_torch_eval_launcher import _rows, write_tree
from test_torch_train_launcher import _argv
from torch_dist_train_worker import tiny_config, tiny_model, train
from unopose_tpu_torch import main_unopose
from unopose_tpu_torch.engine.inference import run_inference
from unopose_tpu_torch.parallel import mesh

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
RANKS = 2
GRAD_RTOL = 5e-2  # the first step's averaged gradients against one process's, of each tensor's largest


def run_ranks(script: str, *args, ranks: int = RANKS, timeout: float = 300) -> None:
    """``tests/<script>`` in ``ranks`` processes under torchrun's environment on
    a free local port (one torch thread each); every rank must exit 0."""
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(mesh.free_port()), WORLD_SIZE=str(ranks),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, osp.join(REPO, "tests", script), *map(str, args)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(ranks)]
    try:
        outputs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, o) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r}:\n{o[-3000:]}"


def test_two_rank_training_matches_one_process(tmp_path):
    """``train_loop`` on 2 gloo ranks, each on its half of a global batch of 4
    (``get_tiny_cfg``'s sizes, 3 iterations), against one process on the
    whole batch from the same weights and noise: the logged losses within
    rtol 1e-5 / atol 1e-6 and the parameters within 2e-5 / 1e-6 (the JAX
    package's gates for its two processes); the first step's averaged
    gradients, each tensor within ``GRAD_RTOL`` of its largest |gradient|
    (plus 1e-6 of the largest over all tensors, for the gradients that are
    zero up to rounding); both ranks' parameters and BatchNorm running
    statistics bitwise equal; the fine PE's statistics and backward sums
    reduced (3 depths / layers x 2 scales x 2 clouds a step), one gradient
    all-reduce a step, the metrics at each logged iteration.

    The parameters alone cannot catch a wrong gradient: at the warm-up's
    learning rates (about 1e-7 for these steps) Adam moves no element by
    more than that, whatever the gradient. A one-ulp nudge of the input
    clouds moves the first step's gradients by about their own size here
    (it flips the pipeline's discrete selections), so it cannot set their
    gate; the ranks, on the same inputs, differ by rounding, and the faults
    the gate is for are of the tensor's own size: the gamma and beta
    gradients from the reduced sums (R times theirs), or K13 and K14
    centering over one rank's count."""
    out = tmp_path / "train"
    run_ranks("torch_dist_train_worker.py", "--mode", "loop", "--out", out, "--global-batch", 4, "--steps", 3)
    ranks = [torch.load(f"{out}.rank{r}", weights_only=False) for r in range(RANKS)]
    cfg = tiny_config()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec, trainer, grads = train(cfg, tiny_model(cfg), 4, 3)
    finally:
        torch.set_num_threads(n)
    ref = trainer.model.state_dict()
    got = ranks[0]
    assert [s for s, _ in got["metrics"]] == [s for s, _ in rec.lines] == [0, 1, 2]
    for (_, m), (_, w) in zip(got["metrics"], rec.lines):
        assert sorted(m) == sorted(w)
        np.testing.assert_allclose(m["loss"], w["loss"], rtol=1e-5, atol=1e-6)
    trainable = [name for name, _ in trainer.params]
    for name in trainable:
        np.testing.assert_allclose(got["state"][name].numpy(), ref[name].numpy(), rtol=2e-5, atol=1e-6,
                                   err_msg=name)
    largest = max(g.abs().max().item() for g in grads.values())
    assert sorted(got["grads"]) == sorted(grads) == sorted(trainable)
    for name, g in grads.items():
        gap = (got["grads"][name] - g).abs().max().item()
        assert gap <= GRAD_RTOL * (g.abs().max().item() + 1e-6 * largest), (name, gap)
    stats = [k for k in ref if ".pe." in k and k.endswith((".mean", ".var"))]
    assert len(stats) == 12
    for k in ref:
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), k
    for k in stats:
        np.testing.assert_allclose(got["state"][k].numpy(), ref[k].numpy(), rtol=2e-5, atol=1e-6, err_msg=k)
    for r in ranks:
        red = r["reductions"]
        assert red["pe_train_stats"] == red["pe_train_bwd_sums"] == 3 * 3 * 4, red
        assert red["gradients"] == 3 and red["metrics"] == 3, red


def test_two_rank_inference_matches_one_process(tmp_path):
    """The port's ``run_inference`` on 2 gloo ranks (``FakeDataset`` of 5
    images, the fake model function), a barrier, rank 0's merge: the merged
    CSV equals one process's, the time column aside, and rank 1's shard was
    written."""
    out = str(tmp_path / "result.csv")
    run_ranks("torch_dist_infer_worker.py", "--out", out)
    single = str(tmp_path / "single.csv")
    run_inference(_fake_infer_fn, FakeDataset(n_images=5, seed=7), single, instance_batch_size=2)
    merged, want = (open(p).read().splitlines() for p in (out, single))
    assert _strip_time(merged) == _strip_time(want) and len(merged) == 15
    assert osp.exists(out + ".rank1")


def test_launcher_two_ranks_train_then_eval_only(tmp_path, monkeypatch):
    """``main_unopose --num-devices 2 --device cpu`` spawns 2 gloo ranks: 2
    synthetic iterations at the small config (global batch 2, one sample a
    rank), a checkpoint at the last and the periodic evaluation, whose CSV
    rank 0 merges from both shards and scores; one ``metrics.json`` and one
    ``ckpt/`` (rank 0's), a log per rank. Then ``--eval-only`` from that
    checkpoint on 2 ranks: one merged CSV of every kept detection, scored on
    rank 0, its poses those of the training's last evaluation (the same
    weights and draws)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    root, det_path = write_tree(tmp_path)
    out = tmp_path / "out"
    train_argv = ["--num-devices=2", "--synthetic-data", "train.max_iter=2", "train.log_period=1",
                  "train.eval_period=2", "train.checkpointer.period=2"]
    assert main_unopose.main(_argv(out, root, det_path, *train_argv)) is None
    lines = [json.loads(x) for x in open(out / "metrics.json").read().splitlines()]
    assert [x["iteration"] for x in lines] == [0, 1] and all(np.isfinite(x["loss"]) for x in lines)
    assert sorted(os.listdir(out / "ckpt")) == ["2"]
    assert {"log.txt", "log.rank1.txt"} <= set(os.listdir(out))
    csv = out / "result_e2e_iter0000002_ycbv-test.csv"
    rows = _rows(csv)
    assert len(rows) == 6 and osp.exists(f"{csv}.rank1")
    assert osp.exists(str(csv).replace(".csv", "_scores.json"))

    ev = tmp_path / "eval"
    assert main_unopose.main(_argv(ev, root, det_path, "--eval-only", "--num-devices=2",
                                   f"misc.load_from={str(out / 'ckpt')!r}")) is None
    merged = _rows(ev / "result_e2e_ycbv-test.csv")
    assert [r[:6] for r in merged] == [r[:6] for r in rows]
    scores = json.load(open(ev / "result_e2e_ycbv-test_scores.json"))
    assert np.isfinite(scores["AR"]) and scores["n_images"] == 2
