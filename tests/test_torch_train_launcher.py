"""The training launcher's state side on the CPU: the timm DINOv2 graft
against the JAX package's, the checkpointer and the eval-time restore,
``train_loop``'s rules, the W8A8 code cache after a restore, and
``python -m unopose_tpu_torch.main_unopose`` end to end (train, then
``--eval-only`` from the checkpoint).

The loop and launcher tests train a small model: ``main_config(tiny=True)``
at ``get_tiny_cfg``'s own point budgets (64 observed and 96 template points,
PE budgets 8/16), a fifth of a second a step here."""

import importlib
import json
import logging
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_checkpoint import fake_timm_state_dict
from test_torch_eval_launcher import _rows, write_tree
from unopose_tpu.utils.config import CN
from unopose_tpu_torch import main_unopose
from unopose_tpu_torch.configs import Config, main_config
from unopose_tpu_torch.data.loader import synthetic_train_iter
from unopose_tpu_torch.engine.train import Trainer, create_trainer, train_loop
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.utils import checkpoint
from unopose_tpu_torch.utils.checkpoint import Checkpointer
from unopose_tpu_torch.utils.convert import flax_to_torch

jckpt = importlib.import_module("unopose_tpu.utils.checkpoint")
jvit = importlib.import_module("unopose_tpu.models.vit")

SMALL = dict(npts=64, ntem=96, nsample1=8, nsample2=16)  # get_tiny_cfg's defaults


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread in these tests, restored after each: their small
    ops ran ~100x slower on every core beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_config(**train) -> Config:
    cfg = main_config(tiny=True)
    cfg.model.fine_npoint = SMALL["npts"]
    cfg.model.fine_point_matching.update(nsample1=SMALL["nsample1"], nsample2=SMALL["nsample2"])
    for loader in ("train", "test"):
        cfg.dataloader[loader].update(n_sample_observed_point=SMALL["npts"], n_sample_template_point=SMALL["ntem"])
    cfg.train.update(train)
    return cfg


def small_model(cfg, seed=0):
    torch.manual_seed(seed)
    return UNOPose.from_config(cfg.model, torch.float32, torch.float32)


def batches(cfg, seed=0):
    tr = cfg.dataloader.train
    return synthetic_train_iter(2, img_size=tr.img_size, n_pts=tr.n_sample_observed_point,
                                n_tem=tr.n_sample_template_point, seed=seed)


def state_equal(a: dict, b: dict) -> bool:
    """Two nested states (dicts, lists, tensors, numbers) bitwise equal."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(state_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    return a == b


def trainer_state(trainer):
    return dict(model=trainer.model.state_dict(), optimizer=trainer.optimizer.state_dict(),
                iteration=trainer.iteration)


# ------------------------------------------------------------------ the timm graft
def jax_vit_params():
    """The tiny flax ViT's parameter shapes and dtypes: all a graft replaces them by."""
    vit = jvit.make_vit("vit_tiny_test", img_size=28)
    return jax.eval_shape(lambda: vit.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3), jnp.float32)))["params"]


def test_timm_graft_matches_jax():
    """A fake timm state dict (``tests/test_checkpoint.py``'s, on the 2 x 2
    grid of the tiny ViT) mapped and grafted into the tiny model's ViT:
    every ViT tensor equals JAX's ``convert_timm_vit_to_flax`` +
    ``graft_vit_params`` followed by ``utils/convert.py``, and nothing
    outside the ViT moved. A tensor of another shape raises
    ``ValueError``, a missing one ``KeyError``, and neither copies anything."""
    sd = fake_timm_state_dict(rng=np.random.default_rng(4))
    conv = checkpoint.convert_timm_vit_to_flax(sd, depth=4, reg_tokens=4)
    jconv = jckpt.convert_timm_vit_to_flax(sd, depth=4, reg_tokens=4)
    for (path, a), (jpath, b) in zip(sorted(jax.tree_util.tree_leaves_with_path(conv), key=lambda x: str(x[0])),
                                     sorted(jax.tree_util.tree_leaves_with_path(jconv), key=lambda x: str(x[0]))):
        assert str(path) == str(jpath)
        np.testing.assert_array_equal(a, b)
    grafted = jckpt.graft_vit_params({"encoder": {"rgb_net": {"vit": jax_vit_params()}}}, jconv)
    want = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray, grafted["encoder"]["rgb_net"]["vit"])})

    cfg = small_config()
    model = small_model(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    checkpoint.graft_vit_params(model, conv)
    state = model.state_dict()
    assert len(want) == sum(k.startswith(checkpoint.VIT_PREFIX) for k in state)
    for k, v in want.items():
        assert torch.equal(state[checkpoint.VIT_PREFIX + k], v), k
    assert all(torch.equal(state[k], v) for k, v in before.items() if not k.startswith(checkpoint.VIT_PREFIX))

    bad = {**sd, "norm.weight": np.ones(48, np.float32)}
    fresh = small_model(cfg)
    ref = {k: v.clone() for k, v in fresh.state_dict().items()}
    with pytest.raises(ValueError, match="pretrained shape"):
        checkpoint.graft_vit_params(fresh, checkpoint.convert_timm_vit_to_flax(bad, depth=4))
    missing = checkpoint.convert_timm_vit_to_flax(sd, depth=4)
    del missing["blocks0"]["ls1"], missing["blocks0"]["ls2"]
    with pytest.raises(KeyError, match="no source"):
        checkpoint.graft_vit_params(fresh, missing)
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in ref.items())


def test_maybe_load_pretrained_vit_matches_jax(tmp_path, caplog):
    """The graft from a ``.pth`` file on the 4 x 4 grid, resampled to the tiny
    model's 2 x 2, equals JAX's ``maybe_load_pretrained_vit`` through
    ``utils/convert.py``; its errors and warning are JAX's."""
    sd = fake_timm_state_dict(grid=4, rng=np.random.default_rng(8))
    path = str(tmp_path / "vit.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    fe = dict(vit_type="vit_tiny_test", img_size=28, pretrained=True, vit_ckpt=path, freeze_vit=True)
    params, loaded = jckpt.maybe_load_pretrained_vit({"encoder": {"rgb_net": {"vit": jax_vit_params()}}}, CN(fe))
    want = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray, params["encoder"]["rgb_net"]["vit"])})
    model = small_model(small_config())
    assert loaded and checkpoint.maybe_load_pretrained_vit(model, Config(fe))
    state = model.state_dict()
    for k, v in want.items():
        assert torch.equal(state[checkpoint.VIT_PREFIX + k], v), k
    np.testing.assert_array_equal(state[checkpoint.VIT_PREFIX + "pos_embed"].numpy(),
                                  checkpoint.interpolate_pos_embed_np(sd["pos_embed"], 2))

    with pytest.raises(FileNotFoundError, match="vit_ckpt does not exist"):
        checkpoint.maybe_load_pretrained_vit(model, Config(fe, vit_ckpt=str(tmp_path / "none.pth")))
    with caplog.at_level(logging.WARNING):
        assert not checkpoint.maybe_load_pretrained_vit(model, Config(fe, pretrained=False))
    assert "freeze_vit without pretrained weights" in caplog.text


@pytest.mark.parametrize("grids", [(37, 16), (4, 2), (5, 5)])
def test_interpolate_pos_embed_matches_jax(grids):
    """``interpolate_pos_embed_np`` bitwise equal to JAX's (scipy's cubic
    spline zoom): DINOv2's 37 x 37 grid to the 224 px model's 16 x 16, the
    tests' 4 to 2, and a grid left as it is."""
    g, new = grids
    pe = np.random.default_rng(g).normal(size=(1, g * g, 24)).astype(np.float32)
    got, want = checkpoint.interpolate_pos_embed_np(pe, new), jckpt.interpolate_pos_embed_np(pe, new)
    assert got.shape == (1, new * new, 24) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ the checkpointer
def test_checkpointer_keeps_and_restores_like_jax(tmp_path):
    """The steps ``train_loop``'s rule saves over 7 iterations at period 3
    (3, 6, 7), kept 2 at a time: the same steps as the JAX package's orbax
    ``Checkpointer`` keeps under the same calls. A restore is bitwise the
    saved parameters, buffers, Adam state and count; a half-written step (a
    temporary directory left by a killed run) is no step; ``load`` of a
    missing step is None and ``restore`` of none raises."""
    cfg = small_config()
    trainer = Trainer(small_model(cfg), cfg)
    trainer.step({k: torch.from_numpy(v) for k, v in next(batches(cfg)).items()}, generator=torch.Generator())
    ours, ref = Checkpointer(str(tmp_path / "ours"), max_to_keep=2, period=3), jckpt.Checkpointer(
        str(tmp_path / "ref"), max_to_keep=2, period=3)
    kept = []
    for it in range(7):
        if (it + 1) % 3 == 0 or it == 6:
            trainer.iteration = it + 1
            ours.save(it + 1, trainer)
            ref.save(it + 1, {"x": np.full(2, it, np.float32)})
            kept.append((ours.steps(), sorted(ref.manager.all_steps())))
    assert [k[0] for k in kept] == [k[1] for k in kept] == [[3], [3, 6], [6, 7]]
    assert ours.latest_step() == ref.latest_step() == 7
    os.makedirs(tmp_path / "ours" / ".8.tmp")
    saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    other = Trainer(small_model(cfg, seed=1), cfg)
    assert not state_equal(trainer_state(other), trainer_state(trainer))
    ours.restore(other)
    assert other.iteration == 7 and state_equal(trainer_state(other), trainer_state(trainer))
    assert state_equal(other.model.state_dict(), saved)
    assert ours.load(5) is None and ours.steps() == [6, 7]
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(other)
    assert Checkpointer(str(tmp_path / "empty")).load() is None and not os.path.exists(tmp_path / "empty")


def test_restore_eval_variables_follows_jax(tmp_path, caplog):
    """``restore_eval_variables``'s candidates: an explicit ``misc.load_from``
    (a checkpoint directory, or a run directory holding ``ckpt/``) restores
    its latest step and is authoritative (one with no step raises
    ``FileNotFoundError``, even where ``output_dir/ckpt`` has steps); without
    it the latest step under ``output_dir/ckpt``; without any, random weights
    and the warning."""
    cfg = small_config()
    trained = Trainer(small_model(cfg, seed=1), cfg)
    run = tmp_path / "run"
    Checkpointer(str(run / "ckpt")).save(3, trained)
    want = trained.model.state_dict()

    def restored(**misc):
        c = small_config()
        c.misc.update({"output_dir": str(tmp_path / "out"), **misc})
        model = small_model(c)
        main_unopose.restore_eval_variables(model, c)
        return state_equal(model.state_dict(), want)

    assert restored(load_from=str(run / "ckpt")) and restored(load_from=str(run))
    assert restored(load_from="", output_dir=str(run))
    os.makedirs(tmp_path / "nothing")
    with pytest.raises(FileNotFoundError, match="holds no restorable checkpoint"):
        restored(load_from=str(tmp_path / "nothing"), output_dir=str(run))
    with caplog.at_level(logging.WARNING):
        assert not restored()
    assert "fully random weights" in caplog.text


def test_restore_refreshes_the_w8a8_codes(tmp_path):
    """After a checkpoint is restored into a live model whose ViT has already
    cached its int8 weight codes, the eval's codes are those of the restored
    weights: ``DenseQ`` keys its cache on the weight's storage and version,
    and the restore writes the weights in place."""
    cfg = small_config()
    trained = Trainer(small_model(cfg, seed=1), cfg)
    Checkpointer(str(tmp_path / "ckpt")).save(1, trained)
    model = small_model(cfg).eval()
    dense = [(n, m) for n, m in model.named_modules() if type(m).__name__ == "DenseQ" and m.int8]
    assert dense
    stale = [m.quantized_weight()[0].clone() for _, m in dense]
    cfg.misc.update(load_from=str(tmp_path / "ckpt"))
    main_unopose.restore_eval_variables(model, cfg)
    fresh = dict(trained.model.named_modules())
    for (name, m), old in zip(dense, stale):
        codes, scales = m.quantized_weight()
        want_codes, want_scales = fresh[name].quantized_weight()
        assert torch.equal(codes, want_codes) and torch.equal(scales, want_scales), name
        assert not torch.equal(codes, old), name


# ------------------------------------------------------------------ train_loop
class Records:
    def __init__(self):
        self.lines, self.images = [], []

    def write(self, step, metrics):
        self.lines.append((step, metrics))

    def write_image(self, step, tag, img):
        self.images.append((step, tag, img.shape, img.dtype))


def test_train_loop_rules(tmp_path):
    """``train_loop`` at the small config: its parameters after 4 iterations
    are bitwise those of 4 ``Trainer.step`` calls on the same batches with
    one generator seeded ``train.seed``; the writer sees iterations 0, 2 and
    the last (3), each with a finite loss and ``iter_time``, and the first
    crop as an image where ``vis_img_tbx`` is set; checkpoints land at 2 and
    4. With step 4 gone, a second loop over the same checkpointer resumes
    from step 2 (its restored state bitwise the saved one), logs 2 and 3 and
    saves 4 again."""
    cfg = small_config(log_period=2, checkpointer=Config(period=2, max_to_keep=2), vis_img_tbx=True, seed=5)
    model = small_model(cfg)
    ref = Trainer(small_model(cfg), cfg)
    gen = torch.Generator().manual_seed(5)
    for batch, _ in zip(batches(cfg, seed=3), range(4)):
        ref.step({k: torch.from_numpy(v) for k, v in batch.items()}, generator=gen)
    rec, ckpt, stats = Records(), Checkpointer(str(tmp_path / "ckpt"), period=2), {}
    trainer = train_loop(model, cfg, batches(cfg, seed=3), max_iter=4, writer=rec, checkpointer=ckpt, stats=stats)
    assert state_equal(trainer_state(trainer), trainer_state(ref)) and trainer.iteration == 4
    assert [s for s, _ in rec.lines] == [0, 2, 3]
    assert all(np.isfinite(m["loss"]) and m["iter_time"] > 0 and m["grad_norm"] > 0 for _, m in rec.lines)
    assert rec.images == [(s, "input_image", (28, 28, 3), np.uint8) for s in (0, 2, 3)]
    assert ckpt.steps() == [2, 4] and len(stats["step_s"]) == 4 and len(stats["save_s"]) == 2
    assert stats["start_iter"] == 0 and stats["restore_s"] is None

    saved = ckpt.load(2)
    shutil.rmtree(tmp_path / "ckpt" / "4")
    resumed = Trainer(small_model(cfg, seed=2), cfg)
    restore = Checkpointer.restore

    def check_restore(self, trainer, step=None):
        out = restore(self, trainer, step)
        assert step == 2 and trainer.iteration == 2 and state_equal(trainer_state(trainer), saved)
        return out

    rec2 = Records()
    Checkpointer.restore = check_restore
    try:
        train_loop(resumed.model, cfg, batches(cfg, seed=4), trainer=resumed, max_iter=4, writer=rec2,
                   checkpointer=ckpt, stats=stats)
    finally:
        Checkpointer.restore = restore
    assert stats["start_iter"] == 2 and stats["restore_s"] >= 0 and len(stats["step_s"]) == 2
    assert [s for s, _ in rec2.lines] == [2, 3] and resumed.iteration == 4 and ckpt.steps() == [2, 4]


def test_create_trainer_grafts_before_freezing(tmp_path):
    """``create_trainer`` grafts the pretrained ViT, then freezes it: the
    grafted tensors are the model's, none of them trains."""
    sd = fake_timm_state_dict(rng=np.random.default_rng(2))
    path = str(tmp_path / "vit.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    cfg = small_config()
    cfg.model.feature_extraction.update(pretrained=True, vit_ckpt=path)
    trainer = create_trainer(small_model(cfg), cfg)
    vit = trainer.model.encoder.rgb_net.vit
    assert torch.equal(vit.cls_token.detach(), torch.from_numpy(sd["cls_token"]))
    assert not any(p.requires_grad for p in vit.parameters())
    assert not any("vit" in n for n, _ in trainer.params)


# ------------------------------------------------------------------ the launcher
def _argv(out_dir, root=None, det_path=None, *extra):
    """The launcher's command line at the small config: the flags among ``extra`` first, then the overrides."""
    cfg = small_config()
    argv = [e for e in extra if e.startswith("--")] + [
        "--device", "cpu", f"misc.output_dir={str(out_dir)!r}", "misc.exp_name='e2e'", f"model={dict(cfg.model)!r}",
        "misc.train_batch_size=2", "test.instance_batch_size=2"]
    for loader in ("train", "test"):
        d = cfg.dataloader[loader]
        argv += [f"dataloader.{loader}.{k}={d[k]}" for k in ("img_size", "n_sample_observed_point",
                                                            "n_sample_template_point")]
    if root:
        argv += [f"dataloader.test.data_dir={root!r}", f"dataloader.test.detection_path={det_path!r}"]
    return argv + [e for e in extra if not e.startswith("--")]


def test_launcher_trains_then_evaluates_from_its_checkpoint(tmp_path, monkeypatch):
    """``main_unopose`` at the small config on the CPU: 2 synthetic
    iterations with the evaluation every 2 and a checkpoint every iteration
    (2 kept), ``metrics.json`` with 2 finite lines, the ``_iter0000002``
    CSV, the model back in train mode after it; then ``--eval-only
    misc.load_from=<out>/ckpt`` writes the same rows (the time column
    aside) from the restored weights; a second call resumes at 2 and takes
    no step; ``load_from`` with no checkpoint raises."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # as on a machine without tensorboard
    root, det_path = write_tree(tmp_path)
    out = tmp_path / "out"
    train = ["--synthetic-data", "train.max_iter=2", "train.log_period=1", "train.eval_period=2",
             "train.checkpointer.period=1", "--resume"]
    r = main_unopose.main(_argv(out, root, det_path, *train))
    trainer, stats = r["trainer"], r["stats"]
    assert trainer.iteration == 2 and trainer.model.training and stats["start_iter"] == 0
    lines = [json.loads(x) for x in open(out / "metrics.json").read().splitlines()]
    assert [x["iteration"] for x in lines] == [0, 1] and all(np.isfinite(x["loss"]) for x in lines)
    assert sorted(os.listdir(out / "ckpt")) == ["1", "2"]
    csv = out / "result_e2e_iter0000002_ycbv-test.csv"
    rows = _rows(csv)
    assert len(rows) == 6 and not (out / "result_e2e_iter0000001_ycbv-test.csv").exists()

    ev = main_unopose.main(_argv(tmp_path / "eval", root, det_path, "--eval-only",
                                 f"misc.load_from={str(out / 'ckpt')!r}"))
    assert [r[:6] for r in _rows(ev["csv"])] == [r[:6] for r in rows]

    again = main_unopose.main(_argv(out, root, det_path, *train))
    assert again["stats"]["start_iter"] == 2 and again["stats"]["step_s"] == []
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="holds no restorable checkpoint"):
        main_unopose.main(_argv(tmp_path / "o", root, det_path, "--eval-only",
                                f"misc.load_from={str(tmp_path / 'empty')!r}"))
