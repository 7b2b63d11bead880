"""The reference-checkpoint loader of the PyTorch port (``utils/ref_convert.py``)
and the fake reference checkpoint (``tools/fake_reference.py``) against the
JAX package's converter (CPU).

No published checkpoint is at hand, so a tiny port model with seeded
BatchNorm statistics is written out in the reference's layout by the fake
tool. The JAX package's ``convert_unopose_state_dict`` must map that back
to the model's own tensors bit for bit (the fake is the reference's
layout), the port's loader must equal that converter followed by
``flax_to_torch`` bit for bit, and ``load_reference_checkpoint`` must
unwrap each ``.pth`` form a training script leaves.
"""

import functools

import numpy as np
import pytest
import torch

from unopose_tpu.utils.ref_convert import convert_unopose_state_dict as jax_convert
from unopose_tpu_torch.configs import slice_config
from unopose_tpu_torch.models import UNOPose
from unopose_tpu_torch.tools.fake_reference import reference_state_dict, write_fake_reference
from unopose_tpu_torch.utils.convert import flax_to_torch
from unopose_tpu_torch.utils.ref_convert import (
    load_reference_checkpoint,
    load_reference_into,
    reference_to_state_dict,
)

DEPTH = 4  # the tiny ViT's blocks


@functools.lru_cache(maxsize=None)
def tiny_model():
    """A tiny port model with every BatchNorm's running statistics drawn from a seed."""
    torch.manual_seed(0)
    m = UNOPose.from_config(slice_config(tiny=True))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in m.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(torch.randn(buf.shape, generator=gen) * 0.1)
            elif name.endswith(".var"):
                buf.copy_(0.5 + 1.5 * torch.rand(buf.shape, generator=gen))
    return m


def assert_bitwise(got: dict, want: dict):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    bad = [k for k in want if got[k].dtype != torch.float32 or not torch.equal(got[k], want[k].float())]
    assert not bad, bad[:8]


def test_fake_reference_round_trips_through_the_jax_converter():
    """The fake is the reference's layout: the JAX converter maps it back to
    the model's tensors bit for bit, reading none of what the reference holds
    beyond them (the sinusoid's ``div_term``, ``dis_proj``, the BatchNorms'
    ``num_batches_tracked``)."""
    m = tiny_model()
    fake = reference_state_dict(m)
    assert fake["feature_extraction.rgb_net.vit.patch_embed.proj.weight"].shape == (32, 3, 14, 14)
    assert fake["fine_point_matching.PE.mlp1.layer0.conv.weight"].shape == (32, 6, 1, 1)
    assert fake["fine_point_matching.PE.mlp3.conv.weight"].ndim == 3
    extra = [k for k in fake if k.endswith("div_term") or "dis_proj" in k or k.endswith("num_batches_tracked")]
    assert len(extra) == 1 + 2 + 6
    variables = jax_convert({k: v.numpy() for k, v in fake.items()}, depth=DEPTH)
    assert_bitwise(flax_to_torch(variables), m.state_dict())


def test_port_loader_equals_the_jax_converter():
    """``reference_to_state_dict`` equals JAX's ``convert_unopose_state_dict``
    followed by ``flax_to_torch``, bit for bit, key for key."""
    fake = {k: v.numpy() for k, v in reference_state_dict(tiny_model()).items()}
    assert_bitwise(reference_to_state_dict(fake, depth=DEPTH), flax_to_torch(jax_convert(fake, depth=DEPTH)))


@pytest.mark.parametrize("wrap, prefix", [("model", ""), ("state_dict", ""), ("", ""), ("model", "module.")])
def test_load_reference_checkpoint_unwraps(tmp_path, wrap, prefix):
    """A ``.pth`` holding the state dict bare, under ``model`` or under
    ``state_dict``, with or without a data-parallel ``module.`` prefix, loads
    to the same arrays, and ``load_reference_into`` gives a fresh model the
    source model's tensors."""
    m = tiny_model()
    path = tmp_path / "reference.pth"
    sd = write_fake_reference(str(path), m, wrap)
    if prefix:
        torch.save({wrap: {prefix + k: v for k, v in sd.items()}}, path)
    got = load_reference_checkpoint(str(path))
    assert set(got) == set(sd) and all(np.array_equal(got[k], sd[k].numpy()) for k in sd)
    torch.manual_seed(7)
    fresh = UNOPose.from_config(slice_config(tiny=True))
    assert_bitwise(load_reference_into(fresh, str(path)).state_dict(), m.state_dict())
