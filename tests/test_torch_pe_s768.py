"""The packed fine PE's four layouts at a scale-2 budget of 768 slots (CPU).

JAX's gates admit any ``nsample2`` that is a multiple of 256 up to the
cloud's N. At S2 768 the port's kernels walk a point's slots in windows of
512: row 10's full blocks, rows 11 and 12's 768-slot tier and row 13's
192-slot chunks. ``test_torch_pe_variants.dense_cloud(768)`` has such
blocks and fast ones. Each of the port's plain twins runs on JAX's
grouping of it, against the JAX kernel in interpret mode, at the pooled
rows' gates of ``test_torch_pe_variants.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_fused import R1, R2
from test_torch_pe_variants import assert_rows_within_jax_spread, grouping, jax_row, tmlps
from unopose_tpu_torch.ops import pe_fused as tpf

N = S2 = 768


def twin(row: str, p: dict) -> np.ndarray:
    if row == "packed":
        return tpf.pe_fused_packed_plain(p["g2"], p["w1"], p["w2"], p["total2"], p["center"], *tmlps(), R1, R2).numpy()
    if row == "packed_t":
        sm = lambda x: x.transpose(1, 2).contiguous()
        return tpf.pe_fused_packed_t_plain(tuple(map(sm, p["g2"])), sm(p["w1"]), sm(p["w2"]), p["total2"],
                                           p["center"], *tmlps(), R1, R2).numpy()
    if row == "gather_t":
        return tpf.pe_fused_gather_t_plain(p["planes"], p["idx"], p["w1"], p["w2"], p["total2"], p["center"],
                                           *tmlps(), R1, R2).numpy()
    chunks, w = tpf.pe_channels_packed(p["g2"], p["w1"], p["w2"], p["center"], R1, R2)
    assert w == 192
    return tpf.pe_mlp_pool_packed_plain(chunks, p["total2"], *tmlps()).numpy()


@pytest.mark.parametrize("row", ["packed", "v3", "gather_t", "packed_t"])
def test_packed_pe_twins_at_s2_768_match_jax(row):
    """Rows 10-13's twins against their JAX kernels (interpret mode) at N
    768, S2 768, with row 10's full blocks (over 384 hits) and fast ones,
    rows 11 and 12's 768-slot tier and row 13's 2-, 3- and 4-chunk tiers."""
    _, p = grouping(N, S2, True)
    full = (tpf.block_max(p["total2"], 64) > S2 // 2).numpy()
    assert full.any() and (~full).any()
    assert (tpf.slot_tiers(p["total2"], S2) == S2).any()
    assert (tpf.chunk_tiers(p["total2"], S2 // 4) >= 3).any()
    want = jax_row(row, N, S2, dense=True)
    nudged = jax_row(row, N, S2, True, True)
    if row == "v3":
        want, nudged = want[0], nudged[0]
    assert_rows_within_jax_spread(twin(row, p), want, nudged)
