"""Hand-written CUDA kernels for Hopper (sm_90a) and their build.

``csrc/`` holds the sources; ``build.load()`` compiles them at first use.
The Python wrappers live beside their plain PyTorch twins in ``ops/``:
``ops/fps.py:fps_cuda``, ``ops/gather.py:gather_planar_cuda``,
``ops/ball_query.py:first_k_select_cuda``,
``ops/geo_fused.py:geo_rpe_fused_cuda``, ``ops/pe_fused.py:pe_channels_cuda``,
``ops/pe_fused.py:pe_mlp_pool_cuda``, ``ops/vit_attn.py:mha_fused_cuda``,
``ops/ball_query.py:ball_group_subset_cuda``, ``ops/pe_fused.py:pe_fused_masked_cuda``,
the three sweeps of ``ops/assignment_fused.py`` (``colstats_cuda``,
``labels_cuda``, ``accum_cuda``), the four passes of the PE train stack
in ``ops/pe_train.py`` (``stats_cuda``, ``fwd_cuda``, ``bwd_sums_cuda``,
``bwd_dw_cuda``) and its frozen-BN backward (``frozen_bwd_cuda``), and the
coarse hypothesis selection's two modes in ``ops/hyp_select.py``
(``hypothesis_select_scores_cuda``, ``hypothesis_select_scores_v2_cuda``:
``hyp_select`` and ``hyp_select_v2``), and the packed fine PE in the JAX
package's other layouts in ``ops/pe_fused.py`` (``pe_fused_packed_cuda``,
``pe_mlp_pool_packed_cuda``, ``pe_fused_gather_t_cuda``,
``pe_fused_packed_t_cuda``: ``pe_packed``, ``pe_mlp_pool_packed``,
``pe_gather_fused`` and ``pe_packed_t``), and the TPU profiling kernels of
the JAX package's ``benchmarks/`` beside the scripts that time them in
``benchmarks/`` (``profile_r9.py:r9_variant_cuda``,
``profile_pe_ablate.py:pe_ablate_cuda``, ``profile_compact_micro.py``'s
``compact_rounds_cuda``, ``compact_gather_cuda`` and
``compact_wherechain_cuda``). Each wrapper counts its launches in
``LAUNCHES`` under its kernel's name.
"""

from __future__ import annotations

from collections import Counter

LAUNCHES: Counter = Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()
