"""Composed matching transformers (counterpart of ``unopose_tpu/models/transformer.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from unopose_tpu_torch.models.attention import LinearTransformerLayer, RPETransformerLayer, TransformerLayer
from unopose_tpu_torch.ops.fps import gather_points


class GeometricTransformer(nn.Module):
    """"self" = RPE layer on each cloud (both clouds as one 2B batch, the
    layers share weights), "cross" = vanilla layer, cloud 1 attending the
    already-updated cloud 0."""

    def __init__(self, blocks: Sequence[str], d_model: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.blocks = tuple(blocks)
        for i, block in enumerate(self.blocks):
            if block == "self":
                layer = RPETransformerLayer(d_model, num_heads, dtype)
            elif block == "cross":
                layer = TransformerLayer(d_model, num_heads, dtype)
            else:
                raise ValueError(block)
            setattr(self, f"layer{i}", layer)

    def forward(self, feats0, emb0, feats1, emb1):
        """emb0/emb1: (B, N, N, C) embeddings, or (codes, scale) pairs of the
        int8 embedding sharing one scale object; both stack along the batch."""
        quantized = isinstance(emb0, tuple)
        t0, t1 = (emb0[0], emb1[0]) if quantized else (emb0, emb1)
        if feats0.shape != feats1.shape or t0.shape != t1.shape:
            raise ValueError("both clouds must have the same token count")
        if quantized and emb0[1] is not emb1[1]:
            raise ValueError("the two clouds' int8 embeddings must share one scale")
        B = feats0.shape[0]
        emb = torch.cat([t0, t1], dim=0)
        if quantized:
            emb = (emb, emb0[1])
        for i, block in enumerate(self.blocks):
            layer = getattr(self, f"layer{i}")
            if block == "self":
                x = torch.cat([feats0, feats1], dim=0)
                x = layer(x, x, emb)
                feats0, feats1 = x[:B], x[B:]
            else:
                feats0 = layer(feats0, feats1)
                feats1 = layer(feats1, feats0)
        return feats0, feats1


class SparseToDenseTransformer(nn.Module):
    """Fine-stage block: gather the FPS subset of the dense tokens (bg token
    kept at 0), geometric transformer on it, then a linear-attention update
    of all dense tokens from the sparse set.

    The gather indexes the dense tokens past the bg token, so that sparse
    token j carries the features of the point whose geometry made embedding
    j. ``parity_gather`` reproduces the reference's quirk instead: it gathers
    ``fps_idx`` on the bg-augmented array, one dense slot off, as weights
    trained by the reference expect (a converted checkpoint,
    ``utils/ref_convert.py``)."""

    def __init__(self, d_model: int, sparse_blocks: Sequence[str], num_heads: int, focusing_factor: float,
                 dtype: torch.dtype, parity_gather: bool = False):
        super().__init__()
        self.parity_gather = parity_gather
        self.sparse_layer = GeometricTransformer(sparse_blocks, d_model, num_heads, dtype)
        self.dense_layer = LinearTransformerLayer(d_model, num_heads, focusing_factor, dtype)

    def _sample_feats(self, dense_feats, fps_idx):
        src = dense_feats if self.parity_gather else dense_feats[:, 1:]
        return torch.cat([dense_feats[:, :1], gather_points(src, fps_idx)], dim=1)

    def forward(self, dense_feats0, emb0, fps_idx0, dense_feats1, emb1, fps_idx1):
        feats0 = self._sample_feats(dense_feats0, fps_idx0)
        feats1 = self._sample_feats(dense_feats1, fps_idx1)
        feats0, feats1 = self.sparse_layer(feats0, emb0, feats1, emb1)
        B = dense_feats0.shape[0]
        new = self.dense_layer(
            torch.cat([dense_feats0[:, 1:], dense_feats1[:, 1:]], dim=0),
            torch.cat([feats0[:, 1:], feats1[:, 1:]], dim=0),
        )
        return torch.cat([feats0[:, :1], new[:B]], dim=1), torch.cat([feats1[:, :1], new[B:]], dim=1)
