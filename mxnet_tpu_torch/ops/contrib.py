"""Contrib ops (port of the dense share of `mxnet_tpu/ops/contrib.py`):
`khatri_rao`, `_contrib_div_sqrt_dim` and `_contrib_PagedAttention`.

`_contrib_PagedAttention` is the serving engine's paged read as a public
op, and keeps the reference's switch: with MXNET_PAGED_ATTENTION=1 it
calls `ops.paged_attention.paged_attention`, which launches the paged
kernel (K1, csrc/paged_attention.cu) on CUDA tensors or raises, and runs
its plain version on CPU tensors; with the flag off it runs that plain
version on any device: the reference's gather by table and masked
float32 softmax, the same function. The other contrib ops of the reference file (the
detection, CTC, FFT and deformable families) are listed in ROADMAP.md.
"""
from __future__ import annotations

import math

import torch

from . import paged_attention as _pa
from .registry import register


@register("khatri_rao")
def khatri_rao(*args):
    """Column-wise Khatri-Rao product of 2-D matrices A_i [M_i, N]:
    [prod(M_i), N], whose k-th column is the Kronecker product of the k-th
    columns (earlier matrices vary slowest)."""
    out = args[0]
    for m in args[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


@register("_contrib_div_sqrt_dim")
def div_sqrt_dim(data):
    """data / sqrt(size of the last axis), the attention scaler (the
    root taken in data's dtype, as the reference takes it)."""
    return data / torch.sqrt(torch.tensor(float(data.shape[-1]),
                                          dtype=data.dtype))


@register("_contrib_PagedAttention", aliases=("PagedAttention",),
          differentiable=False)
def PagedAttention(query, k_pool, v_pool, block_table, q_start,
                   block_size=16, scale=None):
    """Ragged paged attention over one layer's block pool (inference
    only). query [B, Tq, H, Dh]; k_pool / v_pool [num_blocks, block_size,
    H, Dh]; block_table [B, w] and q_start [B] (any integer or float
    dtype: they reach the kernel as contiguous int32 on query's device).
    Keys past position q_start + i are masked for query row i."""
    Dh = query.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    if _pa.paged_enabled() and query.device.type != "meta":
        tables = block_table.to(device=query.device,
                                dtype=torch.int32).contiguous()
        starts = q_start.to(device=query.device,
                            dtype=torch.int32).contiguous()
        return _pa.paged_attention(query.contiguous(), k_pool.contiguous(),
                                   v_pool.contiguous(), tables, starts,
                                   int(block_size), scale=scale)
    return _pa.paged_attention_plain(query, k_pool, v_pool, block_table,
                                     q_start, int(block_size), scale)
