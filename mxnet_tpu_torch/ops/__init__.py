"""Operators of the port.

`ops.paged_attention` — ragged paged attention over float and int8 pools
(hand-written kernel: csrc/paged_attention.cu).
`ops.flash_attention` — flash attention, forward and backward
(hand-written kernels: csrc/flash_attention.cu).
`ops.quantization` — int8 per-channel weights and the s8 x s8 -> s32
matmul of quantized serving (no kernel of its own).
Import the modules themselves; each entry function has its module's name.
"""
