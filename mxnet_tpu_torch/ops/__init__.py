"""Operators of the port that carry a hand-written CUDA kernel.

`ops.paged_attention` — ragged paged attention (csrc/paged_attention.cu).
`ops.flash_attention` — flash attention, forward and backward
(csrc/flash_attention.cu).
Import the modules themselves; each entry function has its module's name.
"""
