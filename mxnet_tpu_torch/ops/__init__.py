"""Operators of the port.

`ops.paged_attention` — ragged paged attention over float and int8 pools
(hand-written kernel: csrc/paged_attention.cu).
`ops.flash_attention` — flash attention, forward and backward
(hand-written kernels: csrc/flash_attention.cu).
`ops.fused_bn` — the fused BatchNorm / ReLU / residual epilogue
(hand-written kernels: csrc/fused_bn.cu).
`ops.fused_rnn` — the persistent fused-RNN scan, forward and backward
(hand-written kernels: csrc/fused_rnn.cu).
`ops.quantization` — int8 per-channel weights and the s8 x s8 -> s32
matmul of quantized serving, and the int8 inference graph's ops
(quantize, dequantize, requantize, the quantized FullyConnected,
Convolution, Pooling and Flatten); no kernel of its own.
`ops.sparse` — the row_sparse and CSR ops (gathers, row scatters and
segment sums; no kernel of its own).
`ops.contrib` — khatri_rao, _contrib_div_sqrt_dim and
_contrib_PagedAttention, the last on the paged-attention kernel with
MXNET_PAGED_ATTENTION=1.
Import the modules themselves; each entry function has its module's name.
"""
