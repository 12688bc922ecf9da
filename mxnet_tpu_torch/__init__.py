"""mxnet_tpu_torch: the PyTorch/CUDA port of `mxnet_tpu`, for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module
names and imports `torch` and numpy only (never `jax`, never
`mxnet_tpu`). Entry points run on the card unless the caller passes
`device="cpu"`. Every TPU kernel the ported path runs has a hand-written
Hopper kernel here (`ops/csrc/`), with a plain PyTorch version beside it
that the CPU tests use and the card checks compare against.

Ported so far: the transformer LM served through the paged KV-cache
engine (`models.transformer`, `serving`), on the paged-attention kernel
(`ops.paged_attention`), and trained with single-device SGD
(`models.lm_loss`, `models.make_transformer_train_step`), on the flash
attention forward and backward kernels (`ops.flash_attention`).
"""
from .base import MXNetError, resolve_device

__all__ = ["MXNetError", "resolve_device"]
