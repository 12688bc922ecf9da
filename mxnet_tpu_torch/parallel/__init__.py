"""Parallelism helpers of the port (single device so far): the reference
attention of the ring-attention path, and the fused TrainStep."""
from .ring_attention import attention_reference
from .trainer import TrainStep

__all__ = ["attention_reference", "TrainStep"]
