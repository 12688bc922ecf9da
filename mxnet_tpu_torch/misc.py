"""Deprecated learning-rate schedulers (port of `mxnet_tpu/misc.py`;
parity: the reference python/mxnet/misc.py, the pre-`lr_scheduler` module
kept for old scripts). New code should use `mxnet_tpu_torch.lr_scheduler`."""
from __future__ import annotations

import logging
import math


class LearningRateScheduler:
    def __init__(self):
        self.base_lr = 0.01

    def __call__(self, iteration):
        raise NotImplementedError("must override this")


class FactorScheduler(LearningRateScheduler):
    """base_lr * factor^(iteration // step), logging on change."""

    def __init__(self, step, factor=0.1):
        super().__init__()
        if step < 1:
            raise ValueError("step must be >= 1")
        if factor >= 1.0:
            raise ValueError("factor must be < 1 to reduce the rate")
        self.step = step
        self.factor = factor
        self._last = None

    def __call__(self, iteration):
        lr = self.base_lr * math.pow(self.factor, iteration // self.step)
        if lr != self._last:
            self._last = lr
            logging.info("Iteration [%d]: learning rate %.5f", iteration, lr)
        return lr
