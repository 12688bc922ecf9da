"""TensorBoard logging (port of `mxnet_tpu/contrib/tensorboard.py`).

`LogMetricsCallback` writes every metric of a fit callback's
`eval_metric` as a scalar through `torch.utils.tensorboard.SummaryWriter`
(imported when the callback is made); when that import fails (no
`tensorboard` package) it writes the reference's JSONL records instead,
one {"tag", "value", "step", "wall_time"} a line in
`<logging_dir>/metrics.jsonl`.
"""
from __future__ import annotations

import json
import os
import time


class _JsonlWriter:
    """The sink without tensorboard: one JSON record a scalar."""

    def __init__(self, logging_dir):
        os.makedirs(logging_dir, exist_ok=True)
        self._f = open(os.path.join(logging_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step),
                                  "wall_time": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def _make_writer(logging_dir):
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(logging_dir)
    except Exception:
        return _JsonlWriter(logging_dir)


class LogMetricsCallback:
    """A batch-end (or epoch-end) callback logging each metric of
    `param.eval_metric` at an increasing step, its tag prefixed by
    `prefix-` when given:

        mod.fit(..., batch_end_callback=[
            mx.contrib.tensorboard.LogMetricsCallback('logs/train')])
    """

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.step = 0
        self.summary_writer = _make_writer(logging_dir)

    def __call__(self, param):
        self.step += 1
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = "%s-%s" % (self.prefix, name)
            self.summary_writer.add_scalar(name, value, self.step)
