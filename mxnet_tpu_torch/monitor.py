"""Monitor: statistics of the executors' outputs and arguments during
training (port of `mxnet_tpu/monitor.py`; upstream
`python/mxnet/monitor.py`), through `Executor.set_monitor_callback`.

Every `interval` batches, `tic` arms it; the bound executors' forward
then reports each output whose name matches `pattern`, and `toc` adds
the matching arguments and returns [(step, name, str(stat))]. The
default statistic, mean |x|, is read back to the host.
"""
from __future__ import annotations

import logging
import re


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return float(abs(x.asnumpy()).mean())
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, array):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))
        self.stat_helper = stat_helper

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Start a batch: arm the monitor every `interval` batches."""
        if self.step % self.interval == 0:
            for exe in self.exes:
                for array in exe.arg_arrays:
                    array.wait_to_read()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End a batch: [(step, name, str(stat))] of the outputs reported
        since `tic` and of the matching arguments, when armed."""
        if not self.activated:
            return []
        for exe in self.exes:
            for array in exe.arg_arrays:
                array.wait_to_read()
        for exe in self.exes:
            for name, array in zip(exe._symbol.list_arguments(),
                                   exe.arg_arrays):
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
        self.activated = False
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        res = [(n, k, str(v)) for n, k, v in self.queue]
        self.queue = []
        return res

    def toc_print(self):
        for n, k, v in self.toc():
            logging.info("Batch: {:7d} {:30s} {:s}".format(n, k, v))
