"""Training curves for notebooks (port of `mxnet_tpu/notebook/callback.py`).

`PandasLogger` gathers the training, evaluation and epoch statistics of
`Module.fit`'s callbacks into pandas DataFrames; `LiveLearningCurve`
keeps a metric's training and validation series and draws them with
matplotlib on its Agg canvas (a figure of its own, no pyplot state),
shown in place inside IPython; `args_wrapper` merges the loggers' fit
keyword arguments. pandas and matplotlib are imported when used. The
bokeh charts (`LiveBokehChart`, `LiveTimeSeries`) need bokeh, which is
optional, and raise ImportError without it.
"""
from __future__ import annotations

import collections
import time


def _pandas():
    try:
        import pandas
    except ImportError as e:
        raise ImportError("PandasLogger needs pandas") from e
    return pandas


def _metric_dict(param):
    """{name: value} of a callback parameter's eval_metric."""
    if param.eval_metric is None:
        return {}
    return dict(param.eval_metric.get_name_value())


class PandasLogger:
    """`train_df` gets a row every `frequent` training batches (epoch,
    batch, seconds since the last row, samples/s and the metrics),
    `eval_df` one a validation pass, `epoch_df` one an epoch (its
    seconds)."""

    def __init__(self, batch_size, frequent=50):
        self._pd = _pandas()
        self.batch_size = batch_size
        self.frequent = frequent
        self._rows = {"train": [], "eval": [], "epoch": []}
        self._tick = time.time()
        self._epoch_tick = time.time()

    def _frame(self, which):
        return self._pd.DataFrame(self._rows[which])

    @property
    def train_df(self):
        return self._frame("train")

    @property
    def eval_df(self):
        return self._frame("eval")

    @property
    def epoch_df(self):
        return self._frame("epoch")

    @property
    def all_dataframes(self):
        return {k: self._frame(k) for k in self._rows}

    def elapsed(self):
        return time.time() - self._tick

    def train_cb(self, param):
        if param.nbatch % self.frequent != 0:
            return
        row = {"epoch": param.epoch, "batch": param.nbatch,
               "elapsed": self.elapsed(),
               "samples/sec": self.frequent * self.batch_size /
                              max(self.elapsed(), 1e-9)}
        row.update(_metric_dict(param))
        self._rows["train"].append(row)
        self._tick = time.time()

    def eval_cb(self, param):
        row = {"epoch": param.epoch}
        row.update(_metric_dict(param))
        self._rows["eval"].append(row)

    def epoch_cb(self, *_):
        self._rows["epoch"].append(
            {"elapsed": time.time() - self._epoch_tick})
        self._epoch_tick = time.time()

    def callback_args(self):
        """Module.fit's callback keyword arguments for this logger."""
        return {"batch_end_callback": self.train_cb,
                "eval_end_callback": self.eval_cb,
                "epoch_end_callback": self.epoch_cb}


class LiveLearningCurve:
    """A metric's training series (every `frequent` batches) and
    validation series, both on the batch-step axis; inside IPython the
    figure is redrawn as they grow, elsewhere `figure()` draws it."""

    def __init__(self, metric_name="accuracy", frequent=50):
        self.metric_name = metric_name
        self.frequent = frequent
        self.train_series = collections.OrderedDict()   # step -> value
        self.eval_series = collections.OrderedDict()    # step -> value
        self._step = 0
        self._fig = None

    def _record(self, series, param):
        values = _metric_dict(param)
        if self.metric_name in values:
            series[self._step] = values[self.metric_name]
            self._redraw()

    def train_cb(self, param):
        self._step += 1
        if self._step % self.frequent == 0:
            self._record(self.train_series, param)

    def eval_cb(self, param):
        self._record(self.eval_series, param)

    def figure(self):
        """A matplotlib Figure (Agg canvas) of both series."""
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure
        fig = Figure()
        FigureCanvasAgg(fig)
        ax = fig.add_subplot()
        if self.train_series:
            ax.plot(list(self.train_series), list(self.train_series.values()),
                    label="train")
        if self.eval_series:
            ax.plot(list(self.eval_series), list(self.eval_series.values()),
                    marker="o", label="validation")
        ax.set_xlabel("step")
        ax.set_ylabel(self.metric_name)
        ax.legend(loc="best")
        self._fig = fig
        return fig

    def _redraw(self):
        try:
            from IPython import display, get_ipython
        except ImportError:
            return
        if get_ipython() is None:
            return
        display.clear_output(wait=True)
        display.display(self.figure())

    def callback_args(self):
        return {"batch_end_callback": self.train_cb,
                "eval_end_callback": self.eval_cb}


def args_wrapper(*callbacks):
    """The loggers' callback_args() merged into one Module.fit keyword
    dict, each hook a list of their callables."""
    merged = collections.defaultdict(list)
    for cb in callbacks:
        for hook, fn in cb.callback_args().items():
            merged[hook].append(fn)
    return dict(merged)


class LiveBokehChart:
    """The base of a live bokeh chart over a PandasLogger (bokeh is
    optional; without it this raises ImportError, and LiveLearningCurve
    draws with matplotlib instead)."""

    def __init__(self, pandas_logger, metric_name, display_freq=10,
                 batch_size=None, frequent=50):
        try:
            import bokeh.io  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "LiveBokehChart needs bokeh (not installed); use "
                "LiveLearningCurve for the matplotlib equivalent") from e
        self.pandas_logger = pandas_logger or PandasLogger(
            batch_size=batch_size, frequent=frequent)
        self.metric_name = metric_name
        self.display_freq = display_freq
        self.last_update = time.time()

    def setup_chart(self):
        raise NotImplementedError()

    def update_chart_data(self):
        raise NotImplementedError()

    def interval_elapsed(self):
        return time.time() - self.last_update > self.display_freq

    def _push_render(self):
        import bokeh.io
        bokeh.io.push_notebook(handle=self.handle)
        self.last_update = time.time()

    def train_cb(self, param):
        self.pandas_logger.train_cb(param)
        if self.interval_elapsed():
            self.update_chart_data()

    def eval_cb(self, param):
        self.pandas_logger.eval_cb(param)
        self.update_chart_data()

    def epoch_cb(self, *args):
        self.pandas_logger.epoch_cb(*args)

    def callback_args(self):
        return {"batch_end_callback": self.train_cb,
                "eval_end_callback": self.eval_cb,
                "epoch_end_callback": self.epoch_cb}


class LiveTimeSeries(LiveBokehChart):
    """A streaming bokeh line of values against seconds since start."""

    def __init__(self, batch_size=None, **fig_params):
        super().__init__(None, None, batch_size=batch_size)
        import bokeh.io
        import bokeh.plotting
        self.fig = bokeh.plotting.figure(**fig_params)
        self.start_time = time.time()
        self.x_axis_val = []
        self.y_axis_val = []
        self.handle = bokeh.io.show(self.fig, notebook_handle=True)

    def setup_chart(self):
        return self.fig

    def add_point(self, y_val):
        self.x_axis_val.append(time.time() - self.start_time)
        self.y_axis_val.append(y_val)
        self.fig.line(self.x_axis_val, self.y_axis_val)
        self._push_render()
