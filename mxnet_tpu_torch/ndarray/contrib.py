"""mx.nd.contrib (port of `mxnet_tpu/ndarray/contrib.py`): every
registered `_contrib_*` op under its name without the prefix, `CTCLoss`
(the `ctc_loss` op), plus `quadratic`, `rand_zipfian` and `foreach`."""
import math as _math

from ..ops import registry as _registry
from .ndarray import make_nd_func as _make_nd_func


def _make(opname):
    fn = _make_nd_func(_registry.get(opname))
    fn.__name__ = opname.replace("_contrib_", "")
    return fn


for _opname in _registry.list_ops():
    if _opname.startswith("_contrib_"):
        globals()[_opname[len("_contrib_"):]] = _make(_opname)
del _opname
CTCLoss = ctc_loss  # noqa: F821  (made by the loop above)
quadratic = _make("quadratic")


def rand_zipfian(true_classes, num_sampled, range_max, ctx=None):
    """Log-uniform (Zipfian) candidate sampler: (sampled classes,
    expected count of each true class, expected count of each sample),
    P(c) = log((c + 2) / (c + 1)) / log(range_max + 1), drawn with
    replacement from the port's generators. The pipeline runs in float32
    and int32, as the reference's, which is exact for range_max up to
    2^24; past that it raises."""
    if range_max > (1 << 24):
        raise ValueError(
            "rand_zipfian: range_max %d exceeds the float32 sampling "
            "pipeline's exact range (2^24)" % range_max)
    from . import random as _nd_random
    log_range = _math.log(range_max + 1)
    rand = _nd_random.uniform(0, log_range, shape=(num_sampled,), ctx=ctx)
    # u ~ U(0, log(R + 1)) => floor(e^u - 1) is log-uniform over [0, R)
    sampled = (rand.exp() - 1).astype("int32") % range_max

    def expected_count(cls_float):
        prob = ((cls_float + 2.0) / (cls_float + 1.0)).log() / log_range
        return prob * num_sampled

    return (sampled,
            expected_count(true_classes.astype("float32")),
            expected_count(sampled.astype("float32")))


def foreach(body, data, init_states):
    """body(data[i], states) -> (out, states) over the first axis of
    data: the stacked outputs and the last states (a Python loop, as the
    reference's eager foreach)."""
    states = init_states if isinstance(init_states, list) else [init_states]
    outputs = []
    for i in range(data.shape[0]):
        out, states = body(data[i], states)
        outputs.append(out)
    from . import stack
    return stack(*outputs, axis=0), states
