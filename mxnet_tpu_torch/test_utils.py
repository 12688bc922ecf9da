"""Test helpers (port of `mxnet_tpu/test_utils.py`, every public name).

- contexts and shapes: `default_context` (the current context: `gpu(0)`
  unless a `with mx.cpu():` is open), `set_default_context`,
  `default_dtype`, `rand_shape_2d` / `_3d` / `_nd`;
- comparison: `assert_almost_equal` and friends, the per-dtype
  tolerances `get_rtol` / `get_atol`, the NaN-ignoring pair;
- symbolic checks on the port's executor: `simple_forward`,
  `check_numeric_gradient` / `numeric_grad` (central differences),
  `check_symbolic_forward` / `backward`, `check_consistency` (one Symbol
  bound on each context, each on its own device);
- timing and helpers: `check_speed`, `discard_stderr`, `retry`,
  `random_arrays`, `random_sample`, `DummyIter`, `list_gpus`,
  `set_env_var`;
- statistical checks of samplers: `mean_check`, `var_check`,
  `chi_square_check`, `verify_generator` (scipy, imported when called);
- data: the hermetic synthetic MNIST and its iterators, the synthetic
  detection dataset, the random sparse arrays, and the fetchers
  (`get_mnist_pkl`, `get_mnist_ubyte`, `get_cifar10`, ...), which write
  the reference's file layouts from synthetic data and read local files;
  `download` returns an existing file without fetching.

Random draws come from numpy's global generator, in the reference's
order, so one seed gives both packages the same arrays.
"""
from __future__ import annotations

import contextlib
import functools
import os
import sys
import time

import numpy as np


def default_context():
    """The current context (`gpu(0)` outside any `with ctx:`)."""
    from .context import current_context
    return current_context()


def set_default_context(ctx):
    """Make `ctx` this thread's current context."""
    from .context import Context
    Context._default_ctx.value = ctx


def default_dtype():
    return np.float32


def rand_shape_2d(dim0=10, dim1=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1),
            np.random.randint(1, dim2 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=num_dim))


def get_mnist():
    """{train,test}_{data,label}: the synthetic MNIST of
    `gluon.data.vision.MNIST` as NCHW float32 in [0, 1] and int32 labels
    (6000 training, 1000 test images), value for value the reference's."""
    from .gluon.data.vision.datasets import _synthetic
    tr_d, tr_l = _synthetic(6000, (28, 28, 1), 10, 42)
    te_d, te_l = _synthetic(1000, (28, 28, 1), 10, 43)
    return {"train_data": tr_d.transpose(0, 3, 1, 2).astype(np.float32) / 255,
            "train_label": tr_l,
            "test_data": te_d.transpose(0, 3, 1, 2).astype(np.float32) / 255,
            "test_label": te_l}


def get_mnist_iterator(batch_size, input_shape, num_parts=1, part_index=0):
    """(train, val) NDArrayIters over `get_mnist()` reshaped to
    (-1, *input_shape); the training one shuffles (numpy's global
    generator) and takes every num_parts-th image from part_index."""
    from .io import NDArrayIter
    mnist = get_mnist()
    shape = (-1,) + tuple(input_shape)
    train = NDArrayIter(
        mnist["train_data"].reshape(shape)[part_index::num_parts],
        mnist["train_label"][part_index::num_parts], batch_size,
        shuffle=True)
    val = NDArrayIter(mnist["test_data"].reshape(shape), mnist["test_label"],
                      batch_size)
    return train, val


def synthetic_det_images(num_images=40, size=48, num_classes=2, seed=0):
    """(images, imglist) of `make_synthetic_det_dataset` without the
    files: HWC uint8 RGB arrays, and [flat_det_label, filename] rows."""
    rng = np.random.RandomState(seed)
    images, imglist = [], []
    for i in range(num_images):
        img = rng.randint(0, 60, (size, size, 3)).astype(np.uint8)
        objs = []
        for _ in range(rng.randint(1, 3)):
            cls = rng.randint(num_classes)
            w = rng.randint(size // 4, size // 2)
            h = rng.randint(size // 4, size // 2)
            x0 = rng.randint(0, size - w)
            y0 = rng.randint(0, size - h)
            img[y0:y0 + h, x0:x0 + w, cls] = 230
            objs += [float(cls), x0 / size, y0 / size,
                     (x0 + w) / size, (y0 + h) / size]
        images.append(img)
        imglist.append([[2.0, 5.0] + objs, "img%04d.jpg" % i])
    return images, imglist


def make_synthetic_det_dataset(path, num_images=40, size=48, num_classes=2,
                               seed=0):
    """Write a synthetic detection dataset under `path`: noise images
    with 1-2 solid rectangles, class c filling channel c, as JPEG files.
    Returns the imglist of [flat_det_label, filename] rows in im2rec's
    detection label format [2, 5, (cls, xmin, ymin, xmax, ymax)*],
    corners normalized. Writing needs OpenCV."""
    from .image import _cv2
    cv2 = _cv2("make_synthetic_det_dataset")
    images, imglist = synthetic_det_images(num_images, size, num_classes,
                                           seed)
    os.makedirs(path, exist_ok=True)
    for img, (_, fname) in zip(images, imglist):
        cv2.imwrite(os.path.join(path, fname),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return imglist


def _to_np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


def rand_ndarray(shape, stype="default", density=None, dtype=None,
                 distribution=None):
    """A random array in [-1, 1): dense, or row_sparse with a share
    `density` (0.5 by default) of its rows kept, or csr with that share
    of rows and of entries kept."""
    from .ndarray import NDArray
    from .ndarray.sparse import CSRNDArray, RowSparseNDArray
    density = density if density is not None else 0.5
    dtype = dtype or np.float32
    if stype == "default":
        return NDArray(np.random.uniform(-1, 1, shape).astype(dtype))
    dense = np.random.uniform(-1, 1, shape).astype(dtype)
    mask = np.random.rand(shape[0]) < density
    dense[~mask] = 0
    if stype == "row_sparse":
        return RowSparseNDArray.from_dense(NDArray(dense))
    if stype == "csr":
        flat_mask = np.random.rand(*shape) < density
        dense = np.where(flat_mask, dense, 0)
        return CSRNDArray.from_dense(NDArray(dense))
    raise ValueError(stype)


def rand_sparse_ndarray(shape, stype, density=None, dtype=None):
    """(`rand_ndarray(shape, stype, ...)`, its stored ids)."""
    arr = rand_ndarray(shape, stype, density, dtype)
    return arr, getattr(arr, "_indices", None)


def shuffle_csr_column_indices(csr):
    """The csr with each row's (column, value) pairs in a shuffled order
    (a fixture of unsorted columns)."""
    from .ndarray.sparse import CSRNDArray
    indices = csr._indices.cpu().numpy().copy()
    indptr = csr._indptr.cpu().numpy()
    for i in range(len(indptr) - 1):
        seg = indices[indptr[i]:indptr[i + 1]]
        np.random.shuffle(seg)
        indices[indptr[i]:indptr[i + 1]] = seg
    return CSRNDArray(csr._values, indices, csr._indptr, csr.shape,
                      ctx=csr.context)


def create_sparse_array(shape, stype, data_init=None, rsp_indices=None,
                        dtype=None, modifier_func=None, density=0.5,
                        shuffle_csr_indices=False):
    """A random sparse array; `rsp_indices` pins which rows a row_sparse
    one holds (values from np.random.randn), `data_init` sets every
    nonzero value, `modifier_func` maps every value."""
    from . import ndarray as nd
    from .ndarray.sparse import RowSparseNDArray
    if rsp_indices is not None:
        if stype != "row_sparse":
            raise ValueError("rsp_indices only applies to row_sparse")
        idx = np.sort(np.asarray(rsp_indices).astype(np.int32))
        vals = np.random.randn(len(idx), *shape[1:]).astype(
            np.dtype(dtype) if dtype else np.float32)
        arr = RowSparseNDArray(idx, vals, shape)
    else:
        arr = rand_ndarray(shape, stype=stype, density=density,
                           dtype=dtype)
    if data_init is not None:
        d = _to_np(arr)
        d[d != 0] = data_init
        arr = nd.array(d).tostype(stype)
    if modifier_func is not None:
        d = np.vectorize(modifier_func)(_to_np(arr))
        arr = nd.array(d).tostype(stype)
    if stype == "csr" and shuffle_csr_indices:
        arr = shuffle_csr_column_indices(arr)
    return arr


def create_sparse_array_zd(shape, stype, density, data_init=None,
                           rsp_indices=None, dtype=None,
                           modifier_func=None, shuffle_csr_indices=False):
    """`create_sparse_array`, or an all-zero array at density 0."""
    if density == 0:
        from .ndarray import sparse as _sp
        return _sp.zeros(stype, shape, dtype=dtype)
    return create_sparse_array(shape, stype, data_init=data_init,
                               rsp_indices=rsp_indices, dtype=dtype,
                               modifier_func=modifier_func,
                               density=density,
                               shuffle_csr_indices=shuffle_csr_indices)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def np_reduce(dat, axis, keepdims, numpy_reduce_func):
    """`numpy_reduce_func` over each axis of `axis` (an int, a sequence or
    None for all), last first; keepdims restores the reduced axes as 1."""
    if isinstance(axis, int):
        axis = [axis]
    else:
        axis = list(axis) if axis is not None else range(len(dat.shape))
    ret = dat
    for i in reversed(sorted(axis)):
        ret = numpy_reduce_func(ret, axis=i)
    if keepdims:
        keepdims_shape = list(dat.shape)
        for i in axis:
            keepdims_shape[i] = 1
        ret = ret.reshape(tuple(keepdims_shape))
    return ret


def find_max_violation(a, b, rtol=None, atol=None):
    """(index, value) of the largest |a - b| / (atol + rtol |b|)."""
    rtol = 1e-5 if rtol is None else rtol
    atol = 1e-20 if atol is None else atol
    diff = np.abs(a - b)
    tol = atol + rtol * np.abs(b)
    violation = diff / (tol + 1e-20)
    loc = np.argmax(violation)
    idx = np.unravel_index(loc, violation.shape)
    return idx, np.max(violation)


def same(a, b):
    return np.array_equal(a, b)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """Raise AssertionError, naming the worst element, unless
    numpy.allclose(a, b, rtol, atol) holds in float64 (rtol 1e-5 and
    atol 1e-20 by default); NDArrays are read back to the host."""
    rtol = 1e-5 if rtol is None else rtol
    atol = 1e-20 if atol is None else atol
    a = np.asarray(_to_np(a), dtype=np.float64)
    b = np.asarray(_to_np(b), dtype=np.float64)
    if np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan):
        return
    index, rel = find_max_violation(a, b, rtol, atol)
    raise AssertionError(
        "Error %f exceeds tolerance rtol=%f, atol=%f. Location of maximum "
        "error:%s, %s=%f, %s=%f" % (rel, rtol, atol, str(index), names[0],
                                    a[index], names[1], b[index]))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    try:
        assert_almost_equal(a, b, rtol, atol, equal_nan=equal_nan)
        return True
    except AssertionError:
        return False


_RTOLS = {np.dtype(np.float16): 1e-2, np.dtype(np.float32): 1e-4,
          np.dtype(np.float64): 1e-5}
_ATOLS = {np.dtype(np.float16): 1e-1, np.dtype(np.float32): 1e-3,
          np.dtype(np.float64): 1e-20}


def get_rtol(rtol=None, dtype=np.float32):
    """`rtol`, else the default relative tolerance of `dtype`."""
    if rtol is not None:
        return rtol
    return _RTOLS.get(np.dtype(dtype), 1e-4)


def get_atol(atol=None, dtype=np.float32):
    """`atol`, else the default absolute tolerance of `dtype`."""
    if atol is not None:
        return atol
    return _ATOLS.get(np.dtype(dtype), 1e-3)


def almost_equal_ignore_nan(a, b, rtol=None, atol=None):
    """numpy.allclose of a and b with every position where either is NaN
    set to 0 in both; the tolerances default by a's dtype."""
    a, b = _to_np(a).copy(), _to_np(b).copy()
    nan_mask = np.logical_or(np.isnan(a), np.isnan(b))
    a[nan_mask] = 0
    b[nan_mask] = 0
    return np.allclose(a, b, rtol=get_rtol(rtol, a.dtype),
                       atol=get_atol(atol, a.dtype))


def assert_almost_equal_ignore_nan(a, b, rtol=None, atol=None, names=()):
    if not almost_equal_ignore_nan(a, b, rtol, atol):
        raise AssertionError(
            "arrays differ beyond tolerance (NaNs ignored)%s"
            % (": %s" % (names,) if names else ""))


def assert_exception(f, exception_type, *args, **kwargs):
    """f(*args, **kwargs) must raise exception_type."""
    try:
        f(*args, **kwargs)
    except exception_type:
        return
    raise AssertionError("did not raise %s" % exception_type.__name__)


def same_array(array1, array2):
    """True when an update of array1 shows in array2 (probed by adding 1
    and taking it back): the two are one array."""
    array1[:] = array1 + 1
    if not np.array_equal(_to_np(array1), _to_np(array2)):
        array1[:] = array1 - 1
        return False
    array1[:] = array1 - 1
    return np.array_equal(_to_np(array1), _to_np(array2))


def assign_each(input_arr, function):
    """An NDArray of `function` applied to each element (on the host)."""
    from . import ndarray as nd
    return nd.array(np.vectorize(function)(_to_np(input_arr)))


def assign_each2(input1, input2, function):
    from . import ndarray as nd
    return nd.array(np.vectorize(function)(_to_np(input1), _to_np(input2)))


# ---------------------------------------------------------------------------
# symbolic checks on the executor
# ---------------------------------------------------------------------------

def _nd(value, ctx):
    """An NDArray of `value` (an NDArray or array-like) on ctx, float64
    narrowed to float32 as every NDArray is."""
    from .ndarray import NDArray
    if isinstance(value, NDArray):
        return value if ctx is None else value.as_in_context(ctx)
    return NDArray(np.asarray(value), ctx=ctx)


def _aux(aux_states, ctx):
    if not isinstance(aux_states, dict):
        return None
    return {k: _nd(v, ctx) for k, v in aux_states.items()}


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    """The outputs (numpy; one array for one output) of `sym` bound on
    ctx (the current context by default) to the named float32 inputs."""
    from .ndarray import NDArray
    inputs = {k: v if isinstance(v, NDArray)
              else _nd(np.asarray(v, dtype=np.float32), ctx)
              for k, v in inputs.items()}
    exe = sym.bind(ctx, args=inputs, grad_req="null")
    exe.forward(is_train=is_train)
    outputs = [x.asnumpy() for x in exe.outputs]
    if len(outputs) == 1:
        outputs = outputs[0]
    return outputs


def _parse_location(sym, location, ctx):
    """{argument name: NDArray on ctx} from a dict by name or a list in
    `sym.list_arguments()` order; float64 values become float32."""
    from .ndarray import NDArray
    if isinstance(location, dict):
        wrong = set(location.keys()) - set(sym.list_arguments())
        assert not wrong, "Location keys %s not in arguments %s" % (
            wrong, sym.list_arguments())
        items = location.items()
    else:
        items = zip(sym.list_arguments(), location)
    location = {k: v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)
                for k, v in items}
    return {k: _nd(v.astype(np.float32) if v.dtype == np.float64 else v,
                   ctx) for k, v in location.items()}


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None,
                           use_forward_train=True, ctx=None,
                           grad_stype_dict=None, dtype=np.float32):
    """The executor's gradients of the summed outputs (head gradients of
    ones) against central differences of step `numeric_eps`, each
    element moved in float64 and run in float32; atol 1e-4 by default."""
    location = _parse_location(sym, location, ctx)
    if grad_nodes is None:
        grad_nodes = list(location)
    aux = _aux(aux_states, ctx)

    def fwd(loc_np):
        args = {k: _nd(v, ctx) for k, v in loc_np.items()}
        exe = sym.bind(ctx, args=args, grad_req="null", aux_states=aux)
        exe.forward(is_train=use_forward_train)
        return sum(float(np.sum(o.asnumpy())) for o in exe.outputs)

    args = {k: v.copy() for k, v in location.items()}
    req = {k: ("write" if k in grad_nodes else "null") for k in args}
    exe = sym.bind(ctx, args=args, grad_req=req, aux_states=aux)
    exe.forward(is_train=use_forward_train)
    exe.backward()
    analytic = {k: exe.grad_dict[k].asnumpy() for k in grad_nodes}

    loc_np = {k: v.asnumpy().astype(np.float64) for k, v in location.items()}
    for name in grad_nodes:
        arr = loc_np[name]
        num_grad = np.zeros_like(arr)
        it = np.nditer(arr, flags=["multi_index"])
        while not it.finished:
            idx = it.multi_index
            orig = arr[idx]
            arr[idx] = orig + numeric_eps / 2
            f_plus = fwd({k: v.astype(np.float32) for k, v in loc_np.items()})
            arr[idx] = orig - numeric_eps / 2
            f_minus = fwd({k: v.astype(np.float32)
                           for k, v in loc_np.items()})
            arr[idx] = orig
            num_grad[idx] = (f_plus - f_minus) / numeric_eps
            it.iternext()
        assert_almost_equal(analytic[name], num_grad, rtol=rtol,
                            atol=atol if atol is not None else 1e-4,
                            names=("analytic_%s" % name, "numeric_%s" % name))


def check_symbolic_forward(sym, location, expected, rtol=1e-5, atol=None,
                           aux_states=None, ctx=None, equal_nan=False,
                           dtype=np.float32):
    """The inference outputs of `sym` at `location` against `expected`
    (a list in output order, or a dict by output name); returns the
    output NDArrays."""
    location = _parse_location(sym, location, ctx)
    exe = sym.bind(ctx, args=location, grad_req="null",
                   aux_states=_aux(aux_states, ctx))
    exe.forward(is_train=False)
    if isinstance(expected, dict):
        expected = [expected[k] for k in sym.list_outputs()]
    for out, exp in zip(exe.outputs, expected):
        assert_almost_equal(out.asnumpy(), exp, rtol=rtol,
                            atol=atol if atol is not None else 1e-20,
                            equal_nan=equal_nan)
    return exe.outputs


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=None, aux_states=None, grad_req="write",
                            ctx=None, grad_stypes=None, equal_nan=False,
                            dtype=np.float32):
    """The gradients of a training forward at `location` with head
    gradients `out_grads` (ones when None) against `expected` (a list in
    argument order, or a dict by name); an argument without an expected
    gradient gets grad_req "null" unless grad_req is a dict. Returns the
    gradient NDArrays in argument order (None where not computed)."""
    location = _parse_location(sym, location, ctx)
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(sym.list_arguments(), expected))
    req = {k: (grad_req if isinstance(grad_req, str)
               else grad_req.get(k, "write")) for k in location}
    for k in req:
        if k not in expected and req[k] == "write":
            req[k] = "null" if not isinstance(grad_req, dict) else req[k]
    exe = sym.bind(ctx, args=location, grad_req=req,
                   aux_states=_aux(aux_states, ctx))
    exe.forward(is_train=True)
    ograds = [_nd(np.asarray(g, dtype=np.float32), ctx) for g in out_grads] \
        if out_grads is not None else None
    exe.backward(ograds)
    for name, exp in expected.items():
        assert_almost_equal(exe.grad_dict[name].asnumpy(), exp, rtol=rtol,
                            atol=atol if atol is not None else 1e-20,
                            equal_nan=equal_nan)
    return [exe.grad_dict.get(k) for k in sym.list_arguments()]


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write",
                      arg_params=None, aux_params=None, tol=None,
                      raise_on_err=True, ground_truth=None, equal_nan=False,
                      *, errors=None):
    """Bind `sym` (or one Symbol a context) once for each spec of
    `ctx_list` ({"ctx": Context, <input>: shape, ..., "type_dict": ...}),
    each on its own context's device (a gpu context without CUDA raises),
    and hold every context's outputs to the first's (or to
    `ground_truth`), and, when grad_req is not "null", its gradients to
    the first's, within rtol = atol = `tol` (1e-3).

    The inputs named in a spec get np.random.normal(0, scale) after
    np.random.seed(1), the other arguments after np.random.seed(0) in
    sorted order (unless `arg_params` gives them), so every context sees
    the same values; a training forward runs when grad_req is not "null",
    then a backward with head gradients of ones. `errors`, a dict, gets
    the largest violation (a fraction of the tolerance) of the outputs
    and of the gradients. With raise_on_err false a mismatch is printed,
    not raised. Returns each context's outputs (lists of numpy arrays)."""
    from .context import current_context
    from .ndarray import NDArray
    tol = tol or 1e-3
    if isinstance(sym, (list, tuple)):
        syms = list(sym)
    else:
        syms = [sym] * len(ctx_list)
    outputs, grads = [], []
    for s, spec in zip(syms, ctx_list):
        ctx = spec.get("ctx", current_context())
        shapes = {k: v for k, v in spec.items()
                  if k not in ("ctx", "type_dict")}
        exe = s.simple_bind(ctx, grad_req=grad_req,
                            type_dict=spec.get("type_dict"), **shapes)

        def put(arrays, name, value):
            arrays[name]._data = NDArray(np.asarray(value), ctx=ctx)._data
        if arg_params:
            for k, v in arg_params.items():
                if k in exe.arg_dict:
                    put(exe.arg_dict, k, _to_np(v))
        else:
            np.random.seed(0)
            for k in sorted(exe.arg_dict):
                if k not in shapes:
                    put(exe.arg_dict, k, np.random.normal(
                        0, scale, exe.arg_dict[k].shape).astype(np.float32))
        for k, v in (aux_params or {}).items():
            if k in exe.aux_dict:
                put(exe.aux_dict, k, _to_np(v))
        np.random.seed(1)
        for k in sorted(shapes):
            put(exe.arg_dict, k,
                np.random.normal(0, scale, shapes[k]).astype(np.float32))
        exe.forward(is_train=grad_req != "null")
        outputs.append([o.asnumpy() for o in exe.outputs])
        if grad_req != "null":
            exe.backward()
            grads.append({k: v.asnumpy() for k, v in exe.grad_dict.items()})
    ref = ground_truth or outputs[0]
    pairs = [("output %d of context %d" % (j, i), o, r)
             for i, out in enumerate(outputs[1:], 1)
             for j, (o, r) in enumerate(zip(out, ref))]
    pairs_g = [("gradient of %s, context %d" % (k, i), g[k], grads[0][k])
               for i, g in enumerate(grads[1:], 1) for k in sorted(g)
               if k in grads[0]]
    if errors is not None:
        for key, group in (("outputs", pairs), ("grads", pairs_g)):
            errors[key] = max([float(find_max_violation(
                np.asarray(a, np.float64), np.asarray(b, np.float64),
                tol, tol)[1]) for _, a, b in group] or [0.0])
    for what, a, b in pairs + pairs_g:
        try:
            assert_almost_equal(a, b, rtol=tol, atol=tol, equal_nan=equal_nan,
                                names=(what, "context 0"))
        except AssertionError as e:
            if raise_on_err:
                raise
            print("check_consistency: %s" % e)
    return outputs


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True, dtype=np.float32):
    """Central differences (step eps) of the executor's summed outputs
    with respect to every argument of `location` (numpy arrays by name),
    written into the executor's arguments one element at a time; the
    arguments end at `location`'s values. Returns {name: gradient}."""
    for k, v in location.items():
        if k in executor.arg_dict:
            executor.arg_dict[k][:] = np.asarray(v)
    approx_grads = {k: np.zeros(v.shape, dtype=dtype)
                    for k, v in location.items()}
    for k, v in location.items():
        if k not in executor.arg_dict:
            continue
        old_value = np.array(v, dtype=dtype).copy()
        flat = old_value.reshape(-1)
        grad_flat = approx_grads[k].reshape(-1)
        for i in range(flat.size):
            flat[i] += eps / 2.0
            executor.arg_dict[k][:] = old_value
            executor.forward(is_train=use_forward_train)
            f_eps = sum(float(o.asnumpy().sum()) for o in executor.outputs)
            flat[i] -= eps
            executor.arg_dict[k][:] = old_value
            executor.forward(is_train=use_forward_train)
            f_neps = sum(float(o.asnumpy().sum())
                         for o in executor.outputs)
            grad_flat[i] = (f_eps - f_neps) / eps
            flat[i] += eps / 2.0
        executor.arg_dict[k][:] = old_value
    return approx_grads


# ---------------------------------------------------------------------------
# timing and small helpers
# ---------------------------------------------------------------------------

def check_speed(sym, location=None, ctx=None, N=20, grad_req=None,
                typ="whole"):
    """Seconds a call of the bound `sym` on ctx (the current context by
    default) takes, over N calls after one warm-up, ended by
    `nd.waitall()` (which synchronises the card): typ "whole" times a
    training forward and a backward, "forward" an inference forward.
    `location` gives the inputs by name (normal draws of every argument
    by default)."""
    from . import ndarray as nd
    from .context import current_context
    ctx = ctx or current_context()
    if grad_req is None:
        grad_req = "write"
    if location is None:
        arg_shapes, _, _ = sym.infer_shape()
        location = {name: np.random.normal(size=shape, scale=1.0)
                    for name, shape in zip(sym.list_arguments(),
                                           arg_shapes)}
    exe = sym.simple_bind(ctx, grad_req=grad_req,
                          **{k: v.shape for k, v in location.items()})
    for name, value in location.items():
        if name in exe.arg_dict:
            exe.arg_dict[name][:] = np.asarray(value)
    if typ == "whole":
        def run():
            exe.forward(is_train=True)
            exe.backward(out_grads=exe.outputs)
            for o in exe.outputs:
                o.wait_to_read()
    elif typ == "forward":
        def run():
            exe.forward(is_train=False)
            for o in exe.outputs:
                o.wait_to_read()
    else:
        raise ValueError("typ can only be whole or forward")
    run()
    tic = time.time()
    for _ in range(N):
        run()
    nd.waitall()
    return (time.time() - tic) / N


def discard_stderr():
    """A context manager that sends file descriptor 2 (C-level stderr
    too) to /dev/null."""
    @contextlib.contextmanager
    def _ctx():
        with open(os.devnull, "w") as devnull:
            old = os.dup(2)
            os.dup2(devnull.fileno(), 2)
            try:
                yield
            finally:
                sys.stderr.flush()
                os.dup2(old, 2)
                os.close(old)
    return _ctx()


def retry(n):
    """A decorator running the test up to n times while it raises
    AssertionError; the last failure propagates."""
    if n <= 0:
        raise ValueError("n must be positive")

    def decorate(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            for i in range(n):
                try:
                    return f(*args, **kwargs)
                except AssertionError:
                    if i == n - 1:
                        raise
        return wrapper
    return decorate


def random_arrays(*shapes):
    """float32 arrays of np.random.randn of each shape (a 0-d array for
    an empty shape); one shape gives the array, not a list."""
    arrays = [np.array(np.random.randn(), dtype=np.float32) if not s
              else np.random.randn(*s).astype(np.float32) for s in shapes]
    return arrays[0] if len(arrays) == 1 else arrays


def random_sample(population, k):
    """k items of population without replacement, in population order."""
    import random as _random
    assert k <= len(population)
    picks = sorted(_random.sample(range(len(population)), k))
    return [population[i] for i in picks]


class DummyIter(object):
    """Repeats the first batch of `real_iter` forever (takes the loader
    out of a timing)."""

    def __init__(self, real_iter):
        self.real_iter = real_iter
        self.provide_data = real_iter.provide_data
        self.provide_label = real_iter.provide_label
        self.batch_size = real_iter.batch_size
        self.the_batch = next(iter(real_iter))

    def __iter__(self):
        return self

    def next(self):
        return self.the_batch

    __next__ = next

    def reset(self):
        """Nothing to rewind (an epoch loop calls it)."""


def list_gpus():
    """The CUDA device ids torch sees."""
    import torch
    return list(range(torch.cuda.device_count()))


def set_env_var(key, val, default_val=""):
    """Set os.environ[key] = val; returns the value before (default_val
    when unset)."""
    prev_val = os.environ.get(key, default_val)
    os.environ[key] = val
    return prev_val


# ---------------------------------------------------------------------------
# statistical checks of samplers
# ---------------------------------------------------------------------------

def gen_buckets_probs_with_ppf(ppf, nbuckets):
    """nbuckets equiprobable (lo, hi) buckets from a quantile function,
    and their probabilities."""
    probs = [1.0 / nbuckets] * nbuckets
    buckets = [(ppf(i / float(nbuckets)), ppf((i + 1) / float(nbuckets)))
               for i in range(nbuckets)]
    return buckets, probs


def mean_check(generator, mu, sigma, nsamples=1000000):
    """The sample mean lies within mu +- 3 sigma / sqrt(nsamples)."""
    samples = np.array(generator(nsamples))
    sample_mean = samples.mean()
    return (mu - 3 * sigma / np.sqrt(nsamples) < sample_mean <
            mu + 3 * sigma / np.sqrt(nsamples))


def var_check(generator, sigma, nsamples=1000000):
    """The sample variance lies within 3 standard deviations of its own
    sampling distribution around sigma^2."""
    samples = np.array(generator(nsamples))
    sample_var = samples.var(ddof=1)
    band = 3 * np.sqrt(2 * sigma ** 4 / (nsamples - 1))
    return sigma ** 2 - band < sample_var < sigma ** 2 + band


def chi_square_check(generator, buckets, probs, nsamples=1000000):
    """Pearson's chi-square test of generator(nsamples) against the
    buckets' probabilities: (lo, hi) buckets for a continuous law, the
    values themselves for a discrete one; samples outside every bucket
    drop out and the expected counts are scaled to the observed total.
    Returns (p, observed, expected)."""
    from scipy import stats as _stats
    if not buckets:
        raise ValueError("buckets must be nonempty")
    expected = np.array(probs) * nsamples
    samples = np.asarray(_to_np(generator(nsamples)))
    if isinstance(buckets[0], (list, tuple)):
        edges = [b[0] for b in buckets] + [buckets[-1][1]]
        obs, _ = np.histogram(samples, bins=np.array(edges))
    else:
        mapping = {v: i for i, v in enumerate(buckets)}
        obs = np.zeros(len(buckets))
        for v, c in zip(*np.unique(samples, return_counts=True)):
            if v in mapping:
                obs[mapping[v]] = c
    if obs.sum() == 0:
        raise AssertionError(
            "chi_square_check: no sample landed in any bucket — the "
            "generator's support does not overlap the bucket range "
            "(sample range [%g, %g])" % (samples.min(), samples.max()))
    expected = expected * (obs.sum() / expected.sum())
    _, p = _stats.chisquare(f_obs=obs, f_exp=expected)
    return p, obs, expected


def verify_generator(generator, buckets, probs, nsamples=1000000,
                     nrepeat=5, success_rate=0.15, alpha=0.05):
    """nrepeat chi-square tests; raise unless the share with p > alpha
    reaches success_rate. Returns the p-values."""
    cs_ret_l = []
    for _ in range(nrepeat):
        p, _, _ = chi_square_check(generator, buckets, probs, nsamples)
        cs_ret_l.append(p)
    success = np.mean(np.array(cs_ret_l) > alpha)
    if success < success_rate:
        raise AssertionError(
            "generator failed chi-square: success rate %.2f < %.2f "
            "(p-values %s)" % (success, success_rate, cs_ret_l))
    return cs_ret_l


# ---------------------------------------------------------------------------
# data fetchers: local files, or the reference's layouts written from
# synthetic data
# ---------------------------------------------------------------------------

def download(url, fname=None, dirname=None, overwrite=False):
    """The path of `url`'s file (named fname, under dirname): an existing
    file is returned as it is; otherwise it is fetched."""
    fname = fname or url.split("/")[-1]
    if dirname is not None:
        os.makedirs(dirname, exist_ok=True)
        fname = os.path.join(dirname, fname)
    if os.path.exists(fname) and not overwrite:
        return fname
    import urllib.request
    urllib.request.urlretrieve(url, fname)
    return fname


def get_mnist_pkl(data_dir="data"):
    """data_dir/mnist.pkl.gz: ((train images, labels), (val), (test)) as
    flat float32 rows, written from the synthetic MNIST when absent."""
    import gzip
    import pickle
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, "mnist.pkl.gz")
    if os.path.exists(path):
        return path
    m = get_mnist()
    flat = m["train_data"].reshape(len(m["train_data"]), -1)
    tflat = m["test_data"].reshape(len(m["test_data"]), -1)
    n_val = len(tflat)
    splits = ((flat, m["train_label"]), (tflat, m["test_label"]),
              (tflat[:n_val], m["test_label"][:n_val]))
    with gzip.open(path, "wb") as f:
        pickle.dump(splits, f)
    return path


def get_mnist_ubyte(data_dir="data"):
    """The four idx-ubyte MNIST files under data_dir, each written from
    the synthetic MNIST when absent; returns data_dir."""
    import struct
    os.makedirs(data_dir, exist_ok=True)
    m = get_mnist()

    def write_images(path, arr):
        arr = (arr * 255).astype(np.uint8).reshape(len(arr), 28, 28)
        with open(path, "wb") as f:
            f.write(struct.pack(">IIII", 2051, len(arr), 28, 28))
            f.write(arr.tobytes())

    def write_labels(path, lab):
        with open(path, "wb") as f:
            f.write(struct.pack(">II", 2049, len(lab)))
            f.write(lab.astype(np.uint8).tobytes())

    names = {"train-images-idx3-ubyte": ("train_data", write_images),
             "train-labels-idx1-ubyte": ("train_label", write_labels),
             "t10k-images-idx3-ubyte": ("test_data", write_images),
             "t10k-labels-idx1-ubyte": ("test_label", write_labels)}
    for name, (key, writer) in names.items():
        path = os.path.join(data_dir, name)
        if not os.path.exists(path):
            writer(path, m[key])
    return data_dir


def get_cifar10(data_dir="data"):
    """data_dir/cifar/{train,test}.rec: RecordIO packs of 500 and 100
    random 32x32 JPEGs (label i % 10, id i), written when absent; returns
    the cifar directory."""
    import io as _pyio
    from PIL import Image
    from . import recordio
    cifar = os.path.join(data_dir, "cifar")
    os.makedirs(cifar, exist_ok=True)
    rng = np.random.RandomState(10)
    for split, n in (("train.rec", 500), ("test.rec", 100)):
        path = os.path.join(cifar, split)
        if os.path.exists(path):
            continue
        w = recordio.MXRecordIO(path, "w")
        for i in range(n):
            img = rng.randint(0, 255, (32, 32, 3)).astype(np.uint8)
            buf = _pyio.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=90)
            w.write(recordio.pack(
                recordio.IRHeader(0, float(i % 10), i, 0), buf.getvalue()))
        w.close()
    return cifar


def get_im2rec_path(home_env="MXNET_HOME"):
    """The port's im2rec tool, mxnet_tpu_torch/tools/im2rec.py (run it as
    `python -m mxnet_tpu_torch.tools.im2rec`)."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "tools", "im2rec.py")
    if os.path.isfile(path):
        return path
    raise IOError("tools/im2rec.py not found under %s" % here)


def get_bz2_data(data_dir, data_name, url, data_origin_name):
    """data_dir/data_name, unpacked from the bzip2 archive
    data_origin_name (`download`ed into data_dir) when absent."""
    import bz2
    os.makedirs(data_dir, exist_ok=True)
    out = os.path.join(data_dir, data_name)
    if os.path.exists(out):
        return out
    archive = download(url, fname=os.path.join(data_dir, data_origin_name))
    with bz2.BZ2File(archive) as fi, open(out, "wb") as fo:
        fo.write(fi.read())
    os.remove(archive)
    return out


def get_zip_data(data_dir, url, data_origin_name):
    """The zip archive data_origin_name (`download`ed into data_dir when
    absent) extracted into data_dir; returns data_dir."""
    import zipfile
    os.makedirs(data_dir, exist_ok=True)
    archive = os.path.join(data_dir, data_origin_name)
    if not os.path.exists(archive):
        download(url, fname=archive)
    with zipfile.ZipFile(archive) as z:
        z.extractall(data_dir)
    return data_dir
