"""Sparse storage on the port (mxnet_tpu_torch/ops/sparse.py,
ndarray/sparse.py, the optimizers' row-sparse paths, the local store's
row-sparse push / pull, Gluon's row_sparse_data, LibSVMIter and CSR
sources in NDArrayIter, test_utils' sparse helpers, SparseLinear and the
factorization machine) against the JAX reference on the CPU, with the
same numpy inputs from a seed. Mirrors tests/test_sparse.py case by case
and holds each to the reference as well as to numpy.

Tolerances: float32 within 1e-5 (relative, plus 1e-6 absolute for sums
near zero); row ids, column ids and indptr identical; a lazy update's
untouched rows equal bit for bit to the weight before it. Losses over
many steps (the FM's 200) 1e-4 relative: each step's float32 rounding
moves the next one's inputs.
"""
import io
import contextlib
import sys

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu.ndarray import sparse as ref_sp
from mxnet_tpu.ops import registry as ref_registry
import mxnet_tpu.ops.sparse  # noqa: F401  (registers the reference ops)

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ndarray import sparse as port_sp
from mxnet_tpu_torch.ops import registry as port_registry

from chip_smoke import load_example

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref_scope():
    return mx.random.trace_key_scope(jax.random.PRNGKey(0))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _random_dense(rows, cols, density, seed=0):
    rng = np.random.RandomState(seed)
    dense = rng.rand(rows, cols).astype(np.float32)
    dense[rng.rand(rows, cols) >= density] = 0.0
    return dense


def _both_csr(dense):
    return (ref_sp.CSRNDArray.from_dense(mx.nd.NDArray(dense)),
            port_sp.CSRNDArray.from_dense(tmx.nd.array(dense)))


def _same_csr(ref, port):
    np.testing.assert_array_equal(_np(port._indptr), _np(ref._indptr))
    np.testing.assert_array_equal(_np(port._indices), _np(ref._indices))
    np.testing.assert_array_equal(_np(port._values), _np(ref._values))
    assert port.shape == ref.shape


def _same_rsp(ref, port):
    np.testing.assert_array_equal(_np(port._indices), _np(ref._indices))
    assert port._indices.dtype == torch.int32
    np.testing.assert_allclose(_np(port._values), _np(ref._values), **TOL)
    assert port.shape == ref.shape


# ---------------------------------------------------------------------------
# tests/test_sparse.py, case by case
# ---------------------------------------------------------------------------

SHAPES = [(8, 5, 0.3), (64, 100, 0.05), (16, 16, 0.0)]


@pytest.mark.parametrize("rows,cols,density", SHAPES)
def test_csr_dot_dense(rows, cols, density):
    dense = _random_dense(rows, cols, density)
    ref, port = _both_csr(dense)
    _same_csr(ref, port)
    rhs = np.random.RandomState(1).rand(cols, 7).astype(np.float32)
    got = port_sp.dot(port, tmx.nd.array(rhs)).asnumpy()
    want = ref_sp.dot(ref, mx.nd.NDArray(rhs)).asnumpy()
    np.testing.assert_allclose(got, dense @ rhs, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("rows,cols,density", SHAPES)
def test_csr_transpose_dot_dense(rows, cols, density):
    dense = _random_dense(rows, cols, density, seed=2)
    ref, port = _both_csr(dense)
    rhs = np.random.RandomState(3).rand(rows, 4).astype(np.float32)
    out = port_sp.dot(port, tmx.nd.array(rhs), transpose_a=True)
    assert out.shape == (cols, 4)
    want = ref_sp.dot(ref, mx.nd.NDArray(rhs), transpose_a=True).asnumpy()
    np.testing.assert_allclose(out.asnumpy(), dense.T @ rhs, **TOL)
    np.testing.assert_allclose(out.asnumpy(), want, **TOL)


def test_csr_dot_empty_rows_and_duplicate_free():
    data = np.array([[1, 0, 2], [0, 0, 0], [0, 3, 0], [0, 0, 0]], np.float32)
    port = port_sp.csr_matrix(data)
    ref = ref_sp.csr_matrix(data)
    _same_csr(ref, port)
    rhs = np.arange(8, dtype=np.float32).reshape(4, 2)
    out = port_sp.dot(port, tmx.nd.array(rhs), transpose_a=True)
    np.testing.assert_allclose(out.asnumpy(), data.T @ rhs, rtol=1e-6)
    out = port_sp.dot(port, tmx.nd.array(rhs[:3]))
    np.testing.assert_allclose(out.asnumpy(), data @ rhs[:3], rtol=1e-6)


def test_csr_matvec():
    dense = _random_dense(10, 6, 0.4, seed=5)
    ref, port = _both_csr(dense)
    v = np.random.RandomState(6).rand(6).astype(np.float32)
    out = port_sp.dot(port, tmx.nd.array(v))
    assert out.shape == (10,)
    np.testing.assert_allclose(out.asnumpy(), dense @ v, **TOL)
    np.testing.assert_allclose(
        out.asnumpy(), ref_sp.dot(ref, mx.nd.NDArray(v)).asnumpy(), **TOL)
    vt = np.random.RandomState(7).rand(10).astype(np.float32)
    out_t = port_sp.dot(port, tmx.nd.array(vt), transpose_a=True)
    assert out_t.shape == (6,)
    np.testing.assert_allclose(out_t.asnumpy(), dense.T @ vt, **TOL)
    np.testing.assert_allclose(
        out_t.asnumpy(),
        ref_sp.dot(ref, mx.nd.NDArray(vt), transpose_a=True).asnumpy(),
        **TOL)


def test_rowsparse_retain_and_roundtrip():
    dense = np.zeros((6, 3), np.float32)
    dense[1] = 1.0
    dense[4] = 2.0
    port = port_sp.RowSparseNDArray.from_dense(tmx.nd.array(dense))
    ref = ref_sp.RowSparseNDArray.from_dense(mx.nd.NDArray(dense))
    _same_rsp(ref, port)
    kept = port.retain(tmx.nd.array(np.array([1, 2], np.float32)))
    rkept = ref.retain(mx.nd.NDArray(np.array([1, 2], np.float32)))
    out = kept.todense().asnumpy()
    np.testing.assert_array_equal(out[1], dense[1])
    np.testing.assert_array_equal(out[2], 0)
    np.testing.assert_array_equal(out, rkept.todense().asnumpy())
    np.testing.assert_array_equal(port.todense().asnumpy(), dense)
    np.testing.assert_array_equal(port.tostype("default").asnumpy(), dense)


def _dense_spy(monkeypatch):
    """Count every densification of a CSR batch on the port."""
    calls = []
    real = port_registry.get("_csr_to_dense").fn

    def spy(*a, **k):
        calls.append(k.get("num_cols"))
        return real(*a, **k)
    monkeypatch.setattr(port_registry.get("_csr_to_dense"), "fn", spy)
    return calls


def test_sparse_linear_trains_without_densify(monkeypatch):
    from mxnet_tpu.models.sparse_linear import SparseLinear as RefLinear
    rng = np.random.RandomState(0)
    n, d = 64, 50
    dense = rng.rand(n, d).astype(np.float32)
    dense[rng.rand(n, d) >= 0.1] = 0.0
    w_true = rng.randn(d).astype(np.float32)
    y = (dense @ w_true > 0).astype(np.float32)
    calls = _dense_spy(monkeypatch)
    ref_x, x = _both_csr(dense)
    model = tmx.models.SparseLinear(num_features=d, num_classes=2,
                                    learning_rate=1.0)
    losses = [model.step(x, tmx.nd.array(y)) for _ in range(15)]
    with _ref_scope():
        ref_model = RefLinear(num_features=d, num_classes=2,
                              learning_rate=1.0)
        ref_losses = [ref_model.step(ref_x, mx.nd.NDArray(y))
                      for _ in range(15)]
    assert losses[-1] < losses[0] * 0.85, losses[::5]
    np.testing.assert_allclose(losses, ref_losses, **TOL)
    np.testing.assert_allclose(model.weight.asnumpy(),
                               ref_model.weight.asnumpy(), **TOL)
    # the row-sparse gradient touches exactly the features in the batch
    _, wgrad, bgrad = model.loss_grad(x, tmx.nd.array(y))
    with _ref_scope():
        _, ref_wgrad, ref_bgrad = ref_model.loss_grad(ref_x,
                                                      mx.nd.NDArray(y))
    present = np.unique(_np(x._indices))
    np.testing.assert_array_equal(_np(wgrad._indices), present)
    _same_rsp(ref_wgrad, wgrad)
    np.testing.assert_allclose(bgrad.asnumpy(), ref_bgrad.asnumpy(), **TOL)
    assert calls == []


def test_factorization_machine_learns_interactions(monkeypatch):
    """The FM fits an XOR of two features (the interaction term) far
    better than the linear model; its losses follow the reference's."""
    from mxnet_tpu.models.fm import FactorizationMachine as RefFM
    rng = np.random.RandomState(0)
    n, d = 256, 30
    dense = np.zeros((n, d), np.float32)
    fa, fb = 3, 17
    for i in range(n):
        on = rng.choice(d, 4, replace=False)
        dense[i, on] = 1.0
        dense[i, fa] = rng.rand() < 0.5
        dense[i, fb] = rng.rand() < 0.5
    y = ((dense[:, fa] + dense[:, fb]) % 2 == 1).astype(np.float32)
    calls = _dense_spy(monkeypatch)
    ref_x, x = _both_csr(dense)
    ynd = tmx.nd.array(y)
    fm = tmx.models.FactorizationMachine(num_features=d, num_factors=4,
                                         learning_rate=0.5)
    fm_losses = [fm.step(x, ynd) for _ in range(200)]
    with _ref_scope():
        ref_fm = RefFM(num_features=d, num_factors=4, learning_rate=0.5)
        ref_losses = [ref_fm.step(ref_x, mx.nd.NDArray(y))
                      for _ in range(20)]
    np.testing.assert_allclose(fm_losses[:20], ref_losses, rtol=1e-4)
    pred = (fm.predict(x) > 0.5).astype(np.float32)
    fm_acc = float((pred == y).mean())
    assert fm_losses[-1] < fm_losses[0] * 0.5, fm_losses[::50]
    assert fm_acc > 0.9, fm_acc
    lin = tmx.models.SparseLinear(num_features=d, num_classes=2,
                                  learning_rate=0.5)
    for _ in range(200):
        lin.step(x, ynd)
    lin_pred = lin.forward(x).asnumpy().argmax(axis=1).astype(np.float32)
    lin_acc = float((lin_pred == y).mean())
    assert fm_acc > lin_acc + 0.05, (fm_acc, lin_acc)
    assert calls == []


def test_fm_gradients_match_reference():
    from mxnet_tpu.models.fm import FactorizationMachine as RefFM
    dense = _random_dense(32, 40, 0.2, seed=9)
    y = (np.random.RandomState(10).rand(32) > 0.5).astype(np.float32)
    ref_x, x = _both_csr(dense)
    fm = tmx.models.FactorizationMachine(num_features=40, num_factors=8)
    loss, wg, vg, bg = fm.loss_grad(x, tmx.nd.array(y))
    with _ref_scope():
        ref_fm = RefFM(num_features=40, num_factors=8)
        rloss, rwg, rvg, rbg = ref_fm.loss_grad(ref_x, mx.nd.NDArray(y))
    np.testing.assert_allclose(loss, rloss, **TOL)
    _same_rsp(rwg, wg)
    _same_rsp(rvg, vg)
    np.testing.assert_allclose(bg.asnumpy(), rbg.asnumpy(), **TOL)


# ---------------------------------------------------------------------------
# the 6 op names (and the alias)
# ---------------------------------------------------------------------------

def _op_cases():
    rng = np.random.RandomState(20)
    dense = _random_dense(9, 7, 0.35, seed=21)
    ref_csr = ref_sp.CSRNDArray.from_dense(mx.nd.NDArray(dense))
    csr = (np.asarray(ref_csr._indptr), np.asarray(ref_csr._indices),
           np.asarray(ref_csr._values))
    idx = np.array([0, 3, 4, 8], np.int32)
    vals = rng.randn(4, 5).astype(np.float32)
    rhs = rng.randn(7, 3).astype(np.float32)
    rhs_t = rng.randn(9, 3).astype(np.float32)
    return [
        ("_rsp_to_dense", (idx, vals), dict(num_rows=10)),
        ("_dense_to_rsp", (rng.randn(6, 2).astype(np.float32),), {}),
        ("_csr_to_dense", csr, dict(num_rows=9, num_cols=7)),
        ("sparse_retain", (idx, vals, np.array([1, 3, 8, 9], np.int32)), {}),
        ("_sparse_retain", (idx, vals, np.array([0, 2], np.int32)), {}),
        ("_csr_dot_dense", csr + (rhs,), dict(num_rows=9, num_cols=7)),
        ("_csr_dot_dense", csr + (rhs_t,),
         dict(num_rows=9, num_cols=7, transpose_lhs=True)),
        ("_csr_dot_dense", csr + (rhs[:, 0],), dict(num_rows=9, num_cols=7)),
        ("_rsp_dot_dense", (idx, vals, rng.randn(5, 2).astype(np.float32)),
         {}),
    ]


@pytest.mark.parametrize("case", range(9))
def test_sparse_op_names(case):
    name, arrays, params = _op_cases()[case]
    import jax.numpy as jnp
    want = ref_registry.get(name).fn(*[jnp.asarray(a) for a in arrays],
                                     **params)
    got = port_registry.get(name).fn(*[torch.from_numpy(a) for a in arrays],
                                     **params)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = _np(g)
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w)
        else:
            assert g.dtype == w.dtype
            np.testing.assert_allclose(g, w, **TOL)
    assert port_registry.get(name).name == ref_registry.get(name).name


def test_sparse_ops_have_gradients():
    """csr . dense differentiates into the dense operand and the stored
    values, as the reference's op under jax.vjp."""
    import jax.numpy as jnp
    dense = _random_dense(6, 5, 0.5, seed=30)
    ref_csr = ref_sp.CSRNDArray.from_dense(mx.nd.NDArray(dense))
    indptr, indices = np.asarray(ref_csr._indptr), np.asarray(ref_csr._indices)
    vals = np.asarray(ref_csr._values)
    rhs = np.random.RandomState(31).randn(5, 3).astype(np.float32)
    ct = np.random.RandomState(32).randn(6, 3).astype(np.float32)
    fn = ref_registry.get("_csr_dot_dense").fn
    _, vjp = jax.vjp(lambda v, r: fn(jnp.asarray(indptr),
                                     jnp.asarray(indices), v, r,
                                     num_rows=6, num_cols=5),
                     jnp.asarray(vals), jnp.asarray(rhs))
    want_v, want_r = vjp(jnp.asarray(ct))
    tv = torch.from_numpy(vals).requires_grad_()
    tr = torch.from_numpy(rhs).requires_grad_()
    out = port_registry.get("_csr_dot_dense").fn(
        torch.from_numpy(indptr), torch.from_numpy(indices), tv, tr,
        num_rows=6, num_cols=5)
    gv, gr = torch.autograd.grad(out, (tv, tr), torch.from_numpy(ct))
    np.testing.assert_allclose(_np(gv), np.asarray(want_v), **TOL)
    np.testing.assert_allclose(_np(gr), np.asarray(want_r), **TOL)


# ---------------------------------------------------------------------------
# constructors, conversions, arithmetic
# ---------------------------------------------------------------------------

def test_constructors_match_reference():
    vals = np.arange(6, dtype=np.float32).reshape(2, 3) + 1
    port = port_sp.row_sparse_array((vals, [1, 4]), shape=(6, 3))
    ref = ref_sp.row_sparse_array((vals, [1, 4]), shape=(6, 3))
    _same_rsp(ref, port)
    assert port.stype == "row_sparse" and port.dtype == np.float32
    np.testing.assert_array_equal(port.asnumpy(), ref.asnumpy())
    data = np.array([1., 2., 3.], np.float32)
    port_c = port_sp.csr_matrix((data, [0, 2, 1], [0, 2, 2, 3]),
                                shape=(3, 4))
    ref_c = ref_sp.csr_matrix((data, [0, 2, 1], [0, 2, 2, 3]), shape=(3, 4))
    _same_csr(ref_c, port_c)
    np.testing.assert_array_equal(port_c.asnumpy(), ref_c.asnumpy())
    dense = _random_dense(5, 4, 0.5, seed=40)
    _same_rsp(ref_sp.row_sparse_array(dense),
              port_sp.row_sparse_array(dense))
    _same_csr(ref_sp.csr_matrix(dense), port_sp.csr_matrix(dense))
    for stype in ("row_sparse", "csr"):
        for make in (port_sp.zeros, port_sp.empty):
            z = make(stype, (4, 3))
            assert z.stype == stype and z.shape == (4, 3)
            np.testing.assert_array_equal(
                z.asnumpy(), ref_sp.zeros(stype, (4, 3)).asnumpy())
        z = tmx.nd.zeros((4, 3), stype=stype)
        assert z.stype == stype and not z.asnumpy().any()
    assert tmx.nd.zeros((2, 2), stype="default").stype == "default"


def test_tostype_and_cast_storage():
    dense = _random_dense(6, 5, 0.4, seed=41)
    dense[2] = 0
    a = tmx.nd.array(dense)
    r = mx.nd.array(dense)
    assert a.stype == "default" and a.tostype("default") is a
    _same_rsp(r.tostype("row_sparse"), a.tostype("row_sparse"))
    _same_csr(r.tostype("csr"), a.tostype("csr"))
    _same_rsp(mx.nd.cast_storage(r, "row_sparse"),
              tmx.nd.cast_storage(a, "row_sparse"))
    _same_csr(mx.nd.cast_storage(r, stype="csr"),
              tmx.nd.cast_storage(a, stype="csr"))
    for stype in ("row_sparse", "csr"):
        back = tmx.nd.cast_storage(a.tostype(stype), "default")
        np.testing.assert_array_equal(back.asnumpy(), dense)
        assert a.tostype(stype).tostype(stype).stype == stype
    with pytest.raises(ValueError):
        a.tostype("sparse")
    with pytest.raises(ValueError):
        a.tostype("csr").tostype("row_sparse")


def test_csr_slice_copyto_asscipy_and_array():
    import scipy.sparse as sps
    dense = _random_dense(8, 6, 0.4, seed=42)
    ref, port = _both_csr(dense)
    for key in (slice(2, 5), slice(None, 3), slice(6, None),
                slice(-3, -1), slice(4, 4)):
        _same_csr(ref[key] if key.start != 4 else ref[key], port[key])
        np.testing.assert_array_equal(port[key].asnumpy(), dense[key])
    m = port.asscipy()
    assert isinstance(m, sps.csr_matrix)
    np.testing.assert_array_equal(m.toarray(), dense)
    _same_csr(ref_sp.array(sps.csr_matrix(dense)),
              port_sp.array(sps.csr_matrix(dense)))
    _same_csr(ref_sp.array(ref), port_sp.array(port))
    assert port_sp.array(port, dtype="float16").dtype == np.float16
    out = tmx.nd.zeros((8, 6))
    port.copyto(out)
    np.testing.assert_array_equal(out.asnumpy(), dense)
    other = port_sp.zeros("csr", (1, 1))
    port.copyto(other)
    _same_csr(ref, other)
    assert port.copyto(tmx.cpu()).context == tmx.cpu()
    with pytest.raises(TypeError):
        port_sp.array(dense)


def test_rowsparse_copyto_add_and_arithmetic():
    rng = np.random.RandomState(43)
    a = np.zeros((7, 2), np.float32)
    b = np.zeros((7, 2), np.float32)
    a[[1, 3, 5]] = rng.randn(3, 2)
    b[[0, 3, 6]] = rng.randn(3, 2)
    pa, pb = (port_sp.RowSparseNDArray.from_dense(tmx.nd.array(v))
              for v in (a, b))
    ra, rb = (ref_sp.RowSparseNDArray.from_dense(mx.nd.NDArray(v))
              for v in (a, b))
    _same_rsp(ra + rb, pa + pb)
    np.testing.assert_allclose((pa + tmx.nd.ones((7, 2))).asnumpy(),
                               a + 1, **TOL)
    for fn in ("add", "elemwise_add", "subtract", "multiply", "divide"):
        got = getattr(port_sp, fn)(pa, pb)
        want = getattr(ref_sp, fn)(ra, rb)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL,
                                   equal_nan=True)
    for fn in ("multiply", "divide"):
        got = getattr(port_sp, fn)(pa, 3.0)
        want = getattr(ref_sp, fn)(ra, 3.0)
        assert got.stype == "row_sparse"
        _same_rsp(want, got)
    _same_rsp(ref_sp.retain(ra, mx.nd.NDArray(np.array([3, 4], np.int32))),
              port_sp.retain(pa, tmx.nd.array(np.array([3, 4], np.int32))))
    dst = port_sp.zeros("row_sparse", (7, 2))
    pa.copyto(dst)
    _same_rsp(ra, dst)
    out = tmx.nd.zeros((7, 2))
    pa.copyto(out)
    np.testing.assert_array_equal(out.asnumpy(), a)


def test_merge_rowsparse_matches_reference():
    rng = np.random.RandomState(44)
    parts = []
    for k in range(4):
        ids = np.sort(rng.choice(50, 12, replace=False)).astype(np.int32)
        parts.append((ids, rng.randn(12, 3).astype(np.float32)))
    port = port_sp.merge_rowsparse([port_sp.RowSparseNDArray(i, v, (50, 3))
                                    for i, v in parts])
    ref = ref_sp.merge_rowsparse([ref_sp.RowSparseNDArray(i, v, (50, 3))
                                  for i, v in parts])
    _same_rsp(ref, port)
    assert np.all(np.diff(_np(port._indices)) > 0)
    want = np.zeros((50, 3), np.float32)
    for i, v in parts:
        want[i] += v
    np.testing.assert_allclose(port.asnumpy(), want, **TOL)
    # touched_rows: the nonzero stored values' columns only
    csr = port_sp.csr_matrix((np.array([1., 0., 2.], np.float32),
                              [4, 1, 4], [0, 2, 3]), shape=(2, 6))
    rcsr = ref_sp.csr_matrix((np.array([1., 0., 2.], np.float32),
                              [4, 1, 4], [0, 2, 3]), shape=(2, 6))
    np.testing.assert_array_equal(_np(port_sp.touched_rows(csr)),
                                  ref_sp.touched_rows(rcsr))


# ---------------------------------------------------------------------------
# optimizers on row-sparse gradients
# ---------------------------------------------------------------------------

def _rsp_grad(rng, shape, rows):
    vals = rng.randn(len(rows), shape[1]).astype(np.float32)
    ids = np.asarray(rows, np.int32)
    return (port_sp.RowSparseNDArray(ids, vals, shape),
            ref_sp.RowSparseNDArray(ids, vals, shape))


@pytest.mark.parametrize("name,params", [
    ("sgd", dict(learning_rate=0.1, momentum=0.0, wd=0.01)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("adam", dict(learning_rate=0.01, wd=0.01, rescale_grad=0.5)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, clip_gradient=0.5)),
])
def test_lazy_update_matches_reference(name, params):
    rng = np.random.RandomState(50)
    shape = (20, 4)
    w0 = rng.randn(*shape).astype(np.float32)
    pw, rw = tmx.nd.array(w0), mx.nd.array(w0)
    pu = tmx.optimizer.get_updater(tmx.optimizer.create(name, **params))
    ru = mx.optimizer.get_updater(mx.optimizer.create(name, **params))
    touched = set()
    for rows in ([1, 5, 7], [0, 5, 19], [2, 3, 5, 11]):
        pg, rg = _rsp_grad(rng, shape, rows)
        before = pw.asnumpy()
        pu(0, pg, pw)
        with _ref_scope():
            ru(0, rg, rw)
        touched |= set(rows)
        after = pw.asnumpy()
        untouched = [i for i in range(shape[0]) if i not in rows]
        np.testing.assert_array_equal(after[untouched], before[untouched])
        np.testing.assert_allclose(after, np.asarray(rw._data), **TOL)
    for ps, rs in zip(_flat_states(pu.states[0]), _flat_states(ru.states[0])):
        np.testing.assert_allclose(ps.asnumpy(), np.asarray(rs._data), **TOL)
    never = [i for i in range(shape[0]) if i not in touched]
    np.testing.assert_array_equal(pw.asnumpy()[never], w0[never])


def _flat_states(st):
    if st is None:
        return []
    return list(st) if isinstance(st, (tuple, list)) else [st]


@pytest.mark.parametrize("name", ["rmsprop", "adagrad", "ftrl"])
def test_densifying_optimizer_on_row_sparse_gradient(name):
    """An optimizer without a lazy path densifies the gradient and takes
    its dense rule, as the reference's `_dense_update` does."""
    rng = np.random.RandomState(51)
    shape = (12, 3)
    w0 = rng.randn(*shape).astype(np.float32)
    pw, rw = tmx.nd.array(w0), mx.nd.array(w0)
    pu = tmx.optimizer.get_updater(tmx.optimizer.create(name))
    ru = mx.optimizer.get_updater(mx.optimizer.create(name))
    for rows in ([1, 4], [4, 9, 11]):
        pg, rg = _rsp_grad(rng, shape, rows)
        pu(0, pg, pw)
        with _ref_scope():
            ru(0, rg, rw)
        np.testing.assert_allclose(pw.asnumpy(), np.asarray(rw._data), **TOL)


def test_lazy_update_false_densifies():
    rng = np.random.RandomState(52)
    w0 = rng.randn(6, 2).astype(np.float32)
    pg, rg = _rsp_grad(rng, (6, 2), [2, 3])
    pw, rw = tmx.nd.array(w0), mx.nd.array(w0)
    opt = dict(learning_rate=0.1, momentum=0.9, wd=0.1, lazy_update=False)
    tmx.optimizer.get_updater(tmx.optimizer.create("sgd", **opt))(0, pg, pw)
    with _ref_scope():
        mx.optimizer.get_updater(mx.optimizer.create("sgd", **opt))(0, rg, rw)
    np.testing.assert_allclose(pw.asnumpy(), np.asarray(rw._data), **TOL)
    # wd decays the untouched rows too
    assert not np.array_equal(pw.asnumpy()[0], w0[0])


# ---------------------------------------------------------------------------
# the local store, Gluon
# ---------------------------------------------------------------------------

def test_local_store_row_sparse_push_pull():
    rng = np.random.RandomState(60)
    shape = (10, 3)
    w0 = rng.randn(*shape).astype(np.float32)
    grads = [_rsp_grad(rng, shape, rows)
             for rows in ([1, 2], [2, 7], [0, 9])]
    for with_opt in (False, True):
        pkv, rkv = tmx.kv.create("local"), mx.kv.create("local")
        pkv.init("w", tmx.nd.array(w0))
        rkv.init("w", mx.nd.array(w0))
        if with_opt:
            pkv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1))
            rkv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1))
        with _ref_scope():
            pkv.push("w", [g[0] for g in grads[:2]])
            rkv.push("w", [g[1] for g in grads[:2]])
            pkv.push("w", grads[2][0])
            rkv.push("w", grads[2][1])
        pout, rout = tmx.nd.zeros(shape), mx.nd.zeros(shape)
        pkv.pull("w", out=pout)
        rkv.pull("w", out=rout)
        np.testing.assert_allclose(pout.asnumpy(), rout.asnumpy(), **TOL)
        rid = np.array([9, 2, 4], np.int32)
        prsp = port_sp.zeros("row_sparse", shape)
        rrsp = ref_sp.zeros("row_sparse", shape)
        pkv.row_sparse_pull("w", out=prsp, row_ids=tmx.nd.array(rid))
        rkv.row_sparse_pull("w", out=rrsp, row_ids=mx.nd.array(rid))
        _same_rsp(rrsp, prsp)
        np.testing.assert_allclose(prsp.asnumpy()[rid], pout.asnumpy()[rid],
                                   **TOL)
        dense_out = tmx.nd.zeros(shape)
        pkv.row_sparse_pull("w", out=dense_out, row_ids=tmx.nd.array(rid))
        np.testing.assert_allclose(dense_out.asnumpy(), prsp.asnumpy())
        got = pkv.row_sparse_pull("w", row_ids=tmx.nd.array(rid))
        _same_rsp(rrsp, got)
    # a row-sparse key merges pushes without densifying
    pkv, rkv = tmx.kv.create("local"), mx.kv.create("local")
    pkv.init("e", grads[0][0])
    rkv.init("e", grads[0][1])
    pkv.push("e", grads[1][0])
    rkv.push("e", grads[1][1])
    _same_rsp(rkv._store["e"], pkv._store["e"])
    with pytest.raises(tmx.base.MXNetError):
        pkv.row_sparse_pull("e", out=prsp)


def test_gluon_row_sparse_data_and_trainer_pull():
    rng = np.random.RandomState(61)
    w0 = rng.randn(8, 3).astype(np.float32)
    w0[5] = 0
    rid = np.array([0, 5, 7], np.float32)
    results = []
    for pkg, sp in ((tmx, port_sp), (mx, ref_sp)):
        p = pkg.gluon.Parameter("emb", shape=(8, 3), stype="row_sparse",
                                grad_stype="row_sparse")
        p.initialize(ctx=pkg.cpu())
        p.set_data(pkg.nd.array(w0))
        rows = p.row_sparse_data(pkg.nd.array(rid))
        tr = pkg.gluon.Trainer([p], "sgd", {"learning_rate": 0.1},
                               kvstore="local")
        out = sp.zeros("row_sparse", (8, 3))
        with _ref_scope():
            tr._row_sparse_pull(p, out, pkg.nd.array(rid))
        results.append((rows, out))
    (prow, pout), (rrow, rout) = results
    _same_rsp(rrow, prow)
    _same_rsp(rout, pout)
    np.testing.assert_array_equal(prow.asnumpy()[[0, 7]], w0[[0, 7]])


# ---------------------------------------------------------------------------
# data: CSR sources, LibSVMIter, the sparse test helpers
# ---------------------------------------------------------------------------

def _batches(it):
    it.reset()
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_csr_source(handle):
    """A CSR source batches densified rows with "discard"; "pad" and
    "roll_over" raise, in both packages."""
    dense = _random_dense(11, 9, 0.3, seed=70)
    label = np.arange(11, dtype=np.float32)
    ref, port = _both_csr(dense)
    if handle != "discard":
        for pkg, src in ((tmx, port), (mx, ref)):
            with pytest.raises(NotImplementedError, match="discard"):
                pkg.io.NDArrayIter(src, label, batch_size=4,
                                   last_batch_handle=handle)
        return
    np.random.seed(75)
    pit = tmx.io.NDArrayIter(port, label, batch_size=4, shuffle=True,
                             last_batch_handle=handle)
    np.random.seed(75)
    rit = mx.io.NDArrayIter(ref, label, batch_size=4, shuffle=True,
                            last_batch_handle=handle)
    assert pit.provide_data[0].shape == rit.provide_data[0].shape
    for epoch in range(2):
        np.random.seed(76 + epoch)
        got = _batches(pit)
        np.random.seed(76 + epoch)
        want = _batches(rit)
        assert len(got) == len(want)
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
            assert gp == wp


def test_libsvm_iter_parts(tmp_path):
    rng = np.random.RandomState(71)
    path = tmp_path / "data.libsvm"
    lines = []
    for i in range(23):
        cols = np.sort(rng.choice(30, rng.randint(1, 6), replace=False))
        feats = " ".join("%d:%.4f" % (c, rng.rand()) for c in cols)
        lines.append("%d %s" % (i % 2, feats))
    path.write_text("\n".join(lines) + "\n")
    for part in (0, 1):
        kw = dict(data_libsvm=str(path), data_shape=(30,), batch_size=4,
                  num_parts=2, part_index=part)
        pit, rit = tmx.io.LibSVMIter(**kw), mx.io.LibSVMIter(**kw)
        assert [tuple(d.shape) for d in pit.provide_data] == \
            [tuple(d.shape) for d in rit.provide_data]
        got, want = _batches(pit), _batches(rit)
        assert len(got) == len(want) == (12 - part) // 4
        for (gd, gl, _), (wd, wl, _) in zip(got, want):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("stype", ["row_sparse", "csr", "default"])
def test_sparse_test_utils_match_reference(stype):
    """The same seed gives the same arrays in both packages. The
    reference's `create_sparse_array(data_init=...)` writes into a
    read-only view of its array and raises, so that option is held to
    its own definition on the port: the same structure as without it,
    every stored value data_init."""
    from mxnet_tpu import test_utils as ref_tu
    from mxnet_tpu_torch import test_utils as port_tu
    shape = (9, 6)
    outs = []
    for tu in (port_tu, ref_tu):
        np.random.seed(72)
        a = tu.rand_ndarray(shape, stype, density=0.4)
        b, ids = tu.rand_sparse_ndarray(shape, stype, density=0.6)
        got = [a.asnumpy(), b.asnumpy(), None if ids is None else _np(ids)]
        if stype != "default":
            got.append(tu.create_sparse_array(
                shape, stype, modifier_func=lambda v: 2 * v).asnumpy())
            got.append(tu.create_sparse_array_zd(shape, stype,
                                                 density=0).asnumpy())
        outs.append(got)
    for g, w in zip(*outs):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    if stype == "default":
        return
    np.random.seed(77)
    plain = port_tu.create_sparse_array(shape, stype).asnumpy()
    np.random.seed(77)
    init = port_tu.create_sparse_array(shape, stype, data_init=2.0)
    assert init.stype == stype
    np.testing.assert_array_equal(init.asnumpy(),
                                  np.where(plain != 0, 2.0, 0.0))
    if stype == "row_sparse":
        got = []
        for tu in (port_tu, ref_tu):
            np.random.seed(73)
            r = tu.create_sparse_array(shape, stype, rsp_indices=[5, 1])
            np.testing.assert_array_equal(_np(r._indices), [1, 5])
            got.append(r.asnumpy())
        np.testing.assert_array_equal(got[0], got[1])
    else:
        got = []
        for tu in (port_tu, ref_tu):
            np.random.seed(74)
            r = tu.create_sparse_array(shape, stype, density=0.7,
                                       shuffle_csr_indices=True)
            got.append((_np(r._indices), r.asnumpy()))
        np.testing.assert_array_equal(got[0][0], got[1][0])
        np.testing.assert_array_equal(got[0][1], got[1][1])


# ---------------------------------------------------------------------------
# examples/sparse_linear_classification.py in both packages
# ---------------------------------------------------------------------------

def test_sparse_linear_example_prints_the_reference_figures():
    printed = []
    for pkg in (tmx, mx):
        module = load_example("sparse_linear_classification.py", pkg)
        assert module.mx.models.SparseLinear is pkg.models.SparseLinear
        argv = sys.argv
        sys.argv = ["sparse_linear_classification.py", "--num-batches",
                    "25"]
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf), _ref_scope():
                module.main()
        finally:
            sys.argv = argv
        printed.append(buf.getvalue())
    assert printed[0] == printed[1], printed
    assert "accuracy (last 10 batches)" in printed[0]
