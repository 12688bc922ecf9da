"""Port parity for the ten `linalg_*` ops (and their `_linalg_*`
aliases) against the JAX reference on the CPU.

The reference's semantics, not upstream MXNet's: `potri` takes the
Cholesky factor L and gives inv(L L^T); `gelqf` is the QR of A^T
transposed back, (L, Q); `syevd` gives (V^T, w). Each name is a case of
`test_linalg_parity` (values, dtype, gradient under each package's
autodiff, Symbol shapes); `trsm` runs all eight combinations of
`transpose`, `rightside` and `lower`. The factorizations of `gelqf` and
`syevd` are fixed only up to a sign per row, so they are held by
reconstruction (L Q = A, Q Q^T = I, L lower; A V^T = V^T diag(w)), against
the reference up to row sign, and by gradients of sign-free functions.
Mirrors tests/test_operator.py's test_linalg_gemm_potrf and
test_linalg_syrk_trsm.

Tolerance: 1e-4 relative (and absolute at that scale), values and
gradients.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as ref_registry

import mxnet_tpu_torch as tmx
import torch
from mxnet_tpu_torch.ops import registry as port_registry

from test_torch_tensor_ops import check_case, check_symbol_shapes, \
    check_values

LINALG = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _mat(rs, *shape):
    return rs.uniform(-1, 1, shape).astype(np.float32)


def _spd(rs, b, n):
    m = _mat(rs, b, n, n)
    return (m @ m.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32))


def _lower(rs, b, n):
    """Well-conditioned lower-triangular matrices, positive diagonal."""
    m = np.tril(_mat(rs, b, n, n))
    idx = np.arange(n)
    m[:, idx, idx] = np.abs(m[:, idx, idx]) + 2.0
    return m


CASES = {
    "linalg_gemm": lambda rs: ([_mat(rs, 2, 3, 4), _mat(rs, 2, 5, 4),
                                _mat(rs, 2, 3, 5)],
                               {"transpose_b": True, "alpha": 2.0,
                                "beta": 0.5}),
    "linalg_gemm2": lambda rs: ([_mat(rs, 2, 4, 3), _mat(rs, 2, 4, 5)],
                                {"transpose_a": True, "alpha": -1.5}),
    "linalg_potrf": lambda rs: ([_spd(rs, 2, 4)], {}),
    "linalg_potri": lambda rs: ([_lower(rs, 2, 4)], {}),
    "linalg_trsm": lambda rs: ([_lower(rs, 2, 4), _mat(rs, 2, 4, 3)],
                               {"alpha": 2.0}),
    "linalg_trmm": lambda rs: ([_lower(rs, 2, 4), _mat(rs, 2, 3, 4)],
                               {"rightside": True, "transpose": True,
                                "alpha": 0.5}),
    "linalg_sumlogdiag": lambda rs: ([_spd(rs, 3, 4)], {}),
    "linalg_syrk": lambda rs: ([_mat(rs, 2, 3, 5)], {"transpose": True,
                                                     "alpha": 1.5}),
}
SIGNED = ("linalg_gelqf", "linalg_syevd")
NAMES = sorted(CASES) + list(SIGNED)


def _seed(name):
    return np.random.RandomState(sum(map(ord, name)) % 1000)


@pytest.mark.parametrize("name", sorted(CASES) + sorted(
    "_" + n for n in CASES))
def test_linalg_parity(name):
    op = name.lstrip("_")
    arrays, params = CASES[op](_seed(op))
    check_case(name, arrays, params, LINALG)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rightside", [False, True])
@pytest.mark.parametrize("lower", [False, True])
def test_trsm_cases(transpose, rightside, lower):
    rs = np.random.RandomState(7)
    tri = _lower(rs, 2, 4)
    if not lower:
        tri = tri.transpose(0, 2, 1).copy()
    B = _mat(rs, 2, 3, 4) if rightside else _mat(rs, 2, 4, 3)
    params = dict(transpose=transpose, rightside=rightside, lower=lower,
                  alpha=1.5)
    _, port = check_values("linalg_trsm", [tri, B], params, LINALG)
    a = tri.transpose(0, 2, 1) if transpose else tri
    X = port[0]
    got = X @ a if rightside else a @ X
    np.testing.assert_allclose(got, 1.5 * B, **LINALG)
    check_case("linalg_trsm", [tri, B], params, LINALG)


def _row_signs(ref, port, axis):
    """ref with each row (axis=-2) or column (axis=-1) flipped to port's
    sign."""
    dots = np.sum(ref * port, axis=-1 if axis == -2 else -2, keepdims=True)
    return ref * np.sign(dots)


@pytest.mark.parametrize("name", ["linalg_gelqf", "_linalg_gelqf"])
def test_gelqf(name):
    A = _mat(_seed("gelqf"), 2, 3, 5)
    ref = mx.nd.array(A)
    rL, rQ = [o.asnumpy() for o in getattr(mx.nd, name)(ref)]
    pL, pQ = [o.asnumpy() for o in getattr(tmx.nd, name)(tmx.nd.array(A))]
    assert pL.shape == rL.shape == (2, 3, 3) and pQ.shape == rQ.shape
    assert pL.dtype == rL.dtype == np.float32
    np.testing.assert_allclose(pL @ pQ, A, **LINALG)
    np.testing.assert_allclose(pQ @ pQ.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), (2, 3, 3)),
                               **LINALG)
    np.testing.assert_allclose(np.triu(pL, 1), 0, atol=1e-6)
    np.testing.assert_allclose(pQ, _row_signs(rQ, pQ, -2), **LINALG)
    np.testing.assert_allclose(pL, _row_signs(rL, pL, -1), **LINALG)
    check_symbol_shapes(name, [A], {})
    _sign_free_grads(name, A)


@pytest.mark.parametrize("name", ["linalg_syevd", "_linalg_syevd"])
def test_syevd(name):
    A = _spd(_seed("syevd"), 2, 5)
    rV, rw = [o.asnumpy() for o in getattr(mx.nd, name)(mx.nd.array(A))]
    pV, pw = [o.asnumpy() for o in getattr(tmx.nd, name)(tmx.nd.array(A))]
    assert pV.shape == rV.shape == (2, 5, 5) and pw.shape == rw.shape
    np.testing.assert_allclose(pw, rw, **LINALG)
    # rows of V^T are the eigenvectors: A V^T^T = V^T^T diag(w)
    np.testing.assert_allclose(A @ pV.transpose(0, 2, 1),
                               pV.transpose(0, 2, 1) * pw[:, None, :],
                               **LINALG)
    np.testing.assert_allclose(pV, _row_signs(rV, pV, -2), **LINALG)
    check_symbol_shapes(name, [A], {})
    _sign_free_grads(name, A)


def _sign_free_grads(name, A):
    """Gradients of sum(C1 * X^2) + sum(C2 * Y^2) over the two outputs,
    which a per-row sign does not change."""
    rs = np.random.RandomState(11)
    ref_fn = ref_registry.get(name).fn
    port_fn = port_registry.get(name).fn
    outs = ref_fn(jnp.asarray(A))
    cs = [rs.randn(*o.shape).astype(np.float32) for o in outs]

    def f(a):
        x, y = ref_fn(a)
        return jnp.sum(cs[0] * x ** 2) + jnp.sum(cs[1] * y ** 2)

    rg = np.asarray(jax.grad(f)(jnp.asarray(A)))
    t = torch.tensor(A, requires_grad=True)
    x, y = port_fn(t)
    loss = torch.sum(torch.from_numpy(cs[0]) * x ** 2) \
        + torch.sum(torch.from_numpy(cs[1]) * y ** 2)
    pg, = torch.autograd.grad(loss, t)
    np.testing.assert_allclose(pg.numpy(), rg, **LINALG)


def test_every_linalg_name():
    want = {n for n in ref_registry.OPS if "linalg_" in n}
    assert want == {n for n in NAMES} | {"_" + n for n in NAMES}
    assert want <= set(port_registry.OPS)


@pytest.mark.parametrize("name", NAMES)
def test_linalg_runs_on_meta(name):
    """Each op's torch.linalg call runs on the "meta" device, which Symbol
    shape inference uses."""
    op = port_registry.get(name).fn
    if name in SIGNED:
        arrays, params = [np.zeros((2, 4, 4), np.float32)], {}
    else:
        arrays, params = CASES[name](_seed(name))
    metas = [torch.empty(a.shape, device="meta") for a in arrays]
    out = op(*metas, **params)
    out = out if isinstance(out, tuple) else (out,)
    assert all(o.device.type == "meta" for o in out)
