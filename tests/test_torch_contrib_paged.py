"""Port parity for `_contrib_PagedAttention` (alias `PagedAttention`)
and `_contrib_div_sqrt_dim` against the JAX reference on the CPU.

`_contrib_PagedAttention` keeps the reference's switch: with
MXNET_PAGED_ATTENTION=1 it calls `ops.paged_attention.paged_attention`
(on the card the paged kernel K1; on the CPU its plain version), with the
flag off it composes the gather by table and the masked float32 softmax.
The flag switches the implementation, never the function: both agree
with each other and with the reference's op under each flag (its Pallas
kernel in interpret mode with the flag on), through `nd.contrib`, the
registry name, the alias and a bound `sym.contrib.PagedAttention`. On the
CPU no kernel launch is counted. Mirrors tests/test_pallas_paged.py::
test_contrib_paged_attention_op_flag_equivalence.

Tolerance: 1e-5 (float32 softmax over the same scores).
"""
import numpy as np
import pytest

import jax.numpy as jnp

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
import torch
from mxnet_tpu_torch.ops import paged_attention as pa

from test_torch_tensor_ops import TRANS, check_case

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _inputs(Tq, seed=3, nb=6, bs=4, H=2, Dh=8):
    rng = np.random.RandomState(seed)
    kp = rng.randn(nb, bs, H, Dh).astype(np.float32)
    vp = rng.randn(nb, bs, H, Dh).astype(np.float32)
    q = rng.randn(2, Tq, H, Dh).astype(np.float32)
    tab = np.array([[3, 5], [1, 0]], np.int32)
    qs = np.array([8 - Tq, 0], np.int32)
    return [q, kp, vp, tab, qs], bs


def _ref(arrays, bs, flag, monkeypatch, name="PagedAttention"):
    monkeypatch.setenv("MXNET_PAGED_ATTENTION", flag)
    nds = [mx.nd.NDArray(jnp.asarray(a)) for a in arrays]
    fn = getattr(mx.nd.contrib, name) if name == "PagedAttention" \
        else getattr(mx.nd, name)
    return fn(*nds, block_size=bs).asnumpy()


def _port(arrays, bs, flag, monkeypatch, name="PagedAttention"):
    monkeypatch.setenv("MXNET_PAGED_ATTENTION", flag)
    nds = [tmx.nd.array(a, dtype=a.dtype) for a in arrays]
    fn = getattr(tmx.nd.contrib, name) if name == "PagedAttention" \
        else getattr(tmx.nd, name)
    return fn(*nds, block_size=bs).asnumpy()


@pytest.mark.parametrize("name", ["PagedAttention", "_contrib_PagedAttention"])
@pytest.mark.parametrize("Tq", [1, 3])
@pytest.mark.parametrize("flag", ["0", "1"])
def test_paged_attention_op_matches_reference(monkeypatch, flag, Tq, name):
    arrays, bs = _inputs(Tq)
    before = pa.paged_attention.launches
    port = _port(arrays, bs, flag, monkeypatch, name)
    ref = _ref(arrays, bs, flag, monkeypatch, name)
    assert port.shape == ref.shape == (2, Tq, 2, 8)
    assert port.dtype == ref.dtype
    np.testing.assert_allclose(port, ref, **TOL)
    assert pa.paged_attention.launches == before  # the CPU launches none


def test_paged_attention_flag_equivalence(monkeypatch):
    arrays, bs = _inputs(3, seed=5)
    off = _port(arrays, bs, "0", monkeypatch)
    on = _port(arrays, bs, "1", monkeypatch)
    np.testing.assert_allclose(on, off, **TOL)


def test_paged_attention_takes_float_tables(monkeypatch):
    """Tables and starts arrive as float32 from a Symbol's variables: the
    op makes them int32 for the kernel's entry."""
    arrays, bs = _inputs(3, seed=6)
    want = _port(arrays, bs, "1", monkeypatch)
    arrays[3] = arrays[3].astype(np.float32)
    arrays[4] = arrays[4].astype(np.float32)
    got = _port(arrays, bs, "1", monkeypatch)
    np.testing.assert_array_equal(got, want)


def test_paged_attention_bfloat16(monkeypatch):
    arrays, bs = _inputs(1, seed=7)
    ts = [torch.from_numpy(a) for a in arrays]
    ts[:3] = [t.to(torch.bfloat16) for t in ts[:3]]
    outs = []
    for flag in ("0", "1"):
        monkeypatch.setenv("MXNET_PAGED_ATTENTION", flag)
        outs.append(tmx.nd.contrib.PagedAttention(
            *[tmx.nd.NDArray(t) for t in ts], block_size=bs))
    assert outs[0].dtype == "bfloat16"
    np.testing.assert_allclose(outs[1].asnumpy(), outs[0].asnumpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("flag", ["0", "1"])
def test_sym_contrib_paged_attention_bound(monkeypatch, flag):
    """sym.contrib.PagedAttention: the reference's inferred shape, and a
    bound executor's output equal to the imperative op's."""
    monkeypatch.setenv("MXNET_PAGED_ATTENTION", flag)
    arrays, bs = _inputs(3, seed=8)
    names = ["query", "k_pool", "v_pool", "block_table", "q_start"]
    shapes = {n: a.shape for n, a in zip(names, arrays)}
    dtypes = [str(a.dtype) for a in arrays]
    with tmx.name.NameManager():
        s = tmx.sym.contrib.PagedAttention(
            *[tmx.sym.Variable(n, dtype=d) for n, d in zip(names, dtypes)],
            block_size=bs)
    with mx.name.NameManager():
        r = mx.sym.contrib.PagedAttention(
            *[mx.sym.Variable(n, dtype=d) for n, d in zip(names, dtypes)],
            block_size=bs)
    assert s.infer_shape(**shapes)[1] == r.infer_shape(**shapes)[1]
    ex = s.bind(tmx.cpu(), {n: tmx.nd.array(a, dtype=a.dtype)
                            for n, a in zip(names, arrays)}, grad_req="null")
    out = ex.forward()[0].asnumpy()
    want = _port(arrays, bs, flag, monkeypatch)
    np.testing.assert_allclose(out, want, **TOL)


def test_div_sqrt_dim():
    x = np.random.RandomState(0).randn(2, 3, 16).astype(np.float32)
    check_case("_contrib_div_sqrt_dim", [x], {}, TRANS)
    got = tmx.nd.contrib.div_sqrt_dim(tmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, x / 4.0, **TOL)


def test_div_sqrt_dim_bfloat16_root():
    """The root is taken in the data's dtype, as the reference's."""
    x = torch.ones(2, 128, dtype=torch.bfloat16)
    got = tmx.nd.contrib.div_sqrt_dim(tmx.nd.NDArray(x))._data
    want = x / torch.sqrt(torch.tensor(128.0, dtype=torch.bfloat16))
    assert torch.equal(got, want)
