"""The optimizer update ops (mxnet_tpu_torch/ops/optimizer_ops.py and their
`nd.*_update` wrappers) against the JAX reference's registered ops on the
CPU.

Every op name and the `adagrad_update` alias: the same numpy weight,
gradient and states through `mx.nd.<op>` of both packages, with clipping,
rescale and weight decay active, three calls in a row with the states
written in place and the weight passed back through `out=`. float32,
within 1e-6 relative (atol 1e-7): the same ops in the same order. One
exception: ftrl_update's weight, -(z - sign(z) lamda1) / (...), cancels
where |z| is near lamda1, so a one-ulp difference in z (XLA may divide
by the constant lr as a multiply) shows there: atol 1e-6 (the weights
are O(1)).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as ref_registry

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ndarray import NDArray
from mxnet_tpu_torch.ops import optimizer_ops
from mxnet_tpu_torch.ops import registry as port_registry

_RTOL, _ATOL = 1e-6, 1e-7
_FTRL_ATOL = 1e-6

#: op name -> (number of state arguments, keyword arguments)
CASES = {
    "sgd_update": (0, dict(lr=0.1, wd=0.01, rescale_grad=0.5,
                           clip_gradient=0.3)),
    "sgd_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01,
                               rescale_grad=0.5, clip_gradient=0.3)),
    "mp_sgd_update": (1, dict(lr=0.1, wd=0.01, clip_gradient=0.3)),
    "mp_sgd_mom_update": (2, dict(lr=0.1, momentum=0.9, wd=0.01,
                                  clip_gradient=0.3)),
    "signsgd_update": (0, dict(lr=0.05, wd=0.01, clip_gradient=0.3)),
    "signum_update": (1, dict(lr=0.05, momentum=0.9, wd=0.01, wd_lh=1e-3,
                              clip_gradient=0.3)),
    "adam_update": (2, dict(lr=0.01, wd=0.01, rescale_grad=2.0,
                            clip_gradient=0.3)),
    "rmsprop_update": (1, dict(lr=0.01, wd=0.01, clip_gradient=0.3,
                               clip_weights=0.8)),
    "rmspropalex_update": (3, dict(lr=0.01, wd=0.01, clip_gradient=0.3,
                                   clip_weights=0.8)),
    "ftml_update": (3, dict(lr=0.02, wd=0.01, t=2, clip_grad=0.3)),
    "ftrl_update": (2, dict(lr=0.1, lamda1=0.05, wd=0.01,
                            clip_gradient=0.3)),
    "_sparse_adagrad_update": (1, dict(lr=0.1, wd=0.01,
                                       clip_gradient=0.3)),
    "adagrad_update": (1, dict(lr=0.1, wd=0.01, clip_gradient=0.3)),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _inputs(name, nstates, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.uniform(-1, 1, (6, 5)).astype(np.float32)
    grads = [rng.uniform(-1, 1, (6, 5)).astype(np.float32)
             for _ in range(3)]
    states = [np.abs(rng.uniform(0, 0.5, (6, 5))).astype(np.float32)
              for _ in range(nstates)]
    if name.startswith("mp_"):
        states[-1] = w.copy()  # the float32 master
    if name == "ftml_update":
        states[0] = np.abs(states[0]) + 1.0  # d
    return w, grads, states


def _run(pkg, name, nstates, kwargs):
    w, grads, states = _inputs(name, nstates)
    wn = pkg.nd.array(w)
    sn = [pkg.nd.array(s) for s in states]
    fn = getattr(pkg.nd, name)
    for g in grads:
        out = fn(wn, pkg.nd.array(g), *sn, out=wn, **kwargs)
        assert out is wn
    return [wn.asnumpy()] + [s.asnumpy() for s in sn]


def test_the_port_registers_every_update_op_name():
    names = set(CASES)
    assert names <= set(port_registry.OPS)
    assert names <= set(ref_registry.OPS)
    assert set(optimizer_ops.UPDATE_OP_STATES) == names
    assert port_registry.OPS["adagrad_update"] is \
        port_registry.OPS["_sparse_adagrad_update"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_update_op_matches_reference(name):
    nstates, kwargs = CASES[name]
    got = _run(tmx, name, nstates, kwargs)
    want = _run(mx, name, nstates, kwargs)
    assert len(got) == len(want)
    atol = _FTRL_ATOL if name == "ftrl_update" else _ATOL
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=_RTOL, atol=atol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_states_are_written_in_place_and_out_optional(name):
    """Without `out=` the new weight is returned and the weight argument
    keeps its value; the states change in place either way."""
    nstates, kwargs = CASES[name]
    w, grads, states = _inputs(name, nstates, seed=1)
    wn = tmx.nd.array(w)
    sn = [tmx.nd.array(s) for s in states]
    new = getattr(tmx.nd, name)(wn, tmx.nd.array(grads[0]), *sn, **kwargs)
    assert isinstance(new, NDArray) and new is not wn
    np.testing.assert_array_equal(wn.asnumpy(), w)
    ref_w = mx.nd.array(w)
    ref_s = [mx.nd.array(s) for s in states]
    ref_new = getattr(mx.nd, name)(ref_w, mx.nd.array(grads[0]), *ref_s,
                                   **kwargs)
    np.testing.assert_allclose(new.asnumpy(), ref_new.asnumpy(),
                               rtol=_RTOL, atol=_ATOL)
    for a, b, s0 in zip(sn, ref_s, states):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=_RTOL,
                                   atol=_ATOL)
        if name != "mp_sgd_update" or s0 is not states[-1]:
            assert not np.array_equal(a.asnumpy(), s0)


def test_the_two_preambles_differ_under_clipping():
    """sgd_mom_update clips, then adds wd * w; adam_update adds wd * w,
    then clips. With the clip active the two orders give different
    gradients, each equal to its own preamble and to the reference."""
    w = np.array([2.0, -2.0, 0.5], np.float32)
    g = np.array([1.0, -1.0, 0.05], np.float32)
    wd, clip = 0.5, 0.3
    sgd_g = np.clip(g, -clip, clip) + wd * w
    adam_g = np.clip(g + wd * w, -clip, clip)
    assert not np.allclose(sgd_g, adam_g)
    for pkg in (tmx, mx):
        mom = pkg.nd.zeros((3,))
        pkg.nd.sgd_mom_update(pkg.nd.array(w), pkg.nd.array(g), mom, lr=1.0,
                              momentum=0.0, wd=wd, clip_gradient=clip)
        np.testing.assert_allclose(mom.asnumpy(), -sgd_g, rtol=1e-6)
        mean, var = pkg.nd.zeros((3,)), pkg.nd.zeros((3,))
        pkg.nd.adam_update(pkg.nd.array(w), pkg.nd.array(g), mean, var,
                           lr=0.1, beta1=0.0, beta2=0.0, wd=wd,
                           clip_gradient=clip)
        np.testing.assert_allclose(mean.asnumpy(), adam_g, rtol=1e-6)


def test_sym_update_ops_bind_and_run():
    """The sym.* entries: a graph of sgd_mom_update evaluates to the nd
    op's new weight and momentum."""
    w = np.array([1.0, 2.0], np.float32)
    g = np.array([0.5, -0.5], np.float32)
    s = tmx.sym.sgd_mom_update(tmx.sym.Variable("w"), tmx.sym.Variable("g"),
                               tmx.sym.Variable("m"), lr=0.1, momentum=0.9)
    assert len(s.list_outputs()) == 2
    ex = s.bind(tmx.cpu(), {"w": tmx.nd.array(w), "g": tmx.nd.array(g),
                            "m": tmx.nd.zeros((2,))})
    new_w, new_m = [o.asnumpy() for o in ex.forward()]
    np.testing.assert_allclose(new_m, -0.1 * g, rtol=1e-6)
    np.testing.assert_allclose(new_w, w - 0.1 * g, rtol=1e-6)


@pytest.mark.parametrize("name", ["sgd_update", "adam_update",
                                  "_sparse_adagrad_update"])
def test_row_sparse_input_raises_naming_slice_6(name):
    """A row_sparse gradient through the update op: the reference's op
    multiplies the sparse object by a float and raises TypeError, and the
    port's wrapper raises TypeError too, leaving the weight and the
    states as they were. (Row-sparse gradients update through the
    optimizer classes; the name is kept from before sparse arrays.)"""
    from mxnet_tpu.ndarray import sparse as ref_sp
    from mxnet_tpu_torch.ndarray import sparse as port_sp
    nstates, kwargs = CASES[name]
    w, grads, states = _inputs(name, nstates)
    for pkg, sp in ((tmx, port_sp), (mx, ref_sp)):
        wn = pkg.nd.array(w)
        sn = [pkg.nd.array(st) for st in states]
        g = sp.RowSparseNDArray.from_dense(pkg.nd.array(grads[0]))
        with pytest.raises(TypeError):
            getattr(pkg.nd, name)(wn, g, *sn, out=wn, **kwargs)
        np.testing.assert_array_equal(wn.asnumpy(), w)
        for a, b in zip(sn, states):
            np.testing.assert_array_equal(a.asnumpy(), b)
