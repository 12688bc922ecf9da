"""Port parity for the torch plugin (`mxnet_tpu_torch.plugin.TorchBlock`)
against the JAX package's on the CPU: the eight cases of
tests/test_plugin_torch.py, each run on two copies of one torch module,
one wrapped by each package, with the same numpy inputs; plus what the
port's design adds: the Gluon Parameters are the module's own tensors (no
host copy), and the module lives on the block's context.

Tolerances: forward outputs within rtol 1e-6 (the same torch module runs
in both; the reference copies its values through float32 numpy and back,
which is exact); gradients and trained losses within rtol 1e-5 / atol
1e-6 (the reference's gradient reaches its optimizer through jax, whose
float32 update rounds as torch's does, but sums the SGD step in another
order).
"""
import copy
import os

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import random as ref_random
from mxnet_tpu.plugin import TorchBlock as RefTorchBlock

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.plugin import TorchBlock

_GRAD = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu(), ref_random.trace_key_scope(jax.random.PRNGKey(0)):
        yield


def _pair(module):
    """(reference block, port block) over two copies of `module`."""
    return RefTorchBlock(copy.deepcopy(module)), TorchBlock(module)


def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 2))


def _data(seed, *shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _both(fn):
    """fn(package) for the reference and the port."""
    return fn(mx), fn(tmx)


def test_torch_block_forward_parity():
    ref, port = _pair(_mlp())
    x = _data(0, 6, 4)
    np.testing.assert_allclose(port(tmx.nd.array(x)).asnumpy(),
                               ref(mx.nd.array(x)).asnumpy(), rtol=1e-6)


def test_torch_block_grad_matches_reference():
    blocks = dict(zip((mx, tmx), _pair(_mlp())))
    x, y = _data(1, 6, 4), _data(2, 6, 2)

    def grads(pkg):
        xa = pkg.nd.array(x)
        xa.attach_grad()
        with pkg.autograd.record():
            L = pkg.nd.mean(pkg.nd.square(blocks[pkg](xa) -
                                          pkg.nd.array(y)))
        L.backward()
        return [xa.grad.asnumpy()] + [
            p.grad().asnumpy()
            for p in blocks[pkg].collect_params().values()]

    for got, want in zip(*reversed(_both(grads))):
        np.testing.assert_allclose(got, want, **_GRAD)


def _train(pkg, block, x, y, steps, lr, head=None):
    params = pkg.gluon.ParameterDict()
    params.update(block.collect_params())
    if head is not None:
        params.update(head.collect_params())
    tr = pkg.gluon.Trainer(params, "sgd", {"learning_rate": lr})
    net = (lambda a: head(block(a))) if head is not None else block
    xa, ya = pkg.nd.array(x), pkg.nd.array(y)
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            L = pkg.nd.mean(pkg.nd.square(net(xa) - ya))
        L.backward()
        tr.step(1)
        losses.append(float(L.asnumpy()))
    return np.array(losses)


def test_torch_block_trains_with_gluon_trainer():
    blocks = dict(zip((mx, tmx), _pair(_mlp())))
    x, y = _data(2, 6, 4), _data(3, 6, 2)
    ref, port = _both(lambda pkg: _train(pkg, blocks[pkg], x, y, 40, 0.5))
    assert port[-1] < port[0] * 0.2, (port[0], port[-1])
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-6)


def test_torch_block_composes_with_gluon_layers():
    blocks = dict(zip((mx, tmx), _pair(_mlp())))
    heads = {}
    for pkg in (mx, tmx):
        with pkg.name.NameManager():
            heads[pkg] = pkg.gluon.nn.Dense(1, in_units=2)
        heads[pkg].initialize(pkg.init.Xavier())
    w = heads[mx].collect_params()
    for name, p in heads[tmx].collect_params().items():
        p.set_data(tmx.nd.array(w[name].data().asnumpy()))
    x, y = _data(3, 8, 4), _data(4, 8, 1)
    ref, port = _both(lambda pkg: _train(pkg, blocks[pkg], x, y, 40, 0.3,
                                         heads[pkg]))
    assert port[-1] < port[0] * 0.5, (port[0], port[-1])
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-6)


def test_torch_block_shared_encoder_double_call():
    """The siamese pattern: one TorchBlock called twice inside one
    record(); both calls' gradients sum into the one weight."""
    torch.manual_seed(0)
    blocks = dict(zip((mx, tmx), _pair(torch.nn.Linear(4, 2))))
    x1, x2 = _data(0, 3, 4), _data(1, 3, 4)

    def grads(pkg):
        with pkg.autograd.record():
            L = pkg.nd.mean(blocks[pkg](pkg.nd.array(x1)) +
                            blocks[pkg](pkg.nd.array(x2)))
        L.backward()
        return [p.grad().asnumpy()
                for p in blocks[pkg].collect_params().values()]

    for got, want in zip(*reversed(_both(grads))):
        np.testing.assert_allclose(got, want, **_GRAD)


def test_torch_block_integer_inputs():
    torch.manual_seed(0)
    blocks = dict(zip((mx, tmx), _pair(torch.nn.Embedding(10, 4))))
    idx = np.array([1, 2, 3], np.int64)

    def run(pkg):
        te = blocks[pkg]
        out = te(pkg.nd.array(idx)).asnumpy()
        with pkg.autograd.record():
            L = pkg.nd.sum(te(pkg.nd.array(idx)))
        L.backward()
        return out, list(te.collect_params().values())[0].grad().asnumpy()

    (ref_out, ref_g), (out, g) = _both(run)
    assert out.shape == (3, 4)
    np.testing.assert_allclose(out, ref_out, rtol=1e-6)
    np.testing.assert_array_equal(g, ref_g)
    assert g[1].sum() != 0 and g[5].sum() == 0  # only looked-up rows


def test_torch_block_frozen_param():
    torch.manual_seed(0)
    m = torch.nn.Linear(4, 2)
    m.bias.requires_grad_(False)
    blocks = dict(zip((mx, tmx), _pair(m)))
    x = _data(0, 3, 4)

    def run(pkg):
        tb = blocks[pkg]
        with pkg.autograd.record():
            L = pkg.nd.sum(tb(pkg.nd.array(x)))
        L.backward()
        params = tb.collect_params()
        reqs = {n.split("_", 1)[1]: p.grad_req for n, p in params.items()}
        w = [p for n, p in params.items() if n.endswith("weight")][0]
        return reqs, w.grad().asnumpy()

    (ref_reqs, ref_g), (reqs, g) = _both(run)
    assert reqs == ref_reqs == {"weight": "write", "bias": "null"}
    np.testing.assert_allclose(g, ref_g, **_GRAD)


def test_torch_block_batchnorm_buffers_checkpoint(tmp_path):
    """A training call moves BatchNorm's running statistics, which are
    grad_req='null' Parameters, as the reference's are; a fresh block
    loading the saved parameters gives the same eval outputs."""
    blocks = dict(zip((mx, tmx), _pair(torch.nn.BatchNorm1d(4))))
    x = np.random.RandomState(0).uniform(1.0, 2.0, (16, 4)).astype(
        np.float32)

    def run(pkg):
        tb = blocks[pkg]
        with pkg.autograd.record():
            pkg.nd.sum(tb(pkg.nd.array(x))).backward()
        stats = {n.split("_", 1)[1]: p.data().asnumpy()
                 for n, p in tb.collect_params().items()
                 if "running" in n}
        f = os.path.join(str(tmp_path), "%s.params" % pkg.__name__)
        tb.save_params(f)
        cls = RefTorchBlock if pkg is mx else TorchBlock
        tb2 = cls(torch.nn.BatchNorm1d(4))
        tb2.load_params(f)
        return stats, tb(pkg.nd.array(x)).asnumpy(), \
            tb2(pkg.nd.array(x)).asnumpy()

    (ref_stats, ref_out, _), (stats, out, out2) = _both(run)
    assert stats["running_mean"].sum() != 0
    for k in ref_stats:
        np.testing.assert_allclose(stats[k], ref_stats[k], rtol=1e-6)
    np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out2, out, rtol=1e-6)


def test_parameters_are_the_module_tensors():
    """The port's Parameters wrap the module's own tensors (same storage,
    no copy through the host), on the block's context."""
    m = _mlp()
    tb = TorchBlock(m, ctx=tmx.cpu())
    for (tname, t), p in zip(m.named_parameters(),
                             tb.collect_params().values()):
        assert p.data()._data.data_ptr() == t.data_ptr(), tname
        assert p.data().context == tmx.cpu()
    assert tb.module is m


def test_module_runs_on_the_current_values():
    """An update that rebinds a Parameter (as the optimizers do) is what
    the next call computes with."""
    torch.manual_seed(0)
    tb = TorchBlock(torch.nn.Linear(3, 2, bias=False))
    w = list(tb.collect_params().values())[0]
    w.set_data(tmx.nd.array(np.eye(2, 3, dtype=np.float32)))
    x = _data(5, 4, 3)
    np.testing.assert_array_equal(tb(tmx.nd.array(x)).asnumpy(), x[:, :2])
