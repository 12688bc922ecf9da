"""examples/nce_word_embeddings.py on the port against the JAX
reference, on the CPU.

The example file is loaded twice through importlib
(`chip_smoke.load_example`): once with `mxnet_tpu` the reference itself,
once with `mxnet_tpu` and its `gluon` resolving to `mxnet_tpu_torch`
while it imports, so its code runs on the port unchanged. Both runs draw their noise words from one
numpy-seeded stream in place of `mx.nd.random.uniform` (the packages'
generators differ) and start from the same numpy-seeded embedding tables
in place of Xavier's draw; the example's own corpus and batch indices
come from its own RandomState(0). The losses of the first 50 steps must
agree within 1e-4, and each run must pass the example's own final check
(the loss falls and the true successor wins over 75 % of the time) at its
defaults (400 steps). The reference runs under
`mxnet_tpu.random.trace_key_scope`, which this sandbox's jax needs for
its eager draws.
"""
import contextlib
import sys

import numpy as np

import jax

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx

from chip_smoke import load_example


def _seeded_net(module, pkg):
    """The example's NCEEmbeddings with numpy-seeded tables."""

    class Seeded(module.NCEEmbeddings):
        def initialize(self, *args, **kwargs):
            super().initialize(*args, **kwargs)
            for i, (_, p) in enumerate(sorted(
                    self.collect_params().items())):
                p.set_data(pkg.nd.array(np.random.RandomState(10 + i)
                                        .uniform(-0.1, 0.1, p.shape)
                                        .astype(np.float32)))
    return Seeded


def _run(pkg, monkeypatch, scope):
    module = load_example("nce_word_embeddings.py", pkg)
    module.NCEEmbeddings = _seeded_net(module, pkg)
    noise = np.random.RandomState(123)

    def uniform(low=0, high=1, shape=None, **kwargs):
        return pkg.nd.array(noise.uniform(low, high, shape)
                            .astype(np.float32))

    losses = []
    base = pkg.gluon.loss.SigmoidBinaryCrossEntropyLoss

    class Recorded(base):
        def __call__(self, *args, **kwargs):
            out = super().__call__(*args, **kwargs)
            losses.append(float(out.mean().asscalar()))
            return out

    monkeypatch.setattr(pkg.nd.random, "uniform", uniform)
    monkeypatch.setattr(pkg.gluon.loss, "SigmoidBinaryCrossEntropyLoss",
                        Recorded)
    monkeypatch.setattr(sys, "argv", ["nce_word_embeddings.py"])
    with scope:
        rc = module.main()
    monkeypatch.undo()
    return rc, losses


def test_nce_example_matches_reference(monkeypatch, capsys):
    ref_rc, ref_losses = _run(mx, monkeypatch, mx.random.trace_key_scope(
        jax.random.PRNGKey(0)))
    with tmx.cpu():
        port_rc, port_losses = _run(tmx, monkeypatch,
                                    contextlib.nullcontext())
    out = capsys.readouterr().out
    assert ref_rc == 0 and port_rc == 0, out
    assert len(port_losses) == len(ref_losses) == 400
    np.testing.assert_allclose(port_losses[:50], ref_losses[:50],
                               rtol=1e-4, atol=1e-4)
    assert port_losses[-1] < port_losses[0]


def test_nce_example_runs_unpatched(monkeypatch, capsys):
    """The example as written (the port's own generators and Xavier), at
    a shorter run: it imports and trains through the port's `floor`."""
    module = load_example("nce_word_embeddings.py", tmx)
    monkeypatch.setattr(sys, "argv", ["nce_word_embeddings.py",
                                      "--steps", "150"])
    tmx.seed(0)
    with tmx.cpu():
        rc = module.main()
    assert rc == 0, capsys.readouterr().out
    assert "mxnet_tpu_torch" in module.mx.__name__
