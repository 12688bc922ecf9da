"""Port parity for the persistent fused-RNN scan (mxnet_tpu_torch/ops/
fused_rnn.py, K4a-b) against the JAX reference's kernels in
mxnet_tpu/ops/pallas_rnn.py, run in Pallas interpret mode on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions, which
repeat the CUDA kernels' arithmetic and rounding points; the card holds
the kernels to these plain versions (tests/test_torch_cuda.py,
chip_smoke.py phase 10). Inputs are numpy arrays from a seed, handed to
both packages (bfloat16 values cross exactly through float32).

Tolerances, the reference's own (tests/test_pallas_rnn.py:43-68):
outputs float32 1e-5 (float32 arithmetic in another summation order) and
bfloat16 3e-2 (one rounding to 8 mantissa bits of values that may differ
in the last float32 bit); gradients float32 rtol 1e-4 / atol 1e-5 and
bfloat16 rtol 5e-2 / atol 5e-1 (the rounded dpre feeds a T-step chain).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import nn as ref_nn
from mxnet_tpu.ops import pallas_rnn

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_rnn
from mxnet_tpu_torch.ops import nn as port_nn

_G = {"lstm": 4, "gru": 3, "rnn_relu": 1, "rnn_tanh": 1}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_OUT_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
            "bfloat16": dict(rtol=3e-2, atol=3e-2)}
_GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
             "bfloat16": dict(rtol=5e-2, atol=5e-1)}
_N, _C, _H = 3, 5, 8


def _np(a):
    return np.asarray(a, np.float32)


def _torch(a, dname):
    return torch.from_numpy(np.array(_np(a))).to(_TDT[dname])


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got.detach().float()) if isinstance(
        got, torch.Tensor) else _np(got), _np(want), err_msg=msg, **tol)


def _layer(mode, T, N, H, dname, seed=0):
    """px, h0, c0, wh in the dtype (rounded once, shared by both sides)."""
    rng = np.random.RandomState(seed)
    GH = _G[mode] * H
    arrs = (rng.randn(T, N, GH) * 0.5, rng.randn(N, H) * 0.1,
            rng.randn(N, H) * 0.1, rng.randn(GH, H) * 0.2)
    return [jnp.asarray(a.astype(np.float32), _JDT[dname]) for a in arrs]


def _cotangents(T, N, H, dname, seed=1):
    rng = np.random.RandomState(seed)
    return [jnp.asarray(rng.randn(*s).astype(np.float32), _JDT[dname])
            for s in ((T, N, H), (N, H), (N, H))]


@pytest.mark.parametrize("mode", ["lstm", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T", [1, 35])
def test_fused_scan_layer_matches_pallas(mode, dname, reverse, T):
    """ys, hT, cT and every gradient (px, h0, c0, wh) of the port's
    autograd Function against the reference's custom VJP in interpret
    mode, for the same output cotangents."""
    args = _layer(mode, T, _N, _H, dname)
    cts = _cotangents(T, _N, _H, dname)

    def ref_fn(*a):
        return pallas_rnn.fused_scan_layer(mode, *a, reverse=reverse,
                                           interpret=True)

    ref_outs, vjp = jax.vjp(ref_fn, *args)
    ref_grads = vjp(tuple(cts))

    ins = [_torch(a, dname).requires_grad_(True) for a in args]
    outs = fused_rnn.fused_scan_layer(mode, *ins, reverse=reverse)
    grads = torch.autograd.grad(outs, ins, [_torch(c, dname) for c in cts])
    for name, a, b in zip(("ys", "hT", "cT"), outs, ref_outs):
        assert a.dtype == _TDT[dname]
        _close(a, b, _OUT_TOL[dname], name)
    for name, a, b in zip(("px", "h0", "c0", "wh"), grads, ref_grads):
        _close(a, b, _GRAD_TOL[dname], "grad " + name)


@pytest.mark.parametrize("mode", ["lstm", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_kernels_match_pallas_calls(mode, dname, reverse):
    """K4a's and K4b's plain versions, called with the raw kernel inputs,
    against the reference's `_fwd_call` and `_bwd_call` (interpret):
    ys, cs, hT, cT; dpx, dh0, dc0 and the float32 dWh."""
    T = 7
    px, h0, c0, wh = _layer(mode, T, _N, _H, dname, seed=2)
    lstm = mode == "lstm"
    ys, cs, hT, cT = pallas_rnn._fwd_call(mode, px, h0, c0 if lstm else None,
                                          wh, reverse, True)
    got = fused_rnn.rnn_fwd_plain(mode, _torch(px, dname),
                                  _torch(h0, dname), _torch(c0, dname),
                                  _torch(wh, dname), reverse=reverse)
    want = (ys, cs, hT, cT)
    for name, a, b in zip(("ys", "cs", "hT", "cT"), got, want):
        if b is None:
            assert a is None
            continue
        _close(a, b, _OUT_TOL[dname], name)

    dys, dhT, dcT = _cotangents(T, _N, _H, dname, seed=3)
    hprev = pallas_rnn._shift_prev(h0, ys, reverse)
    cprev = pallas_rnn._shift_prev(c0, cs, reverse) if lstm else None
    ref = pallas_rnn._bwd_call(mode, px, ys, hprev, cprev, cs, wh, dys, dhT,
                               dcT if lstm else None, reverse, True)
    t = lambda a: None if a is None else _torch(a, dname)  # noqa: E731
    got = fused_rnn.rnn_bwd_plain(mode, t(px), t(ys), t(hprev), t(cprev),
                                  t(cs), t(wh), t(dys), t(dhT), t(dcT),
                                  reverse)
    for name, a, b in zip(("dpx", "dh0", "dc0", "dwh"), got, ref):
        if b is None:
            assert a is None
            continue
        _close(a, b, _GRAD_TOL[dname], name)
    assert got[3].dtype == torch.float32


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("reverse", [False, True])
def test_composite_scan_layer_matches_reference(mode, reverse):
    """The composite loop (`_scan_layer(fused=False)`, the card's oracle)
    against the reference's lax.scan: outputs and every gradient (xs, h0,
    c0, wi, wh, bi, bh), float32."""
    rng = np.random.RandomState(4)
    T, G = 6, _G[mode]
    arrs = [a.astype(np.float32) for a in (
        rng.randn(T, _N, _C), rng.randn(_N, _H) * 0.1,
        rng.randn(_N, _H) * 0.1, rng.randn(G * _H, _C) * 0.2,
        rng.randn(G * _H, _H) * 0.2, rng.randn(G * _H) * 0.1,
        rng.randn(G * _H) * 0.1)]
    cts = [rng.randn(*s).astype(np.float32)
           for s in ((T, _N, _H), (_N, _H), (_N, _H))]

    def ref_fn(*a):
        return ref_nn._scan_layer(mode, *a, reverse=reverse, fused=False)

    ref_outs, vjp = jax.vjp(ref_fn, *map(jnp.asarray, arrs))
    ref_grads = vjp(tuple(map(jnp.asarray, cts)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    outs = port_nn._scan_layer(mode, *ins, reverse=reverse, fused=False)
    grads = torch.autograd.grad(outs, ins, [torch.from_numpy(c)
                                            for c in cts], allow_unused=True)
    for a, b in zip(outs, ref_outs):
        _close(a, b, _OUT_TOL["float32"])
    for name, a, b in zip("xs h0 c0 wi wh bi bh".split(), grads, ref_grads):
        a = torch.zeros(b.shape) if a is None else a
        _close(a, b, dict(rtol=1e-4, atol=1e-5), "grad " + name)


def test_dwh_accumulates_across_batch_tiles():
    """N = 512: two of the reference kernel's batch tiles and 128 of the
    CUDA kernel's; dWh sums over every row of every step."""
    T, N = 3, 512
    px, h0, c0, wh = _layer("lstm", T, N, _H, "float32", seed=5)
    assert pallas_rnn._batch_tile("lstm", N, _H, 4) == 256
    assert fused_rnn.batch_tile(N) == 4
    dys = jnp.asarray(np.random.RandomState(6).randn(T, N, _H)
                      .astype(np.float32))

    def ref_loss(w):
        ys, _, _ = pallas_rnn.fused_scan_layer("lstm", px, h0, c0, w,
                                               interpret=True)
        return jnp.sum(ys * dys)

    want = jax.grad(ref_loss)(wh)
    w = _torch(wh, "float32").requires_grad_(True)
    ys, _, _ = fused_rnn.fused_scan_layer("lstm", _torch(px, "float32"),
                                          _torch(h0, "float32"),
                                          _torch(c0, "float32"), w)
    got, = torch.autograd.grad((ys * _torch(dys, "float32")).sum(), w)
    _close(got, want, dict(rtol=1e-4, atol=1e-4))


@pytest.mark.parametrize("mode", ["lstm", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_declared_costs_are_the_references(mode, dname):
    """The bound's inputs: both kernels' (flops, bytes, transcendentals)
    equal the reference's declared costs, at the word LM's shape and a
    small one."""
    for T, N, H in ((35, 32, 200), (35, 32, 256), (3, 5, 8)):
        assert fused_rnn.fwd_declared_cost(mode, T, N, H, _TDT[dname]) == \
            pallas_rnn.fwd_declared_cost(mode, T, N, H, _JDT[dname])
        assert fused_rnn.bwd_declared_cost(mode, T, N, H, _TDT[dname]) == \
            pallas_rnn.bwd_declared_cost(mode, T, N, H, _JDT[dname])
    # bf16 word LM: 3.06 MB forward, 6.39 MB backward
    if mode == "lstm" and dname == "bfloat16":
        assert fused_rnn.fwd_declared_cost(mode, 35, 32, 200,
                                           torch.bfloat16)[1] == 3059200
        assert fused_rnn.bwd_declared_cost(mode, 35, 32, 200,
                                           torch.bfloat16)[1] == 6387200


@pytest.mark.parametrize("reverse", [False, True])
def test_shift_prev_matches_reference(reverse):
    rng = np.random.RandomState(7)
    s0, seq = rng.randn(3, 4).astype(np.float32), \
        rng.randn(5, 3, 4).astype(np.float32)
    want = pallas_rnn._shift_prev(jnp.asarray(s0), jnp.asarray(seq), reverse)
    got = fused_rnn._shift_prev(torch.from_numpy(s0), torch.from_numpy(seq),
                                reverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_use_fused_reads_the_env_at_every_call(monkeypatch):
    monkeypatch.delenv("MXNET_FUSED_RNN", raising=False)
    assert not fused_rnn.use_fused(None)
    monkeypatch.setenv("MXNET_FUSED_RNN", "1")
    assert fused_rnn.use_fused(None)
    assert not fused_rnn.use_fused(False)
    monkeypatch.setenv("MXNET_FUSED_RNN", "0")
    assert not fused_rnn.use_fused(None)
    assert fused_rnn.use_fused(True)


def test_flag_routes_the_scan_layer(monkeypatch):
    """Flag on: lstm / rnn_* reach fused_scan_layer at each call; flag
    off they take the loop, byte for byte the fused=False result; gru
    never reaches it (the reference's semantics)."""
    calls = []
    real = fused_rnn.fused_scan_layer

    def spy(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(fused_rnn, "fused_scan_layer", spy)
    rng = np.random.RandomState(8)
    for mode in ("lstm", "gru", "rnn_tanh"):
        G = _G[mode]
        a = [torch.from_numpy(x.astype(np.float32)) for x in (
            rng.randn(4, _N, _C), rng.randn(_N, _H) * 0.1,
            rng.randn(_N, _H) * 0.1, rng.randn(G * _H, _C) * 0.2,
            rng.randn(G * _H, _H) * 0.2, rng.randn(G * _H) * 0.1,
            rng.randn(G * _H) * 0.1)]
        monkeypatch.setenv("MXNET_FUSED_RNN", "0")
        off = port_nn._scan_layer(mode, *a)
        ref = port_nn._scan_layer(mode, *a, fused=False)
        for x, y in zip(off, ref):
            assert torch.equal(x, y)
        assert calls == []
        monkeypatch.setenv("MXNET_FUSED_RNN", "1")
        on = port_nn._scan_layer(mode, *a)
        for x, y in zip(on, ref):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
        assert calls == ([] if mode == "gru" else [mode])
        calls.clear()


def test_gate_names_its_limits():
    f32, bf16 = torch.float32, torch.bfloat16
    for H in (200, 256):
        for dt in (f32, bf16):
            for mode in ("lstm", "rnn_relu", "rnn_tanh"):
                assert fused_rnn.fused_rnn_supported(mode, 35, 32, H, dt)
    assert fused_rnn.fused_rnn_supported("lstm", 1, 1, 7, f32)
    assert fused_rnn.fused_rnn_supported("lstm", 35, 32, 1024, bf16)
    lim = fused_rnn.fused_rnn_limit
    assert "gru" in lim("gru", 35, 32, 200, f32)
    assert "float32 or bfloat16" in lim("lstm", 35, 32, 200, torch.float16)
    assert "mixed" in lim("lstm", 35, 32, 200, bf16, f32)
    assert "up to 1024" in lim("lstm", 35, 32, 1025, f32)
    assert "empty" in lim("lstm", 0, 32, 200, f32)


def test_out_of_gate_raises_on_any_device():
    """No composite fallback behind the flag: a layer outside the gate
    raises, here on the CPU as on the card."""
    T, H = 2, 4
    px = torch.zeros(T, 1, 4 * H, dtype=torch.float16)
    h = torch.zeros(1, H, dtype=torch.float16)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        fused_rnn.fused_scan_layer("lstm", px, h, h,
                                   torch.zeros(4 * H, H, dtype=torch.float16))
    x = torch.zeros(T, 1, 3)
    flat = torch.zeros(port_nn.rnn_param_size(1, 3, 1025, False, "rnn_tanh"))
    with pytest.raises(MXNetError, match="up to 1024"):
        port_nn.RNN(x, flat, torch.zeros(1, 1, 1025), state_size=1025,
                    mode="rnn_tanh", fused=True)


def test_cpu_takes_the_plain_versions_and_counts_no_launch():
    n0 = fused_rnn.launch_counts()
    px, h0, c0, wh = (_torch(a, "float32") for a in
                      _layer("lstm", 4, 2, 6, "float32", seed=9))
    px.requires_grad_(True)
    ys, hT, cT = fused_rnn.fused_scan_layer("lstm", px, h0, c0, wh)
    (ys.sum() + hT.sum()).backward()
    assert fused_rnn.launch_counts() == n0
    assert px.grad is not None and torch.isfinite(px.grad).all()


def test_batch_tile_fills_sixteen_or_more_blocks():
    """At the word LM's batch of 32, 16 blocks of 2 rows; small batches a
    row a block; large batches 4 rows a block."""
    assert [fused_rnn.batch_tile(n) for n in (1, 7, 16, 17, 32, 33, 64,
                                               512)] == \
        [1, 1, 1, 2, 2, 4, 4, 4]


#: clusters of P blocks an H100 runs at once, at every layout the cluster
#: design takes (csrc/fused_rnn.cu mxtt_rnn_max_clusters, the card's
#: reading in tools/rnn_design_sweep.py): the card's answer that
#: `rnn_design` asks for, stood in for on the CPU
_H100_AT_ONCE = {16: 7, 8: 15, 4: 30}


def _design(mode, N, H, dt):
    return fused_rnn.rnn_design(mode, N, H, dt,
                                lambda P, R: _H100_AT_ONCE[P])


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_word_lm_shapes_take_the_cluster_design(dname):
    """The word LM's layer (N 32, H 200, lstm) in both dtypes and
    bench_lstm_sweep's H 256 in bfloat16 keep wh resident across a
    cluster (16 blocks of 8 rows, one wave), within a block's shared
    memory."""
    shapes = [(32, 200), (32, 256)] if dname == "bfloat16" else [(32, 200)]
    for N, H in shapes:
        d = _design("lstm", N, H, _TDT[dname])
        assert d.name == "cluster" and (d.P, d.rows) == (16, 8), d
        assert max(d.fwd_smem, d.bwd_smem) <= fused_rnn.SMEM_LIMIT
        assert d.blocks == -(-N // d.rows) * d.P


@pytest.mark.parametrize("mode", ["lstm", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_design_streams_past_the_shared_memory_limit(mode, dname):
    """At the largest H of the cluster design a layout fits; one more unit
    and none fits a block's shared memory, so the streaming design runs,
    at any batch."""
    dt = _TDT[dname]
    for N in (7, 32, 300):
        edge = fused_rnn.cluster_limit(mode, N, dt)
        assert 200 < edge < fused_rnn.MAX_HIDDEN
        assert _design(mode, N, edge, dt).name == "cluster"
        past = _design(mode, N, edge + 1, dt)
        assert past.name == "stream" and past.P == 0
        assert past.rows == fused_rnn.batch_tile(N)
        assert fused_rnn.cluster_layouts(mode, N, edge + 1, dt) == []
        for P in fused_rnn.CLUSTER_BLOCKS:
            for R in fused_rnn.CLUSTER_ROWS:
                R = min(R, N)
                assert (max(fused_rnn.cluster_smem_bytes(
                    mode, edge + 1, R, P, dt, b) for b in (False, True))
                    > fused_rnn.SMEM_LIMIT
                    or R * fused_rnn.cluster_units(edge + 1, P, dt)
                    > fused_rnn.CLUSTER_ELEMS)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_design_takes_the_fewest_waves(dname):
    """Past one wave of clusters the cluster design still runs, in several
    waves, at the layout with the fewest: at H 200 the rows a cluster
    grow with the batch (the readings of tools/rnn_design_sweep.py, where
    the streaming design ran 2.0-9.5 times longer); ties go to the fewest
    rows, then the most blocks; a card that runs fewer clusters at once
    gets more rows a cluster."""
    dt = _TDT[dname]
    want = {"bfloat16": {32: 8, 64: 16, 128: 32, 256: 32, 512: 32},
            "float32": {32: 8, 64: 16, 128: 16, 256: 16, 512: 16}}[dname]
    for N, rows in want.items():
        d = _design("lstm", N, 200, dt)
        assert (d.name, d.P, d.rows) == ("cluster", 16, rows), (N, d)
        waves = -(-(d.blocks // d.P) // _H100_AT_ONCE[d.P])
        assert all(-(-(-(-N // R)) // _H100_AT_ONCE[P]) >= waves
                   for P, R, _, _ in fused_rnn.cluster_layouts(
                       "lstm", N, 200, dt))
    # at H 64 every block count fits: 16 blocks while one wave holds the
    # clusters of 8 rows, then 8, then 4
    assert [(_design("lstm", N, 64, dt).P, _design("lstm", N, 64, dt).rows)
            for N in (32, 64, 128)] == [(16, 8), (8, 8), (4, 8)]
    one = fused_rnn.rnn_design("lstm", 64, 200, dt, lambda P, R: 1)
    assert (one.P, one.rows) == (16, max(
        R for _, R, _, _ in fused_rnn.cluster_layouts("lstm", 64, 200, dt)))
    none = fused_rnn.rnn_design("lstm", 64, 200, dt, lambda P, R: 0)
    assert none.name == "stream"


@pytest.mark.parametrize("mode", ["lstm", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_tiny_layers_stream(mode, dname):
    """Layers of at most 16 batch rows and 64 gate rows take the streaming
    design, where its step is shorter than the cluster design's (the
    readings of tools/rnn_design_sweep.py); one more row or gate row and
    the cluster design runs."""
    dt = _TDT[dname]
    G = _G[mode]
    top = fused_rnn.STREAM_MAX_GATE_ROWS // G
    rows = fused_rnn.STREAM_MAX_ROWS
    for N in (1, 3, rows):
        for H in (1, 13 // G + 1, top):
            assert _design(mode, N, H, dt).name == "stream", (N, H)
        assert _design(mode, N, top + 1, dt).name == "cluster", N
    assert _design(mode, rows + 1, top, dt).name == "cluster"


@pytest.mark.parametrize("mode", ["lstm", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_every_admitted_shape_gets_a_design(mode, dname):
    """Every (N, H) that fused_rnn_limit admits gets a design, fixed by
    (mode, N, H, dtype) and the card, whose blocks use at most 227 KB of
    shared memory: a cluster layout of CLUSTER_BLOCKS x CLUSTER_ROWS, else
    streaming."""
    dt = _TDT[dname]
    for N in (1, 2, 7, 8, 9, 16, 17, 32, 33, 56, 57, 120, 121, 240, 241,
              4096, 2**31 - 1):
        for H in list(range(1, 64)) + list(range(64, 1025, 29)) + [1024]:
            assert fused_rnn.fused_rnn_limit(mode, 35, N, H, dt) is None
            d = _design(mode, N, H, dt)
            assert d == _design(mode, N, H, dt)
            assert max(d.fwd_smem, d.bwd_smem) <= fused_rnn.SMEM_LIMIT, d
            if d.name == "cluster":
                assert d.P in fused_rnn.CLUSTER_BLOCKS
                assert d.rows in [min(r, N) for r in fused_rnn.CLUSTER_ROWS]
                assert d.blocks == -(-N // d.rows) * d.P
            else:
                assert d.name == "stream" and d.P == 0
                assert d.rows == fused_rnn.batch_tile(N)


def test_cluster_smem_grows_with_the_slice():
    """The layout's bytes grow with H and with the cluster's rows, and a
    cluster of 16 blocks keeps half the wh rows of one of 8."""
    f = fused_rnn.cluster_smem_bytes
    for dt in (torch.float32, torch.bfloat16):
        for bwd in (False, True):
            sizes = [f("lstm", H, 8, 16, dt, bwd) for H in range(16, 400, 16)]
            assert sizes == sorted(sizes)
            assert f("lstm", 200, 16, 16, dt, bwd) > f("lstm", 200, 8, 16,
                                                       dt, bwd) or dt == \
                torch.bfloat16  # bf16 pads rows to the mma tile of 16
            assert f("lstm", 256, 8, 16, dt, bwd) < f("lstm", 256, 8, 8, dt,
                                                      bwd)


@pytest.mark.parametrize("mode", ["lstm", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_card_limits_pass_the_plain_versions_and_reject_faults(mode, dname):
    """PLAIN_TOL and `fed_plain`, how the card holds K4a-b to the plain
    versions: the plain versions (here the wrappers' CPU path) pass
    against themselves fed with their own outputs; a zeroed dWh, a halved
    dh0 or dpx, and in bfloat16 the forward without h's rounding or the
    backward without dpre's (the plain versions in float32, rounded at
    the end) fail."""
    dt = _TDT[dname]
    a = fused_rnn.check_inputs(mode, 35, 8, 32, dt, seed=3, device="cpu")
    got = fused_rnn.chain(mode, a)
    want = fused_rnn.fed_plain(mode, a, got)
    for n, x in got.items():
        assert (x is None) == (want[n] is None), n
        if x is not None:
            assert fused_rnn.plain_mismatch(x, want[n]) is None, n
    faults = [{"dwh": got["dwh"] * 0}, {"dh0": got["dh0"] * 0.5},
              {"dpx": got["dpx"] * 0.5}]
    if dname == "bfloat16":
        f32 = {k: v.float() for k, v in a.items()}
        faults.append({"ys": fused_rnn.rnn_fwd_plain(
            mode, f32["px"], f32["h0"], f32["c0"], f32["wh"])[0].to(dt)})
        hprev = fused_rnn._shift_prev(a["h0"], got["ys"], False).float()
        cprev = (fused_rnn._shift_prev(a["c0"], got["cs"], False).float()
                 if mode == "lstm" else None)
        cs = None if got["cs"] is None else got["cs"].float()
        _, dh0, _, dwh = fused_rnn.rnn_bwd_plain(
            mode, f32["px"], got["ys"].float(), hprev, cprev, cs, f32["wh"],
            f32["dys"], f32["dhT"], f32["dcT"])
        faults += [{"dwh": dwh}, {"dh0": dh0.to(dt)}]
    for outs in faults:
        want = fused_rnn.fed_plain(mode, a, dict(got, **outs))
        assert any(fused_rnn.plain_mismatch(x, want[n]) is not None
                   for n, x in outs.items()), sorted(outs)
