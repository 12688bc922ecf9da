"""Persistent fused-RNN scan, forward and backward (port of
`mxnet_tpu/ops/pallas_rnn.py`).

One (direction of one) RNN layer from its pre-projected inputs px
[T, N, G*H] (x @ wi.T + biases, computed outside, as the reference
hoists it):

- `rnn_fwd` (K4a) the whole recurrence in one launch: pre_t = px_t +
  round(h_{t-1}) @ wh.T, the gates (lstm: i, f, g, o; rnn_relu;
  rnn_tanh) and the cell update, h and c carried in float32; ys (and cs)
  stored rounded to the activation type, hT (and cT) at the end;
- `rnn_bwd` (K4b) the reverse-time backward: the gates recomputed from px
  and the saved h_{t-1}, c_{t-1} and c_t, the fused dGates / dCell / dH
  chain, dpre rounded to the activation type as dpx and used rounded for
  dh_{t-1} = dpre @ wh and for dWh = sum_t dpre_t.T @ h_{t-1} (float32).

On CUDA tensors each launches its hand-written Hopper kernels in
`csrc/fused_rnn.cu` (counted in `<function>.launches`, and by design in
`<function>.design_launches`; K4b's call is the scan and, where it takes
one, the dWh product or sum, counted once), or raises naming the limit;
there is no fallback. `rnn_design` picks the kernels' design from (mode,
N, H, dtype) before the launch: the cluster design (wh resident across a
thread-block cluster, h and the dh partials exchanged through distributed
shared memory, clusters in as many waves as the batch needs) wherever its
slices fit a block's shared memory, except in tiny layers, else the
streaming design (a block owns batch rows and streams wh from L2 each
step). On CPU tensors, and only
there, each runs its plain PyTorch version (`rnn_fwd_plain`,
`rnn_bwd_plain`), which repeats the kernels' arithmetic and rounding
points step by step; the CPU tests hold it to the reference's kernels in
interpret mode and `chip_smoke.py` holds the kernels to it on the card.

`fused_scan_layer` wires them into a `torch.autograd.Function` per mode
family, as the reference's custom VJP does. `MXNET_FUSED_RNN=1` (read at
every call) or `RNN(..., fused=True)` routes `ops/nn.py::_scan_layer`
here for lstm, rnn_relu and rnn_tanh; gru keeps the composite scan, as in
the reference, where the fused kernels have no gru mode by design (its
reset gate multiplies the hidden-side bias inside the cell). That is the
reference's semantics, not a fallback: a gru layer never reaches this
module.

The reference's TPU gate (H % 128, `_MAX_GRID`, `_VMEM_BUDGET`) does not
carry over. `fused_rnn_limit` states the Hopper kernels' own: lstm,
rnn_relu or rnn_tanh; float32 or bfloat16, one dtype for px, the states
and wh; no empty dimension; H up to 1024 (the streaming design keeps a
block's rows' gates and states in shared memory); N below 2^31.
"""
from __future__ import annotations

import collections
import functools
import os

import torch

from ..base import MXNetError

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4}
_MODE_CODE = {"lstm": 0, "rnn_relu": 1, "rnn_tanh": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the largest hidden size the kernels take: the streaming design's block
#: keeps [bn, G*H] gate pre-activations and its rows' states in shared
#: memory (131 KB at H 1024, bn 4 in the backward, of the 227 KB a block
#: may use)
MAX_HIDDEN = 1024


def fuse_rnn_enabled():
    """MXNET_FUSED_RNN=1, read at each call."""
    return os.environ.get("MXNET_FUSED_RNN", "0") == "1"


def use_fused(fused):
    """Resolve the per-call `fused` override against the env default."""
    return fuse_rnn_enabled() if fused is None else bool(fused)


def fused_rnn_limit(mode, T, N, H, *dtypes):
    """None when the fused kernels take this layer, else the condition it
    breaks, named."""
    if mode not in _GATES:
        return ("mode %r: the fused kernels take lstm, rnn_relu and rnn_tanh"
                % (mode,))
    if T < 1 or N < 1 or H < 1:
        return "empty shape T=%d N=%d H=%d" % (T, N, H)
    if len(set(dtypes)) != 1:
        return ("mixed dtypes %s: px, the states and wh must share one"
                % sorted(str(d) for d in set(dtypes)))
    if dtypes[0] not in _DTYPE_CODE:
        return "dtype %s: the fused kernels take float32 or bfloat16" \
            % (dtypes[0],)
    if H > MAX_HIDDEN:
        return ("H=%d: the fused kernels take H up to %d (a block keeps its "
                "rows' gates in shared memory)" % (H, MAX_HIDDEN))
    if N >= 2**31:
        return "N=%d: the fused kernels take N below 2^31" % N
    return None


def fused_rnn_supported(mode, T, N, H, dtype):
    """The Hopper gate of the fused kernels (see `fused_rnn_limit`)."""
    return fused_rnn_limit(mode, T, N, H, dtype) is None


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def fwd_declared_cost(mode, T, N, H, dtype):
    """(flops, bytes, transcendentals) of one K4a call, the reference's
    declared cost copied as is (pallas_rnn.py:147): wh read once, px
    streamed once, ys (+ cs) written once, the states once; no per-step
    h / c carry term."""
    G = _GATES[mode]
    GH = G * H
    sz = _itemsize(dtype)
    n_states = 2 if mode == "lstm" else 1
    nbytes = (GH * H * sz + T * N * GH * sz
              + n_states * (T * N + 2 * N) * H * sz)
    flops = T * N * (2 * GH * H + 10 * GH)
    trans = T * N * (5 * H if mode == "lstm" else
                     (H if mode == "rnn_tanh" else 0))
    return flops, nbytes, trans


def bwd_declared_cost(mode, T, N, H, dtype):
    """(flops, bytes, transcendentals) of one K4b call, the reference's
    declared cost copied as is (pallas_rnn.py:166): wh and the float32 dWh
    once, each sequence once, the states once."""
    G = _GATES[mode]
    GH = G * H
    sz = _itemsize(dtype)
    if mode == "lstm":
        flops = T * N * (6 * GH * H + 20 * GH)
        npasses = 2 * T * N * GH + 4 * T * N * H
        trans = T * N * 5 * H
    else:
        flops = T * N * (4 * GH * H + 4 * H)
        npasses = T * N * GH + 3 * T * N * H
        trans = 0
    nbytes = GH * H * (sz + 4) + npasses * sz + 4 * N * H * sz
    return flops, nbytes, trans


def batch_tile(N):
    """Batch rows a thread block owns in the streaming design (1, 2 or 4):
    enough blocks to keep 16 or more SMs busy where N allows (N 32: 16
    blocks of 2 rows); a block's step time is set by streaming wh, not by
    its rows."""
    for bn in (1, 2):
        if -(-N // bn) <= 16:
            return bn
    return 4


#: the shared memory a block may use (227 KB)
SMEM_LIMIT = 232448
#: the cluster design's blocks a cluster P and batch rows a cluster R
#: (tools/rnn_design_sweep.py; PERF.md): of the layouts that fit,
#: `rnn_design` takes the one with the fewest waves, then the fewest rows,
#: then the most blocks
CLUSTER_BLOCKS = (16, 8, 4)
CLUSTER_ROWS = (8, 16, 32)
#: layers of at most this many batch rows and gate rows (G*H) stream: the
#: streaming step is one pass of the block's warps over wh, shorter than
#: the cluster design's step (tools/rnn_design_sweep.py; PERF.md)
STREAM_MAX_ROWS, STREAM_MAX_GATE_ROWS = 16, 64
#: threads a block in both designs (csrc/fused_rnn.cu kThreads), and the
#: (batch row, unit) pairs a block of the cluster design may own: two a
#: thread, whose carries and next inputs stay in registers (kElems)
THREADS = 512
CLUSTER_ELEMS = 2 * THREADS

RnnDesign = collections.namedtuple(
    "RnnDesign", "name P rows blocks fwd_smem bwd_smem")


def _rup(a, b):
    return -(-a // b) * b


def cluster_units(H, P, dtype):
    """Hidden units a block of the cluster design owns: ceil(H / P) rounded
    up to a 16-byte vector of the dtype, so its slice moves as whole
    vectors (the last blocks own fewer, or none)."""
    return _rup(-(-H // P), 16 // _itemsize(dtype))


def cluster_smem_bytes(mode, H, R, P, dtype, bwd):
    """Shared memory of one block of the cluster design's K4a (bwd False)
    or K4b (bwd True), in bytes, as csrc/fused_rnn.cu `layout` sizes it:
    the block's slice of wh [G U, H] in the activation type (U =
    `cluster_units`), the rounded h rows in two parities, the products in
    float32; K4b adds its dWh rows [G U, H] in float32, the rounded dpre,
    its own dh partial for every k and those of P blocks for its units
    (two parities). bfloat16 pads rows to the mma tile (16), float32 to 4;
    strides are one 16-byte vector past a multiple of 32 bytes."""
    sz = _itemsize(dtype)
    pad, vec = (4, 4) if sz == 4 else (16, 16 // sz)
    U = cluster_units(H, P, dtype)
    GU = _GATES[mode] * U
    GUp, KP, Rp = _rup(GU, pad), _rup(H, 16), _rup(R, pad)
    LD, LDG = KP + vec, GUp + vec
    total = (_rup(GUp * LD * sz, 16) + _rup(2 * Rp * LD * sz, 16)
             + _rup(Rp * GUp * 4, 16))
    if not bwd:
        return total
    return total + (GU * (KP + 8) * 4 + _rup(Rp * LDG * sz, 16)
                    + Rp * (KP + 8) * 4 + _rup(2 * P * Rp * U * 4, 16))


def stream_smem_bytes(mode, H, bn, bwd):
    """Shared memory of one block of the streaming design (float32 gates
    and states of its bn rows; K4b's dh reduction slices)."""
    GH = _GATES[mode] * H
    if not bwd:
        return 4 * bn * (GH + 2 * H)
    slices = max(1, min(4, THREADS // H))
    return 4 * bn * (GH + 3 * H + slices * H)


def cluster_layouts(mode, N, H, dtype):
    """The cluster design's layouts that fit this layer: (P, R, K4a's and
    K4b's shared memory) for P in CLUSTER_BLOCKS and R = min(rows, N),
    rows in CLUSTER_ROWS, whose blocks fit SMEM_LIMIT and own at most
    CLUSTER_ELEMS (row, unit) pairs."""
    out = []
    for P in CLUSTER_BLOCKS:
        for R in sorted({min(rows, N) for rows in CLUSTER_ROWS}):
            if R * cluster_units(H, P, dtype) > CLUSTER_ELEMS:
                continue
            f, b = (cluster_smem_bytes(mode, H, R, P, dtype, bwd)
                    for bwd in (False, True))
            if max(f, b) <= SMEM_LIMIT:
                out.append((P, R, f, b))
    return out


#: {(device, mode, H, dtype, P, R): clusters the card runs at once}
_AT_ONCE = {}


def clusters_at_once(mode, H, dtype, P, R):
    """Clusters of P blocks owning R rows each that the current CUDA
    device runs at once (cudaOccupancyMaxActiveClusters through
    csrc/fused_rnn.cu mxtt_rnn_max_clusters, the fewer of K4a's and
    K4b's); asked once per device and layout."""
    key = (torch.cuda.current_device(), mode, H, dtype, P, R)
    n = _AT_ONCE.get(key)
    if n is None:
        from . import _cuda
        lib = _cuda.library("fused_rnn.cu")
        n = min(lib.mxtt_rnn_max_clusters(_DTYPE_CODE[dtype],
                                          _MODE_CODE[mode], H, R, P, bwd)
                for bwd in (0, 1))
        if n < 0:
            _cuda.check(lib, -n, "fused_rnn cluster occupancy query")
        _AT_ONCE[key] = n
    return n


def rnn_design(mode, N, H, dtype, at_once=None):
    """The kernels' design for one layer-direction, fixed before the
    launch from (mode, N, H, dtype) and the card: `RnnDesign(name, P,
    rows, blocks, fwd_smem, bwd_smem)`. A layer of at most STREAM_MAX_ROWS
    rows and STREAM_MAX_GATE_ROWS gate rows streams; otherwise "cluster"
    at the layout of `cluster_layouts` with the fewest waves of clusters
    (`at_once(P, R)` of them at once: by default `clusters_at_once` on the
    current CUDA device), then the fewest rows a cluster, then the most
    blocks; `blocks` = clusters x P. A layer no layout fits takes
    "stream": `rows` = batch_tile(N) rows a block, P = 0. Both kernels of a
    layer take the same design."""
    if at_once is None:
        at_once = functools.partial(clusters_at_once, mode, H, dtype)
    best = None
    if N > STREAM_MAX_ROWS or _GATES[mode] * H > STREAM_MAX_GATE_ROWS:
        for P, R, f, b in cluster_layouts(mode, N, H, dtype):
            n = at_once(P, R)
            if n < 1:  # the card cannot hold one such cluster
                continue
            clusters = -(-N // R)
            key = (-(-clusters // n), R, -P)
            if best is None or key < best[0]:
                best = (key, RnnDesign("cluster", P, R, clusters * P, f, b))
    if best is not None:
        return best[1]
    bn = batch_tile(N)
    return RnnDesign("stream", 0, bn, -(-N // bn),
                     stream_smem_bytes(mode, H, bn, False),
                     stream_smem_bytes(mode, H, bn, True))


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, and the card's comparisons)
# ---------------------------------------------------------------------------


def _gates_lstm(pre):
    i, f, g, o = torch.chunk(pre, 4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), \
        torch.sigmoid(o)


def rnn_fwd_plain(mode, px, h0, c0, wh, reverse=False, ys_fed=None):
    """(ys, cs, hT, cT) of one layer-direction, as K4a computes them: h and
    c carried in float32, the product on h rounded to px's dtype, ys and
    cs rounded; cs and cT are None outside lstm.

    `ys_fed` (a kernel's ys) feeds each step's product the kernel's
    previous output, which is the rounded h it multiplied, instead of this
    version's own: the card holds each step to the kernel's own inputs, so
    a float32 difference that moves one bf16 rounding does not carry down
    the chain (c stays this version's own float32 carry)."""
    T, N, _ = px.shape
    H = wh.shape[1]
    dt = px.dtype
    w = wh.float()
    lstm = mode == "lstm"
    h = h0.float()
    c = c0.float() if lstm else None
    fed = None if ys_fed is None else _shift_prev(h0, ys_fed, reverse)
    ys = torch.empty((T, N, H), dtype=dt, device=px.device)
    cs = torch.empty_like(ys) if lstm else None
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hin = h.to(dt) if fed is None else fed[t]
        pre = px[t].float() + hin.float() @ w.t()
        if lstm:
            i, f, g, o = _gates_lstm(pre)
            c = f * c + i * g
            h = o * torch.tanh(c)
            cs[t] = c.to(dt)
        elif mode == "rnn_relu":
            h = torch.clamp(pre, min=0.0)
        else:
            h = torch.tanh(pre)
        ys[t] = h.to(dt)
    return ys, cs, h.to(dt), (c.to(dt) if lstm else None)


def rnn_bwd_plain(mode, px, ys, hprev, cprev, cs, wh, dys, dhT, dcT,
                  reverse=False, dpx_fed=None):
    """(dpx, dh0, dc0, dwh) as K4b computes them, walking time opposite to
    the forward: dh and dc carried in float32, dpre rounded to the dtype
    before dh_{t-1} = dpre @ wh and dWh += dpre.T @ h_{t-1} (float32).
    px, cprev, cs and dcT are read for lstm only, ys for the simple modes
    only; dc0 is None outside lstm.

    `dpx_fed` (a kernel's dpx, its rounded dpre) stands in for this
    version's rounded dpre in dh_{t-1} and dWh, as `ys_fed` does in the
    forward: each step is held to the kernel's own previous outputs."""
    T, N, H = hprev.shape
    dt = hprev.dtype
    G = _GATES[mode]
    w = wh.float()
    lstm = mode == "lstm"
    dh = dhT.float()
    dc = dcT.float() if lstm else None
    dpx = torch.empty((T, N, G * H), dtype=dt, device=hprev.device)
    dwh = torch.zeros((G * H, H), dtype=torch.float32, device=hprev.device)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        hp = hprev[t].float()
        dh = dh + dys[t].float()
        if lstm:
            ig, fg, gg, og = _gates_lstm(px[t].float() + hp @ w.t())
            tc = torch.tanh(cs[t].float())
            do = dh * tc
            dc = dc + dh * og * (1.0 - tc * tc)
            dpre = torch.cat([dc * gg * ig * (1.0 - ig),
                              dc * cprev[t].float() * fg * (1.0 - fg),
                              dc * ig * (1.0 - gg * gg),
                              do * og * (1.0 - og)], dim=-1)
            dc = dc * fg
        elif mode == "rnn_relu":
            dpre = torch.where(ys[t] > 0, dh, torch.zeros_like(dh))
        else:
            y = ys[t].float()
            dpre = dh * (1.0 - y * y)
        dr = dpre.to(dt)
        dpx[t] = dr
        if dpx_fed is not None:
            dr = dpx_fed[t]
        dh = dr.float() @ w
        dwh += dr.float().t() @ hp
    return dpx, dh.to(dt), (dc.to(dt) if lstm else None), dwh


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _checked(what, mode, wh, seq, **tensors):
    """(the `_cuda` module, the kernels' library, T, N, H) after the checks
    every launch needs: each tensor on the CUDA device of `seq`, of the
    gate's dtype, contiguous and of its shape (px and dpx [T, N, G*H],
    h0, c0, dhT and dcT [N, H], the other sequences [T, N, H]); raises
    naming the condition broken."""
    if seq.device.type != "cuda":
        raise MXNetError("%s: no kernel for device %s" % (what, seq.device))
    if seq.dim() != 3 or wh.dim() != 2:
        raise MXNetError("%s: sequences must be [T, N, *] and wh [G*H, H], "
                         "got %s and %s" % (what, tuple(seq.shape),
                                            tuple(wh.shape)))
    T, N, H = seq.shape[0], seq.shape[1], wh.shape[1]
    tensors = dict(tensors, wh=wh)
    limit = fused_rnn_limit(mode, T, N, H,
                            *(t.dtype for t in tensors.values()))
    if limit is not None:
        raise MXNetError("%s: %s" % (what, limit))
    GH = _GATES[mode] * H
    for name, t in tensors.items():
        shape = {"px": (T, N, GH), "wh": (GH, H), "h0": (N, H),
                 "c0": (N, H), "dhT": (N, H), "dcT": (N, H)}.get(
                     name, (T, N, H))
        if tuple(t.shape) != shape:
            raise MXNetError("%s: %s is %s, expected %s"
                             % (what, name, tuple(t.shape), shape))
        if t.device != seq.device:
            raise MXNetError("%s: %s is on %s, expected %s"
                             % (what, name, t.device, seq.device))
        if not t.is_contiguous():
            raise MXNetError("%s: %s must be contiguous" % (what, name))
    from . import _cuda
    return _cuda, _cuda.library("fused_rnn.cu"), T, N, H


#: devices whose tensors take the plain versions: the CPU, and "meta",
#: on which a Symbol infers shapes without data
_PLAIN_DEVICES = ("cpu", "meta")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def rnn_fwd(mode, px, h0, c0, wh, reverse=False):
    """K4a: (ys, cs, hT, cT) as `rnn_fwd_plain`. CUDA tensors launch the
    kernel (counted in `rnn_fwd.launches`) or raise; CPU tensors take
    `rnn_fwd_plain`, and so do "meta" ones (a Symbol's shape inference,
    which computes no values)."""
    if px.device.type in _PLAIN_DEVICES:
        return rnn_fwd_plain(mode, px, h0, c0, wh, reverse)
    what = "fused_rnn forward"
    lstm = mode == "lstm"
    states = dict(h0=h0, c0=c0) if lstm else dict(h0=h0)
    _cuda, lib, T, N, H = _checked(what, mode, wh, px, px=px, **states)
    ys = torch.empty((T, N, H), dtype=px.dtype, device=px.device)
    hT = torch.empty((N, H), dtype=px.dtype, device=px.device)
    cs = torch.empty_like(ys) if lstm else None
    cT = torch.empty_like(hT) if lstm else None
    with torch.cuda.device(px.device):
        d = rnn_design(mode, N, H, px.dtype)
        err = lib.mxtt_rnn_fwd(
            _DTYPE_CODE[px.dtype], _MODE_CODE[mode], px.data_ptr(),
            h0.data_ptr(), _ptr(c0) if lstm else None, wh.data_ptr(),
            ys.data_ptr(), _ptr(cs), hT.data_ptr(), _ptr(cT), T, N, H,
            d.rows, d.P, int(bool(reverse)), _stream(px.device))
    _cuda.check(lib, err, "fused_rnn forward kernel launch (%s design)"
                % d.name)
    rnn_fwd.launches += 1
    rnn_fwd.design_launches[d.name] += 1
    return ys, cs, hT, cT


def rnn_bwd(mode, px, ys, hprev, cprev, cs, wh, dys, dhT, dcT,
            reverse=False):
    """K4b: (dpx, dh0, dc0, dwh) as `rnn_bwd_plain`. CUDA tensors launch
    the scan kernel and the dWh kernel (counted once, in
    `rnn_bwd.launches`) or raise; CPU and "meta" tensors take
    `rnn_bwd_plain`."""
    if hprev.device.type in _PLAIN_DEVICES:
        return rnn_bwd_plain(mode, px, ys, hprev, cprev, cs, wh, dys, dhT,
                             dcT, reverse)
    what = "fused_rnn backward"
    lstm = mode == "lstm"
    seqs = dict(hprev=hprev, dys=dys, dhT=dhT)
    seqs.update(dict(px=px, cprev=cprev, cs=cs, dcT=dcT) if lstm
                else dict(ys=ys))
    _cuda, lib, T, N, H = _checked(what, mode, wh, hprev, **seqs)
    GH = _GATES[mode] * H
    dev, dt = hprev.device, hprev.dtype
    dpx = torch.empty((T, N, GH), dtype=dt, device=dev)
    dh0 = torch.empty((N, H), dtype=dt, device=dev)
    dc0 = torch.empty_like(dh0) if lstm else None
    dwh = torch.empty((GH, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        d = rnn_design(mode, N, H, dt)
        clusters = d.blocks // d.P if d.name == "cluster" else 1
        # several clusters each write their dWh rows here, then one sum
        work = (torch.empty((clusters, GH, H), dtype=torch.float32,
                            device=dev) if clusters > 1 else None)
        err = lib.mxtt_rnn_bwd(
            _DTYPE_CODE[dt], _MODE_CODE[mode], _ptr(px) if lstm else None,
            None if lstm else ys.data_ptr(), hprev.data_ptr(),
            _ptr(cprev) if lstm else None, _ptr(cs) if lstm else None,
            wh.data_ptr(), dys.data_ptr(), dhT.data_ptr(),
            _ptr(dcT) if lstm else None, dpx.data_ptr(), dh0.data_ptr(),
            _ptr(dc0), dwh.data_ptr(), _ptr(work), T, N, H, d.rows, d.P,
            int(bool(reverse)), _stream(dev))
    _cuda.check(lib, err, "fused_rnn backward kernel launch (%s design)"
                % d.name)
    rnn_bwd.launches += 1
    rnn_bwd.design_launches[d.name] += 1
    return dpx, dh0, dc0, dwh


def cluster_limit(mode, N, dtype):
    """The largest H that a layout of the cluster design fits at this batch
    (0 when none does); H + 1 takes the streaming design."""
    return max((H for H in range(1, MAX_HIDDEN + 1)
                if cluster_layouts(mode, N, H, dtype)), default=0)


def serial_floor(mode, T, N, H, dtype, device="cuda"):
    """A call that launches the cluster design's serial floor for this
    layer (csrc/fused_rnn.cu mxtt_rnn_floor: T steps of K4a's exchange and
    cluster barrier at K4a's launch, no arithmetic), for timing; counted
    nowhere. Raises where the layer takes the streaming design."""
    dev = torch.device(device)
    with torch.cuda.device(dev):
        d = rnn_design(mode, N, H, dtype)
    if d.name != "cluster":
        raise MXNetError("serial_floor: T=%d N=%d H=%d %s takes the %s "
                         "design" % (T, N, H, dtype, d.name))
    from . import _cuda
    lib = _cuda.library("fused_rnn.cu")

    def call():
        with torch.cuda.device(dev):
            err = lib.mxtt_rnn_floor(_DTYPE_CODE[dtype], _MODE_CODE[mode], T,
                                     N, H, d.rows, d.P, _stream(dev))
        _cuda.check(lib, err, "fused_rnn serial floor launch")
    return call


#: kernel launches so far (plain-version calls on the CPU do not count),
#: in all and by design
rnn_fwd.launches = 0
rnn_bwd.launches = 0
rnn_fwd.design_launches = {"cluster": 0, "stream": 0}
rnn_bwd.design_launches = {"cluster": 0, "stream": 0}
KERNELS = (rnn_fwd, rnn_bwd)


def launch_counts():
    """(K4a, K4b) launches so far."""
    return tuple(k.launches for k in KERNELS)


def design_launch_counts():
    """{design: (K4a, K4b) launches so far}."""
    return {name: tuple(k.design_launches[name] for k in KERNELS)
            for name in ("cluster", "stream")}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
        k.design_launches = dict.fromkeys(k.design_launches, 0)


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------


def _shift_prev(state0, seq, reverse):
    """The h_{t-1} / c_{t-1} stream the backward reads: the saved sequence
    shifted one step along the scan direction, the initial state at the
    entry end — [h0, ys[0..T-2]] forward, [ys[1..], h0] for a reverse
    layer (whose scan enters at t = T-1)."""
    if reverse:
        return torch.cat([seq[1:], state0[None]], dim=0)
    return torch.cat([state0[None], seq[:-1]], dim=0)


def _cotangent(g, like):
    """An output's cotangent in the activation dtype, zeros where the
    caller sent none."""
    if g is None:
        return torch.zeros_like(like)
    return g.to(like.dtype).contiguous()


class _FusedLSTM(torch.autograd.Function):
    """Forward K4a, backward K4b. Saves (px, h0, c0, wh, ys, cs), as the
    reference's custom VJP does; backward replays the gates from them."""

    @staticmethod
    def forward(ctx, px, h0, c0, wh, reverse):
        ys, cs, hT, cT = rnn_fwd("lstm", px, h0, c0, wh, reverse)
        ctx.save_for_backward(px, h0, c0, wh, ys, cs)
        ctx.reverse = reverse
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        px, h0, c0, wh, ys, cs = ctx.saved_tensors
        hprev = _shift_prev(h0, ys, ctx.reverse)
        cprev = _shift_prev(c0, cs, ctx.reverse)
        dpx, dh0, dc0, dwh = rnn_bwd(
            "lstm", px, None, hprev, cprev, cs, wh, _cotangent(dys, ys),
            _cotangent(dhT, h0), _cotangent(dcT, c0), ctx.reverse)
        return dpx, dh0, dc0, dwh.to(wh.dtype), None


class _FusedSimple(torch.autograd.Function):
    """rnn_relu / rnn_tanh: forward K4a, backward K4b (no gate recompute:
    the derivative comes from the rounded ys). Saves (h0, wh, ys)."""

    @staticmethod
    def forward(ctx, px, h0, wh, mode, reverse):
        ys, _, hT, _ = rnn_fwd(mode, px, h0, None, wh, reverse)
        ctx.save_for_backward(h0, wh, ys)
        ctx.mode, ctx.reverse = mode, reverse
        return ys, hT

    @staticmethod
    def backward(ctx, dys, dhT):
        h0, wh, ys = ctx.saved_tensors
        hprev = _shift_prev(h0, ys, ctx.reverse)
        dpx, dh0, _, dwh = rnn_bwd(
            ctx.mode, None, ys, hprev, None, None, wh, _cotangent(dys, ys),
            _cotangent(dhT, h0), None, ctx.reverse)
        return dpx, dh0, dwh.to(wh.dtype), None, None


# ---------------------------------------------------------------------------
# kernel against plain version: the card checks' inputs and limits, shared
# by chip_smoke.py and tests/test_torch_cuda.py
# ---------------------------------------------------------------------------


def check_inputs(mode, T, N, H, dtype, seed=0, device="cuda"):
    """px, h0, c0, wh and the output cotangents dys, dhT, dcT of one
    layer-direction, drawn from a seeded generator on `device`; wh at
    0.5 / sqrt(H), so the recurrence contracts and float32 differences do
    not grow over T."""
    g = torch.Generator(device=device).manual_seed(seed)
    G = _GATES[mode]

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=device)
                ).to(dtype)

    return dict(px=randn(T, N, G * H, scale=0.5),
                h0=randn(N, H, scale=0.1), c0=randn(N, H, scale=0.1),
                wh=randn(G * H, H, scale=0.5 / H ** 0.5), dys=randn(T, N, H),
                dhT=randn(N, H), dcT=randn(N, H))


#: the outputs of K4a then K4b, in the order `chain` and `fed_plain` give
OUTPUTS = ("ys", "cs", "hT", "cT", "dpx", "dh0", "dc0", "dwh")


def chain(mode, a, reverse=False):
    """K4a, then K4b on K4a's outputs as the autograd Function runs them,
    on the inputs `a` (`check_inputs`): {output name: tensor or None}."""
    lstm = mode == "lstm"
    fwd = rnn_fwd(mode, a["px"], a["h0"], a["c0"] if lstm else None,
                  a["wh"], reverse)
    hprev = _shift_prev(a["h0"], fwd[0], reverse)
    cprev = _shift_prev(a["c0"], fwd[1], reverse) if lstm else None
    bwd = rnn_bwd(mode, a["px"] if lstm else None, None if lstm else fwd[0],
                  hprev, cprev, fwd[1], a["wh"], a["dys"], a["dhT"],
                  a["dcT"] if lstm else None, reverse)
    return dict(zip(OUTPUTS, fwd + bwd))


def fed_plain(mode, a, got, reverse=False):
    """The plain versions' outputs on the inputs `a`, fed with a kernel's
    outputs `got` (as `chain` gives them: its ys to the forward, its dpx to
    the backward, the backward on its saved sequences): what the card
    holds `got` to, by name."""
    lstm = mode == "lstm"
    ys, cs = got["ys"], got["cs"]
    fwd = rnn_fwd_plain(mode, a["px"], a["h0"], a["c0"], a["wh"], reverse,
                        ys_fed=ys)
    hprev = _shift_prev(a["h0"], ys, reverse)
    cprev = _shift_prev(a["c0"], cs, reverse) if lstm else None
    bwd = rnn_bwd_plain(mode, a["px"], ys, hprev, cprev, cs, a["wh"],
                        a["dys"], a["dhT"], a["dcT"], reverse,
                        dpx_fed=got["dpx"])
    return dict(zip(OUTPUTS, fwd + bwd))


#: kernel output against the plain version fed with the kernel's own
#: previous outputs (`fed_plain`), by the output's dtype: (the relative
#: Frobenius error, the largest error over the largest |plain| value).
#: float32 (dWh in either dtype) differs by summation order only (6.5e-7
#: and 1.6e-6 at most over phase 10's cases); bfloat16 rounds at the same
#: points, and a float32 difference can move one rounding (2.0e-4 and
#: 3.1e-3 at most; fed, a moved rounding does not carry down the chain).
#: A kernel that skips one of bf16's rounding points (h before its
#: product, dpre) is 8.4e-4 to 2.7e-3 off, a zeroed, halved or flipped
#: output 0.5 or more; the bf16 limit on the largest error is two ulps of
#: the largest value (tools/rnn_tol_probe.py measures both; PERF.md).
PLAIN_TOL = {torch.float32: (1e-5, 5e-5), torch.bfloat16: (4e-4, 1.6e-2)}


def plain_error(got, want):
    """(relative Frobenius error, largest error over the largest |want|,
    largest error) of a kernel output against its plain version's; an
    all-zero `want` admits only zeros."""
    d = got.float() - want.float()
    w = want.float()
    out = []
    for num, den in ((d.norm(), w.norm()), (d.abs().max(), w.abs().max())):
        num, den = float(num), float(den)
        out.append(num / den if den > 0 else
                   (0.0 if num == 0 else float("inf")))
    return out[0], out[1], float(d.abs().max())


def plain_mismatch(got, want):
    """None when the kernel output `got` is within PLAIN_TOL of the plain
    version's `want` (by its dtype), and finite; else the errors against
    the limits."""
    fro, rel_max, _ = plain_error(got, want)
    tol_fro, tol_max = PLAIN_TOL[want.dtype]
    if fro <= tol_fro and rel_max <= tol_max:
        return None
    return ("relative Frobenius error %.3g (limit %g), largest error %.3g "
            "of the largest |plain| (limit %g)"
            % (fro, tol_fro, rel_max, tol_max))


def fused_scan_layer(mode, pxs, h0, c0, wh, reverse=False):
    """One (direction of one) RNN layer from the pre-projected inputs pxs
    [T, N, G*H]: (ys, hT, cT), the contract of the composite scan in
    ops/nn.py `_scan_layer`; differentiable in pxs, h0, c0 (lstm) and wh.
    For rnn_relu / rnn_tanh, cT is c0 carried through unchanged. A layer
    outside `fused_rnn_limit` raises, on any device."""
    T, N, _ = pxs.shape
    H = wh.shape[-1]
    dtypes = (pxs.dtype, h0.dtype, wh.dtype) + (
        (c0.dtype,) if mode == "lstm" else ())
    limit = fused_rnn_limit(mode, T, N, H, *dtypes)
    if limit is not None:
        raise MXNetError("fused_scan_layer: %s" % limit)
    pxs, h0, wh = pxs.contiguous(), h0.contiguous(), wh.contiguous()
    if mode == "lstm":
        return _FusedLSTM.apply(pxs, h0, c0.contiguous(), wh, bool(reverse))
    ys, hT = _FusedSimple.apply(pxs, h0, wh, mode, bool(reverse))
    return ys, hT, c0
