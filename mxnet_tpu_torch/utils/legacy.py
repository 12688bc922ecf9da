"""Reference-format binary checkpoints and legacy symbol JSON (port of
`mxnet_tpu/utils/legacy.py`).

MXNet's own NDArray container (`src/ndarray/ndarray.cc` Save/Load: the
list magic 0x112, then V2, V1 or V0 records) and its pre-nnvm symbol
JSON (`src/nnvm/legacy_json_util.cc`'s upgrade pass). `nd.load` detects
the binary framing and reads it here, so a `.params` file written by
MXNet or by either package's `save_legacy_ndarrays` loads in the port.

Layout (little-endian, dmlc::Stream conventions):
  file  := u64 magic=0x112, u64 reserved, vec<ndarray>, vec<string names>
  vec<T>:= u64 count, T*count; string := u64 len, bytes
  ndarray (V2, magic 0xF993FAC9 as u32):
    u32 magic, i32 stype, [storage_shape if sparse], shape, i32 dev_type,
    i32 dev_id, i32 type_flag, [i32 aux_type + aux_shape]*nad,
    raw data, raw aux data*nad
  shape := u32 ndim, i64*ndim        (V1 same; V0: magic IS ndim, u32 dims)

Dense records load (V0, V1, V2); a sparse V2 record (row_sparse or
csr) loads densified, as the reference's `_read_one` densifies it.
"""
from __future__ import annotations

import struct

import numpy as np


LIST_MAGIC = 0x112
V2_MAGIC = 0xF993FAC9
V1_MAGIC = 0xF993FAC8

# mshadow type flags (mshadow/base.h kFloat32..kInt64)
_DTYPES = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
           4: np.int32, 5: np.int8, 6: np.int64}
_FLAGS = {np.dtype(v): k for k, v in _DTYPES.items()}

# NDArrayStorageType (include/mxnet/ndarray.h:61-66); aux counts:
# row_sparse carries its row-id vector, csr its indptr and indices
_STYPE_DEFAULT, _STYPE_ROW_SPARSE, _STYPE_CSR = 0, 1, 2
_NUM_AUX = {_STYPE_DEFAULT: 0, _STYPE_ROW_SPARSE: 1, _STYPE_CSR: 2}


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def unpack_many(self, fmt):
        """A tuple of the values `fmt` describes at the cursor."""
        size = struct.calcsize("<" + fmt)
        if self.pos + size > len(self.buf):
            raise IOError("truncated legacy NDArray file")
        vals = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += size
        return vals

    def unpack(self, fmt):
        vals = self.unpack_many(fmt)
        return vals if len(vals) > 1 else vals[0]

    def raw(self, n):
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise IOError("truncated legacy NDArray file")
        self.pos += n
        return out


def _read_shape(r):
    ndim = r.unpack("I")
    return list(r.unpack_many("%dq" % ndim)) if ndim else []


def _read_array_data(r, shape, type_flag):
    if type_flag not in _DTYPES:
        raise IOError("unknown NDArray type flag %d" % type_flag)
    dt = np.dtype(_DTYPES[type_flag])
    n = int(np.prod(shape)) if shape else 1
    return np.frombuffer(r.raw(dt.itemsize * n), dtype=dt).reshape(shape)


def _read_one(r):
    """One NDArray record -> numpy array (None for an empty record)."""
    magic = r.unpack("I")
    if magic == V2_MAGIC:
        stype = r.unpack("i")
        nad = _NUM_AUX.get(stype)
        if nad is None:
            raise IOError("unknown storage type %d" % stype)
        if nad:
            return _read_sparse(r, stype, nad)
        shape = _read_shape(r)
    elif magic == V1_MAGIC:
        shape = _read_shape(r)
    else:
        # V0: the magic word is ndim and the dims are u32. A plausible ndim
        # bounds the reading: anything larger is an unknown format
        ndim = magic
        if ndim > 32:
            raise IOError("unsupported NDArray record magic %#x" % magic)
        shape = list(r.unpack_many("%dI" % ndim)) if ndim else []
    if not shape:
        return None
    r.unpack("ii")  # context (dev_type, dev_id): placement is the caller's
    type_flag = r.unpack("i")
    return _read_array_data(r, shape, type_flag)


def _read_sparse(r, stype, nad):
    """The rest of a sparse V2 record, densified (None when empty)."""
    sshape = _read_shape(r)
    shape = _read_shape(r)
    if not shape:
        return None
    r.unpack("ii")  # context
    type_flag = r.unpack("i")
    aux = [(r.unpack("i"), _read_shape(r)) for _ in range(nad)]
    data = _read_array_data(r, sshape, type_flag)
    aux_data = [_read_array_data(r, ash, at) for at, ash in aux]
    dense = np.zeros(shape, data.dtype)
    if stype == _STYPE_ROW_SPARSE:
        dense[aux_data[0].astype(np.int64)] = data
        return dense
    indptr = aux_data[0].astype(np.int64)
    indices = aux_data[1].astype(np.int64)
    for row in range(shape[0]):
        lo, hi = indptr[row], indptr[row + 1]
        dense[row, indices[lo:hi]] = data[lo:hi]
    return dense


def is_legacy_ndarray_file(src):
    """True when `src` (a path or the file's bytes) starts with the
    reference's list magic."""
    if isinstance(src, (bytes, bytearray)):
        head = bytes(src[:8])
    else:
        try:
            with open(src, "rb") as f:
                head = f.read(8)
        except OSError:
            return False
    return len(head) == 8 and struct.unpack("<Q", head)[0] == LIST_MAGIC


def load_legacy_ndarrays(src, ctx=None):
    """A reference `.params` file (a path or its bytes) -> {name: NDArray}
    on `ctx` (the current context by default), or a list when the file
    carries no names."""
    from ..ndarray import NDArray
    if isinstance(src, (bytes, bytearray)):
        r = _Reader(bytes(src))
    else:
        with open(src, "rb") as f:
            r = _Reader(f.read())
    header, _reserved = r.unpack("QQ")
    if header != LIST_MAGIC:
        raise IOError("not a legacy NDArray file (magic %#x)" % header)
    n = r.unpack("Q")
    arrays = [_read_one(r) for _ in range(n)]
    n_names = r.unpack("Q")
    names = [r.raw(r.unpack("Q")).decode() for _ in range(n_names)]
    if names and len(names) != len(arrays):
        raise IOError("invalid legacy NDArray file: %d names for %d arrays"
                      % (len(names), len(arrays)))
    wrapped = [None if a is None else NDArray(a, ctx=ctx) for a in arrays]
    if not names:
        return wrapped
    return dict(zip(names, wrapped))


def _write_shape(out, shape):
    out.append(struct.pack("<I", len(shape)))
    if shape:
        out.append(struct.pack("<%dq" % len(shape), *shape))


def save_legacy_ndarrays(fname, data):
    """Write an NDArray, a list or a {name: NDArray} dict in the
    reference's V2 container (dense records; bfloat16, which has no
    type flag, widens to float32)."""
    from ..ndarray import NDArray
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names, arrays = [], list(data)
    out = [struct.pack("<QQ", LIST_MAGIC, 0), struct.pack("<Q", len(arrays))]
    for a in arrays:
        npd = np.asarray(a.asnumpy() if hasattr(a, "asnumpy") else a)
        if npd.dtype not in _FLAGS:
            npd = npd.astype(np.float32)
        out.append(struct.pack("<Ii", V2_MAGIC, _STYPE_DEFAULT))
        _write_shape(out, npd.shape)
        out.append(struct.pack("<iii", 1, 0, _FLAGS[npd.dtype]))  # cpu(0)
        out.append(np.ascontiguousarray(npd).tobytes())
    out.append(struct.pack("<Q", len(names)))
    for nm in names:
        b = nm.encode()
        out.append(struct.pack("<Q", len(b)) + b)
    with open(fname, "wb") as f:
        f.write(b"".join(out))


# ---------------------------------------------------------------------------
# legacy symbol JSON
# ---------------------------------------------------------------------------


def upgrade_json(data):
    """A reference symbol-JSON dict in the current layout: op parameters
    under 'attrs', node attributes under 'attr', 3-element inputs and
    heads (parity: legacy_json_util.cc).

    The oldest files keep op parameters in 'param' and node attributes
    (ctx_group, lr_mult, ...) in 'attr'; a later era mixes both in 'attr';
    current files use 'attrs'. 'param' wins where present, so a node
    attribute never passes for an op argument; the loader also moves any
    argument the op does not take to the node's attributes."""
    nodes = []
    for spec in data["nodes"]:
        spec = dict(spec)
        attrs = spec.pop("param", None)
        node_attr = {}
        if attrs is not None:
            node_attr = dict(spec.pop("attr", None) or {})
        if attrs is None:
            attrs = spec.pop("attrs", None)
        if attrs is None:
            attrs = spec.pop("attr", None) or {}
        spec.pop("attrs", None)
        spec.pop("attr", None)
        spec["attrs"] = dict(attrs)
        spec["attr"] = node_attr
        spec["inputs"] = [list(i) + [0] * (3 - len(i))
                          for i in spec.get("inputs", [])]
        nodes.append(spec)
    heads = [list(h) + [0] * (3 - len(h)) for h in data["heads"]]
    return {"nodes": nodes, "heads": heads,
            "arg_nodes": data.get("arg_nodes", [])}
