"""Port parity for MXNet's own checkpoint formats (mxnet_tpu_torch.utils.
legacy, `nd.load`, `sym.load_json`) against the JAX reference on the CPU.

A `.params` file in MXNet's binary container (V2 records from the
reference's `save_legacy_ndarrays`, V0 and V1 records packed here from
the documented layout, as the reference's own tests pack them) loads
through `mxnet_tpu_torch.nd.load` equal to `mxnet_tpu.nd.load`; pre-nnvm
symbol JSON (2-element inputs, op parameters under `param`, a BatchNorm
without aux inputs) loads with the reference's arguments and aux
states.

Tolerances: arrays, names, bytes and JSON-derived lists exact; the loaded
BatchNorm graph's outputs 1e-5.
"""
import json
import struct

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu.utils import legacy as ref_legacy

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.utils import legacy


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _pack_shape(shape, fmt="q"):
    return struct.pack("<I", len(shape)) + \
        struct.pack("<%d%s" % (len(shape), fmt), *shape)


def _pack_file(records, names):
    out = struct.pack("<QQ", legacy.LIST_MAGIC, 0)
    out += struct.pack("<Q", len(records)) + b"".join(records)
    out += struct.pack("<Q", len(names))
    for n in names:
        out += struct.pack("<Q", len(n)) + n.encode()
    return out


def _v1(arr):
    return (struct.pack("<I", legacy.V1_MAGIC) + _pack_shape(arr.shape)
            + struct.pack("<iii", 1, 0, legacy._FLAGS[arr.dtype])
            + arr.tobytes())


def _v0(arr):
    # V0: the leading u32 is ndim and the dims are u32
    return (struct.pack("<I", arr.ndim)
            + struct.pack("<%dI" % arr.ndim, *arr.shape)
            + struct.pack("<iii", 1, 0, legacy._FLAGS[arr.dtype])
            + arr.tobytes())


def _both_load(path):
    ref = mx.nd.load(path)
    port = tmx.nd.load(path)
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        keys = sorted(ref)
    else:
        assert isinstance(port, list) and len(port) == len(ref)
        keys = range(len(ref))
    for k in keys:
        want = np.asarray(ref[k].asnumpy())
        got = port[k].asnumpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want)
    return port


def test_reference_written_params_load(tmp_path):
    """{'arg:w': [[0,1,2],[3,4,5]]} from the reference's writer."""
    path = str(tmp_path / "w.params")
    ref_legacy.save_legacy_ndarrays(
        path, {"arg:w": mx.nd.array(np.arange(6, dtype=np.float32)
                                    .reshape(2, 3))})
    got = _both_load(path)
    np.testing.assert_array_equal(got["arg:w"].asnumpy(),
                                  [[0, 1, 2], [3, 4, 5]])
    assert got["arg:w"].context == tmx.cpu()


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "uint8",
                                   "int32", "int8", "int64"])
def test_v2_records_by_dtype(tmp_path, dtype):
    rng = np.random.RandomState(0)
    arr = (rng.rand(3, 4, 2) * 100).astype(dtype)
    path = str(tmp_path / "d.params")
    ref_legacy.save_legacy_ndarrays(path, {"arg:a": mx.nd.array(arr),
                                           "aux:b": mx.nd.array(arr[0])})
    _both_load(path)


@pytest.mark.parametrize("record", ["v0", "v1", "v2"])
def test_v0_v1_v2_records(tmp_path, record):
    rng = np.random.RandomState(1)
    arrays = [rng.randn(2, 3).astype(np.float32),
              rng.randint(0, 9, (4,)).astype(np.int32)]
    path = tmp_path / ("%s.params" % record)
    if record == "v2":
        ref_legacy.save_legacy_ndarrays(
            str(path), [mx.nd.array(a) for a in arrays])
    else:
        pack = _v0 if record == "v0" else _v1
        path.write_bytes(_pack_file([pack(a) for a in arrays], []))
    got = _both_load(str(path))
    assert isinstance(got, list)
    for g, a in zip(got, arrays):
        np.testing.assert_array_equal(g.asnumpy(), a)


def test_load_from_bytes_and_onto_a_context(tmp_path):
    path = str(tmp_path / "b.params")
    ref_legacy.save_legacy_ndarrays(path, {"x": mx.nd.ones((2, 2))})
    with open(path, "rb") as f:
        raw = f.read()
    got = tmx.nd.load_frombuffer(raw)
    np.testing.assert_array_equal(got["x"].asnumpy(), np.ones((2, 2)))
    assert legacy.is_legacy_ndarray_file(raw)
    assert legacy.is_legacy_ndarray_file(path)
    assert not legacy.is_legacy_ndarray_file(str(tmp_path / "missing"))
    npz = str(tmp_path / "n.params")
    tmx.nd.save(npz, {"x": tmx.nd.ones((2,))})
    assert not legacy.is_legacy_ndarray_file(npz)


def _rsp_record(vals, idx, shape):
    rec = struct.pack("<Ii", legacy.V2_MAGIC, 1)
    rec += _pack_shape(vals.shape) + _pack_shape(shape)
    rec += struct.pack("<iii", 1, 0, legacy._FLAGS[vals.dtype])
    rec += struct.pack("<i", 6) + _pack_shape(idx.shape)
    return rec + vals.tobytes() + idx.tobytes()


def _csr_record(vals, indptr, indices, shape):
    rec = struct.pack("<Ii", legacy.V2_MAGIC, 2)
    rec += _pack_shape(vals.shape) + _pack_shape(shape)
    rec += struct.pack("<iii", 1, 0, legacy._FLAGS[vals.dtype])
    rec += struct.pack("<i", 6) + _pack_shape(indptr.shape)
    rec += struct.pack("<i", 6) + _pack_shape(indices.shape)
    return rec + vals.tobytes() + indptr.tobytes() + indices.tobytes()


def test_row_sparse_record_raises_not_ported(tmp_path):
    """A row_sparse record loads densified, as the reference's (its
    tests/test_legacy.py). (The name is kept from before sparse arrays,
    when the port raised.)"""
    vals = np.array([[1, 2, 3], [4, 5, 6]], np.float32)
    idx = np.array([0, 4], np.int64)
    path = tmp_path / "rsp.params"
    path.write_bytes(_pack_file([_rsp_record(vals, idx, (5, 3))], ["w"]))
    want = mx.nd.load(str(path))["w"].asnumpy()
    got = tmx.nd.load(str(path))["w"]
    assert got.shape == (5, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got.asnumpy(), want)
    np.testing.assert_array_equal(got.asnumpy()[[0, 4]], vals)


def test_sparse_records_load_densified(tmp_path):
    """A file of row_sparse, csr (with an empty row) and dense records:
    every array equal to the reference's load, in order."""
    rng = np.random.RandomState(4)
    dense = rng.rand(4, 6).astype(np.float32)
    dense[rng.rand(4, 6) > 0.4] = 0
    dense[2] = 0
    indptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))])
    indices = np.nonzero(dense)[1].astype(np.int64)
    recs = [_csr_record(dense[dense != 0], indptr.astype(np.int64), indices,
                        dense.shape),
            _rsp_record(rng.randn(3, 2).astype(np.float64),
                        np.array([1, 2, 6], np.int64), (7, 2)),
            _v1(np.arange(6, dtype=np.int32).reshape(2, 3))]
    path = tmp_path / "mixed.params"
    path.write_bytes(_pack_file(recs, ["c", "r", "d"]))
    want = mx.nd.load(str(path))
    got = tmx.nd.load(str(path))
    assert list(got) == list(want) == ["c", "r", "d"]
    for k in want:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())
        assert got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(got["c"].asnumpy(), dense)


def test_truncated_file_raises(tmp_path):
    path = str(tmp_path / "t.params")
    ref_legacy.save_legacy_ndarrays(path, {"x": mx.nd.ones((4, 4))})
    with open(path, "rb") as f:
        raw = f.read()
    with pytest.raises(IOError, match="truncated"):
        tmx.nd.load_frombuffer(raw[:-9])


def test_port_writer_matches_reference_bytes(tmp_path):
    rng = np.random.RandomState(2)
    data = {"arg:a": rng.randn(3, 5).astype(np.float32),
            "arg:b": np.arange(4, dtype=np.int32),
            "aux:c": rng.randn(7).astype(np.float32)}
    ref_path, port_path = str(tmp_path / "r.params"), \
        str(tmp_path / "p.params")
    ref_legacy.save_legacy_ndarrays(
        ref_path, {k: mx.nd.array(v) for k, v in data.items()})
    legacy.save_legacy_ndarrays(
        port_path, {k: tmx.nd.array(v) for k, v in data.items()})
    with open(ref_path, "rb") as f, open(port_path, "rb") as g:
        assert f.read() == g.read()
    back = mx.nd.load(port_path)
    for k, v in data.items():
        np.testing.assert_array_equal(back[k].asnumpy(), v)
    # bfloat16 has no type flag: it widens to float32, exactly
    bf = tmx.nd.array(np.array([1.5, -2.25], np.float32)).astype("bfloat16")
    legacy.save_legacy_ndarrays(port_path, [bf])
    np.testing.assert_array_equal(mx.nd.load(port_path)[0].asnumpy(),
                                  [1.5, -2.25])


#: pre-nnvm JSON: 2-element inputs, op parameters under `param`, node
#: attributes under `attr`, a BatchNorm with no aux inputs
_LEGACY_GRAPH = {
    "nodes": [
        {"op": "null", "name": "data", "param": {}, "inputs": [],
         "attr": {"ctx_group": "stage1"}},
        {"op": "null", "name": "bn_gamma", "param": {}, "inputs": []},
        {"op": "null", "name": "bn_beta", "param": {}, "inputs": []},
        {"op": "BatchNorm", "name": "bn",
         "param": {"eps": "0.001", "fix_gamma": "False"},
         "attr": {"lr_mult": "0.5"},
         "inputs": [[0, 0], [1, 0], [2, 0]]},
        {"op": "null", "name": "fc_weight", "param": {}, "inputs": []},
        {"op": "null", "name": "fc_bias", "param": {}, "inputs": []},
        {"op": "FullyConnected", "name": "fc",
         "param": {"num_hidden": "4", "no_bias": "False"},
         "inputs": [[3, 0], [4, 0], [5, 0]]},
        {"op": "Activation", "name": "act", "param": {"act_type": "relu"},
         "inputs": [[6, 0]]},
    ],
    "arg_nodes": [0, 1, 2, 4, 5],
    "heads": [[7, 0]],
}


def test_legacy_json_arguments_and_aux():
    text = json.dumps(_LEGACY_GRAPH)
    ref = mx.sym.load_json(text)
    port = tmx.sym.load_json(text)
    assert port.list_arguments() == ref.list_arguments() == [
        "data", "bn_gamma", "bn_beta", "fc_weight", "fc_bias"]
    assert port.list_auxiliary_states() == ref.list_auxiliary_states() == [
        "bn_moving_mean", "bn_moving_var"]
    assert port.list_outputs() == ref.list_outputs()
    assert port.attr_dict()["data"]["ctx_group"] == "stage1"
    assert str(port.attr_dict()["bn"]["lr_mult"]) == "0.5"
    assert port.infer_shape(data=(3, 6)) == ref.infer_shape(data=(3, 6))


def test_legacy_graph_runs_like_reference():
    text = json.dumps(_LEGACY_GRAPH)
    ref = mx.sym.load_json(text)
    port = tmx.sym.load_json(text)
    rng = np.random.RandomState(0)
    args, _, aux = ref.infer_shape(data=(3, 6))
    values = {n: rng.randn(*s).astype(np.float32)
              for n, s in zip(ref.list_arguments(), args)}
    auxs = {"bn_moving_mean": rng.randn(6).astype(np.float32),
            "bn_moving_var": (rng.rand(6) + 0.5).astype(np.float32)}
    with mx.random.trace_key_scope(jax.random.PRNGKey(0)):
        ex = ref.bind(mx.cpu(), {n: mx.nd.array(v)
                                 for n, v in values.items()},
                      aux_states={n: mx.nd.array(v)
                                  for n, v in auxs.items()})
        want = ex.forward(is_train=False)[0].asnumpy()
    tex = port.bind(tmx.cpu(), {n: tmx.nd.array(v)
                                for n, v in values.items()},
                    aux_states={n: tmx.nd.array(v) for n, v in auxs.items()})
    got = tex.forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_legacy_checkpoint_through_load_checkpoint(tmp_path):
    """A reference-style checkpoint (binary params + pre-nnvm JSON) loads
    through model.load_checkpoint and Module, as the reference's does."""
    (tmp_path / "m-symbol.json").write_text(json.dumps(_LEGACY_GRAPH))
    rng = np.random.RandomState(3)
    params = {"arg:bn_gamma": rng.rand(6), "arg:bn_beta": rng.randn(6),
              "arg:fc_weight": rng.randn(4, 6), "arg:fc_bias": rng.randn(4),
              "aux:bn_moving_mean": rng.randn(6),
              "aux:bn_moving_var": rng.rand(6) + 0.5}
    ref_legacy.save_legacy_ndarrays(
        str(tmp_path / "m-0002.params"),
        {k: mx.nd.array(v.astype(np.float32)) for k, v in params.items()})
    prefix = str(tmp_path / "m")
    _, ref_args, ref_aux = mx.model.load_checkpoint(prefix, 2)
    sym, args, aux = tmx.model.load_checkpoint(prefix, 2)
    assert sorted(args) == sorted(ref_args)
    assert sorted(aux) == sorted(ref_aux)
    mod = tmx.mod.Module(sym, label_names=None, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (2, 6))], for_training=False)
    mod.set_params(args, aux)
    x = rng.randn(2, 6).astype(np.float32)
    mod.forward(tmx.io.DataBatch([tmx.nd.array(x)]), is_train=False)
    got = mod.get_outputs()[0]._data
    norm = (x - params["aux:bn_moving_mean"]) / np.sqrt(
        params["aux:bn_moving_var"] + 1e-3)
    hidden = norm * params["arg:bn_gamma"] + params["arg:bn_beta"]
    want = np.maximum(hidden @ params["arg:fc_weight"].T
                      + params["arg:fc_bias"], 0)
    torch.testing.assert_close(got, torch.from_numpy(want.astype(
        np.float32)), rtol=1e-5, atol=1e-5)


def test_init_load_reads_a_legacy_file(tmp_path):
    """init.Load takes a file nd.load reads, MXNet's binary format
    included."""
    path = str(tmp_path / "w.params")
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    ref_legacy.save_legacy_ndarrays(path, {"arg:fc_weight": mx.nd.array(w)})
    arr = tmx.nd.zeros((2, 3))
    tmx.init.Load(path)("fc_weight", arr)
    np.testing.assert_array_equal(arr.asnumpy(), w)
    with pytest.raises(ValueError, match="fc_bias"):
        tmx.init.Load(path)("fc_bias", tmx.nd.zeros((2,)))
    bias = tmx.nd.ones((2,))
    tmx.init.Load(path, default_init=tmx.init.Zero())("fc_bias", bias)
    np.testing.assert_array_equal(bias.asnumpy(), 0)
