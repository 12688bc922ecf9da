"""Port parity for the small modules of the deployment slice against the
JAX package on the CPU, mirroring tests/test_misc.py:120-144: `log`
(get_logger), `libinfo` (the version, find_lib_path), `misc` (the
deprecated FactorScheduler), `engine` (the engine type, NaiveEngine,
wait_all, bulk scopes), the kvstore server shim and the `torch`
converters. Values compare exactly: none of these computes in floating
point beyond the scheduler's power, which both take from math.pow.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.engine as ref_engine
import mxnet_tpu.libinfo as ref_libinfo
import mxnet_tpu.log as ref_log
import mxnet_tpu.misc as ref_misc
import mxnet_tpu.torch as ref_torch

import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.engine as engine
import mxnet_tpu_torch.libinfo as libinfo
import mxnet_tpu_torch.log as log
import mxnet_tpu_torch.misc as misc
import mxnet_tpu_torch.torch as mxt


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def test_get_logger_matches_reference(tmp_path):
    lg = log.get_logger("mxtest_port", level=logging.INFO)
    lg.info("hello")  # must not raise
    assert log.get_logger("mxtest_port") is lg
    assert lg.level == logging.INFO
    assert log.getLogger is log.get_logger
    # a file logger writes the reference's plain (uncolored) format
    lines = []
    for mod, name in ((ref_log, "ref"), (log, "port")):
        path = tmp_path / ("%s.log" % name)
        lgr = mod.get_logger("mxfile_" + name, filename=str(path),
                             level=logging.WARNING)
        lgr.warning("same line")
        for h in lgr.handlers:
            h.flush()
        lines.append(path.read_text().split(" ", 2)[2])
    assert lines[0] == lines[1] == "same line\n"


def test_libinfo_version_and_libraries():
    assert libinfo.__version__ == ref_libinfo.__version__
    assert tmx.__version__ == libinfo.__version__
    paths = libinfo.find_lib_path()
    assert all(p.endswith(".so") and "_build" in p for p in paths)


def test_libinfo_finds_built_libraries(tmp_path, monkeypatch):
    """find_lib_path lists what the kernel builds leave in _build/."""
    import os
    fake = tmp_path / "mxnet_tpu_torch"
    (fake / "_build").mkdir(parents=True)
    (fake / "_build" / "fused_rnn-abc.so").write_bytes(b"")
    (fake / "_build" / "fused_rnn-abc.log").write_text("")
    monkeypatch.setattr(libinfo, "__file__", str(fake / "libinfo.py"))
    assert libinfo.find_lib_path() == [
        os.path.join(str(fake), "_build", "fused_rnn-abc.so")]


@pytest.mark.parametrize("step,factor", [(1, 0.5), (3, 0.1), (10, 0.9)])
def test_factor_scheduler_matches_reference(step, factor):
    ref, port = ref_misc.FactorScheduler(step, factor), \
        misc.FactorScheduler(step, factor)
    ref.base_lr = port.base_lr = 0.2
    assert [port(i) for i in range(30)] == [ref(i) for i in range(30)]


@pytest.mark.parametrize("step,factor", [(0, 0.5), (1, 1.0)])
def test_factor_scheduler_rejects_what_reference_rejects(step, factor):
    with pytest.raises(ValueError):
        ref_misc.FactorScheduler(step, factor)
    with pytest.raises(ValueError):
        misc.FactorScheduler(step, factor)


def test_engine_type(monkeypatch):
    monkeypatch.delenv("MXNET_ENGINE_TYPE", raising=False)
    assert engine.current_engine_type() == "CUDAAsync"
    assert ref_engine.current_engine_type() == "XLAAsync"
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert engine.current_engine_type() == \
        ref_engine.current_engine_type() == "NaiveEngine"


def test_naive_engine_synchronizes_every_op(monkeypatch):
    """With NaiveEngine every op the registry invokes synchronises its
    outputs' device; by default none does."""
    calls = []
    monkeypatch.setattr(engine, "sync_outputs",
                        lambda res: calls.append(res) or res)
    a = tmx.nd.array(np.ones(3, np.float32))
    (a + a).asnumpy()
    assert calls == []
    monkeypatch.setattr(engine, "NAIVE", True)
    b = tmx.nd.exp(a)
    assert len(calls) == 1 and calls[0] is b._data
    np.testing.assert_array_equal(b.asnumpy(),
                                  mx.nd.exp(mx.nd.array(np.ones(3))).asnumpy())


def test_wait_all_and_bulk():
    engine.wait_all()
    tmx.nd.waitall()
    if not torch.cuda.is_available():
        assert engine.used_devices() == []
    with engine.bulk(8):
        x = tmx.nd.ones((2, 2)) * 3
    assert engine.set_bulk_size(16) == ref_engine.set_bulk_size(16) == 16
    np.testing.assert_array_equal(x.asnumpy(), np.full((2, 2), 3.0))


def test_kvstore_server_shim():
    import mxnet_tpu_torch.kvstore_server as kvs_srv
    kvs_srv._init_kvstore_server_module()  # worker role: no-op


def test_torch_converters_match_reference():
    src = np.array([1.0, 2.0], np.float32)
    ref_t = ref_torch.to_torch(mx.nd.array(src))
    arr = tmx.nd.array(src)
    t = mxt.to_torch(arr)
    assert t.shape == ref_t.shape == (2,)
    np.testing.assert_array_equal(t.numpy(), ref_t.numpy())
    # the port keeps the array's memory (the reference copies via host)
    assert t.data_ptr() == arr._data.data_ptr()
    back = mxt.from_torch(t * 2)
    np.testing.assert_allclose(back.asnumpy(), [2.0, 4.0])
    assert back.context == tmx.cpu()
    assert mxt.TorchBlock is tmx.plugin.TorchBlock
