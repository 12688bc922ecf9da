"""The port's distributed kvstore and dist LeNet, N real worker processes
under tools/launch.py (the reference's tests/test_kvstore_dist.py
pattern: `launch.py -n N --launcher local python <worker>`).

Run as a script this file is the worker (it imports no JAX):

    python tools/launch.py -n 2 --launcher local \\
        python tests/test_torch_dist_kvstore.py --check kvstore --device cpu

`--check kvstore` runs the flows of the reference's worker,
tests/dist_sync_kvstore.py (dense keys, one crossing
MXNET_KVSTORE_BIGARRAY_BOUND so its sum is chunked, 2-bit compression,
the server-side optimizer, the combined nightly-scale flow with a
cross-rank bit-identity digest), asserting the same globally reduced
values, plus rank 0's value winning `init`, and a row-sparse init /
push / row_sparse_pull held to the one-process sum. `--check lenet` is tests/dist_lenet.py's
data-parallel MLP on rank-partitioned synthetic MNIST through
`gluon.Trainer(kvstore=dist_sync)` (with `--compress`, 2-bit compression
at threshold 0.005: each send moves a weight by at most lr x 0.005, a
step this MLP's Xavier weights take in stride, where 0.05 makes it
diverge and 0.001 starves it): the loss must halve and every rank must
hold bit-identical parameters.
Each worker prints one OK line per rank, which the tests count.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.abspath(__file__)


def _nd(mx, a, ctx):
    return mx.nd.array(np.asarray(a, np.float32), ctx=ctx)


def check_dense(mx, kv, rank, nworker, ctx):
    shapes = {"3": (50, 50), "99": (4, 4), "big": (1200, 7)}
    for k, shape in shapes.items():
        kv.init(k, _nd(mx, np.zeros(shape), ctx))
    for it in range(3):
        for k, shape in shapes.items():
            kv.push(k, _nd(mx, np.ones(shape) * (rank + 1), ctx))
            out = _nd(mx, np.zeros(shape), ctx)
            kv.pull(k, out=out)
            expected = sum(r + 1 for r in range(nworker)) * (it + 1)
            np.testing.assert_allclose(out.asnumpy(),
                                       np.full(shape, expected), rtol=1e-5)
        kv.barrier()
    # rank 0's value wins init
    kv.init("first", _nd(mx, np.full((3,), rank + 7.0), ctx))
    out = _nd(mx, np.zeros(3), ctx)
    kv.pull("first", out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full(3, 7.0))


def check_row_sparse_raises(mx, kv, rank, nworker, ctx):
    """Row-sparse init / push / row_sparse_pull over the world, held to
    the one-process sum: rank 0's row-sparse value wins init; each rank
    pushes rows of its own (some shared, one summing to zero across the
    ranks, which drops out); the store holds the sum of every rank's
    rows, the same bits on every rank. (The name is kept from before
    sparse arrays, when the pull raised.)"""
    import torch
    from mxnet_tpu_torch.ndarray import sparse
    shape = (40, 3)
    rs = np.random.RandomState(7)
    rows = [np.sort(rs.choice(np.arange(1, 40), 6, replace=False))
            for _ in range(nworker)]
    vals = [rs.randn(6, 3).astype(np.float32) for _ in range(nworker)]
    rows[0][0] = rows[-1][0] = 0
    vals[-1][0] = -vals[0][0]  # row 0 sums to zero over the ranks
    init = sparse.RowSparseNDArray(rows[rank], vals[rank] * (rank + 1),
                                   shape, ctx=ctx)
    kv.init("rsp_init", init)
    got = kv.row_sparse_pull("rsp_init", row_ids=_nd(mx, np.arange(40), ctx))
    np.testing.assert_array_equal(got.indices.asnumpy(),
                                  np.arange(40))
    want = np.zeros(shape, np.float32)
    want[rows[0]] = vals[0]
    np.testing.assert_array_equal(got.asnumpy(), want)
    kv.init("rsp_w", _nd(mx, np.zeros(shape), ctx))
    kv.push("rsp_w", sparse.RowSparseNDArray(rows[rank], vals[rank], shape,
                                         ctx=ctx))
    local = sparse.merge_rowsparse([
        sparse.RowSparseNDArray(r, v, shape, ctx=mx.cpu())
        for r, v in zip(rows, vals)]).asnumpy()
    out = _nd(mx, np.zeros(shape), ctx)
    kv.pull("rsp_w", out=out)
    np.testing.assert_allclose(out.asnumpy(), local, rtol=1e-6, atol=1e-7)
    assert not out.asnumpy()[rows[0][0]].any()
    pulled = sparse.zeros("row_sparse", shape, ctx=ctx)
    ids = np.array([rows[0][1], rows[-1][2], 39])
    kv.row_sparse_pull("rsp_w", out=pulled, row_ids=_nd(mx, ids, ctx))
    np.testing.assert_array_equal(pulled.asnumpy()[ids], out.asnumpy()[ids])
    # the sum is the same bits on every rank
    from mxnet_tpu_torch.parallel.collectives import _Axis, all_gather_raw
    every = all_gather_raw(out._data[None], _Axis(kv._mesh, "world"), 0)
    for r in range(1, nworker):
        assert torch.equal(every[r], every[0]), r
    kv.barrier()


def check_compressed(mx, kv, rank, nworker, ctx):
    shape = (6, 6)
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("comp", _nd(mx, np.zeros(shape), ctx))
    # 2.0 quantizes to +0.5 on every worker; residual 1.5 carries over
    kv.push("comp", _nd(mx, np.full(shape, 2.0), ctx))
    out = _nd(mx, np.zeros(shape), ctx)
    kv.pull("comp", out=out)
    np.testing.assert_allclose(out.asnumpy(), np.full(shape, 0.5 * nworker),
                               rtol=1e-5)
    # the carried 1.5 sends another +0.5 with a zero push
    kv.push("comp", _nd(mx, np.zeros(shape), ctx))
    kv.pull("comp", out=out)
    np.testing.assert_allclose(out.asnumpy(), np.full(shape, 1.0 * nworker),
                               rtol=1e-5)
    kv._compressor = None
    kv.barrier()


def check_server_side_optimizer(mx, kv, rank, nworker, ctx):
    shape = (8, 4)
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, wd=0.0))
    kv.init("w", _nd(mx, np.ones(shape), ctx))
    kv.push("w", _nd(mx, np.ones(shape) * (rank + 1), ctx))
    out = _nd(mx, np.zeros(shape), ctx)
    kv.pull("w", out=out)
    grad_sum = sum(r + 1 for r in range(nworker))
    np.testing.assert_allclose(out.asnumpy(),
                               np.full(shape, 1.0 - 0.1 * grad_sum),
                               rtol=1e-4)
    kv._updater = None
    kv._optimizer = None
    kv.barrier()


def check_combined(mx, kv, rank, nworker, ctx):
    """A key past the chunk bound, 2-bit compression and per-device lists
    in one push cycle, with cross-rank bit identity by a digest key."""
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    big = (3000, 3)  # 9000 elements > the 4096 bound the test sets
    kv.init("cbig", _nd(mx, np.zeros(big), ctx))
    kv.push("cbig", [_nd(mx, np.full(big, 1.0), ctx),
                     _nd(mx, np.full(big, 1.0), ctx)])
    out = _nd(mx, np.zeros(big), ctx)
    kv.pull("cbig", out=out)
    np.testing.assert_allclose(out.asnumpy(), np.full(big, 0.5 * nworker),
                               rtol=1e-6)
    kv._compressor = None
    host = out.asnumpy()
    dig = np.array([np.frombuffer(host.tobytes(), np.uint8).sum() % 100003],
                   np.float32)
    kv.init("digest", _nd(mx, np.zeros(1), ctx))
    kv.push("digest", _nd(mx, dig, ctx))
    dsum = _nd(mx, np.zeros(1), ctx)
    kv.pull("digest", out=dsum)
    np.testing.assert_array_equal(dsum.asnumpy(), dig * nworker)
    kv.barrier()


def lenet(mx, kv, rank, nworker, ctx, compress):
    from mxnet_tpu_torch import autograd, gluon
    mx.random.seed(7)  # identical init on every rank
    np.random.seed(7)
    with ctx:
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(64, activation="relu"))
        net.add(gluon.nn.Dense(10))
        net.initialize(mx.init.Xavier(), ctx=ctx)
    train, _ = mx.test_utils.get_mnist_iterator(
        batch_size=32, input_shape=(784,), num_parts=nworker,
        part_index=rank)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(
        net.collect_params(), "sgd", {"learning_rate": 0.1, "momentum": 0.9},
        kvstore=kv, compression_params={"type": "2bit", "threshold": 0.005}
        if compress else None)
    first = last = None
    for _epoch in range(2):
        train.reset()
        for batch in train:
            x = batch.data[0].as_in_context(ctx)
            y = batch.label[0].as_in_context(ctx)
            with autograd.record():
                L = loss_fn(net(x), y)
            L.backward()
            trainer.step(x.shape[0])
            v = float(L.mean().asnumpy())
            first = v if first is None else first
            last = v
    assert last < first * 0.5, (first, last)
    import torch
    from mxnet_tpu_torch.parallel.collectives import _Axis, all_gather_raw
    flat = torch.cat([p.data()._data.reshape(-1)
                      for p in net.collect_params().values()])
    every = all_gather_raw(flat[None], _Axis(kv._mesh, "world"), 0).cpu()
    for r in range(1, nworker):
        assert torch.equal(every[r], every[0]), r
    return first, last


def main(argv):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="append", required=True,
                    choices=["kvstore", "lenet"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--plain-too", action="store_true",
                    help="with --compress, train the LeNet without "
                         "compression first")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import init_world, world_info
    init_world(device=args.device)
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu(0)
    kv = mx.kv.create("dist_sync")
    rank, nworker = kv.rank, kv.num_workers
    assert nworker == int(os.environ["DMLC_NUM_WORKER"])
    info = world_info()
    if "kvstore" in args.check:
        check_dense(mx, kv, rank, nworker, ctx)
        check_row_sparse_raises(mx, kv, rank, nworker, ctx)
        check_compressed(mx, kv, rank, nworker, ctx)
        check_server_side_optimizer(mx, kv, rank, nworker, ctx)
        check_combined(mx, kv, rank, nworker, ctx)
        print("DIST_KVSTORE_OK rank=%d nworker=%d backend=%s"
              % (rank, nworker, info["backend"]), flush=True)
    if "lenet" in args.check:
        modes = ([False] if args.plain_too else []) + [args.compress]
        for compress in modes:
            first, last = lenet(mx, mx.kv.create("dist_sync"), rank,
                                nworker, ctx, compress)
            print("DIST_LENET_OK rank=%d nworker=%d backend=%s compress=%d "
                  "loss %.4f->%.4f" % (rank, nworker, info["backend"],
                                       compress, first, last), flush=True)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def _launch(n, *worker_args, timeout=300):
    env = dict(os.environ, MXNET_KVSTORE_BIGARRAY_BOUND="4096",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, os.path.join(REPO, "tools", "launch.py"), "-n",
           str(n), "--launcher", "local", sys.executable, WORKER,
           "--device", "cpu"] + list(worker_args)
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)


@pytest.fixture(scope="module")
def two_workers():
    """One world of 2 workers: the kvstore flows, then the LeNet without
    and with 2-bit compression."""
    return _launch(2, "--check", "kvstore", "--check", "lenet",
                   "--compress", "--plain-too")


def _ok(r, what, n):
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    # the workers share one stdout, so their lines may interleave
    assert r.stdout.count(what) == n, r.stdout


def test_dist_sync_kvstore_flows_two_workers(two_workers):
    _ok(two_workers, "DIST_KVSTORE_OK", 2)
    assert two_workers.stdout.count("backend=gloo") == 2 + 4


def test_dist_sync_kvstore_flows_three_workers():
    r = _launch(3, "--check", "kvstore")
    _ok(r, "DIST_KVSTORE_OK", 3)


@pytest.mark.parametrize("compress", [0, 1])
def test_dist_lenet_ranks_identical(two_workers, compress):
    _ok(two_workers, "compress=%d" % compress, 2)


def test_server_role_is_a_no_op(monkeypatch):
    """DMLC_ROLE=server parks in the no-op server loop instead of
    crashing (the reference's kvstore_server contract)."""
    from mxnet_tpu_torch import kvstore_server
    monkeypatch.setenv("DMLC_ROLE", "server")
    kvstore_server._init_kvstore_server_module()
    assert kvstore_server.KVStoreServer(None).kvstore is None


if __name__ == "__main__":
    main(sys.argv[1:])
