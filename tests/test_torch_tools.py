"""The port's operator CLIs (`python -m mxnet_tpu_torch.tools.<name>`)
against the reference's tools/*.py, on the CPU.

Each CLI's parser holds the reference parser's flags (names, dests,
defaults, types, choices) plus `--device` (and, for bandwidth, `--world`,
the size of the all-reduce world the reference read from its virtual
mesh). `serve --demo --device cpu`, built on the reference demo's weights
carried across with models/convert.py, returns the reference server's
greedy tokens over HTTP. aot_warm mirrors tests/test_aot.py's
verify-and-purge test over a cache the port's warm filled (an AOTInductor
package of a tiny exported LM), and works as train_supervise.py's
prewarm command; bandwidth, diagnose and chaos_serve mirror
tests/test_misc.py's and tests/test_examples.py's runs; im2rec and
rec2idx write files byte for byte the reference's on the same images.
Token comparisons are exact (the engines' greedy parity).
"""
import argparse
import contextlib
import importlib.util
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax

from mxnet_tpu import serving as jserving
from mxnet_tpu.models import transformer as jtf

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import aot
from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
from mxnet_tpu_torch.tools import (aot_warm, bandwidth, chaos_serve,
                                   diagnose, im2rec, rec2idx, serve)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("serve", "aot_warm", "chaos_serve", "bandwidth", "diagnose",
         "im2rec", "rec2idx")
#: flags a port CLI adds to the reference's
EXTRA = {"bandwidth": {"--device", "--world"}}


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(
        "ref_tool_" + name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _parser_of(main, argv, monkeypatch):
    """The ArgumentParser `main` builds, caught at its parse_args."""
    seen = []

    def catch(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(_Parsed):
        main()
    monkeypatch.undo()
    return seen[0]


def _actions(parser):
    return {(a.option_strings[0] if a.option_strings else a.dest): (
        a.dest, a.default, a.nargs, a.const, getattr(a.type, "__name__",
                                                     a.type),
        a.choices, type(a).__name__)
        for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", TOOLS)
def test_cli_flags_match_the_reference(name, monkeypatch):
    ref = _parser_of(_ref_tool(name).main, [name], monkeypatch)
    port_mod = {"serve": serve, "aot_warm": aot_warm,
                "chaos_serve": chaos_serve, "bandwidth": bandwidth,
                "diagnose": diagnose, "im2rec": im2rec,
                "rec2idx": rec2idx}[name]
    port = _parser_of(port_mod.main, [name], monkeypatch)
    want, got = _actions(ref), _actions(port)
    extra = EXTRA.get(name, {"--device"})
    assert set(got) == set(want) | extra, (sorted(set(got) ^ set(want)))
    for flag in want:
        assert got[flag] == want[flag], (flag, got[flag], want[flag])
    dev = got["--device"]
    assert dev[1] == "cuda" and dev[5] == ("cuda", "cpu")


def test_every_cli_runs_as_python_m():
    """`python -m mxnet_tpu_torch.tools.<name> --help` for each, through
    runpy in one process (what -m runs), and neither jax nor the
    reference imported."""
    code = ("import runpy, sys\n"
            "for n in %r:\n"
            "    sys.argv = [n, '--help']\n"
            "    try:\n"
            "        runpy.run_module('mxnet_tpu_torch.tools.' + n,"
            " run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code in (0, None), (n, e.code)\n"
            "print('IMPORTED', sorted(k for k in sys.modules if "
            "k.split('.')[0] in ('jax', 'mxnet_tpu')))\n" % (TOOLS,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORTED []" in out.stdout
    for n in ("--model", "--cache", "--size-mb", "--no-device-probe",
              "--center-crop", "--key-from-header", "--requests"):
        assert n in out.stdout


def test_device_cuda_without_a_card_names_it(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cuda"):
        serve.main(["--demo"])
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        rec2idx.main(["x.rec"])


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

SERVE_PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9, 3, 2, 3],
                 [255, 0, 128]]
SERVE_NEW = 8


@pytest.fixture(scope="module")
def demo_weights():
    """The reference demo's (params, cfg) (tools/serve.py --demo: jax's
    PRNGKey(0)) and the same weights as numpy."""
    cfg = jtf.TransformerConfig(**serve.DEMO_CONFIG)
    params = jtf.init_transformer_params(jax.random.PRNGKey(0), cfg)
    return params, cfg, {k: np.asarray(v) for k, v in params.items()}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, path, body):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path),
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def run_cli_on_thread(argv, port):
    """serve.main(argv) on a thread; returns (server, thread, stdout
    buffer) once /healthz answers."""
    started, buf = [], io.StringIO()

    def run():
        with contextlib.redirect_stdout(buf):
            serve.main(argv + ["--port", str(port)],
                       on_serving=started.append)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.time() + 120
    while time.time() < deadline:
        try:
            with urllib.request.urlopen("http://127.0.0.1:%d/healthz"
                                        % port, timeout=5) as r:
                if json.loads(r.read())["ok"]:
                    return started[0], t, buf
        except OSError:
            time.sleep(0.05)
    raise AssertionError("the serve CLI never answered: %s"
                         % buf.getvalue())


@pytest.mark.parametrize("paged", [False, True])
def test_serve_cli_demo_matches_reference_serve(demo_weights, monkeypatch,
                                                paged):
    """`serve --demo --device cpu` on the reference demo's weights: its
    greedy tokens over /v1/generate equal the reference's
    serving.serve((params, cfg)) on 4 prompts, on the gather and the
    paged path; SIGTERM's path (stop_http) prints the stop line."""
    jparams, jcfg, arrays = demo_weights
    ref = jserving.serve((jparams, jcfg), paged=paged)
    try:
        want = [ref.generate(list(p), max_new_tokens=SERVE_NEW, timeout=300)
                for p in SERVE_PROMPTS]
    finally:
        ref.close()
    monkeypatch.setattr(serve, "demo_model", lambda device: (
        params_from_numpy(arrays, TransformerConfig(**serve.DEMO_CONFIG),
                          device), TransformerConfig(**serve.DEMO_CONFIG)))
    port = _free_port()
    srv, t, buf = run_cli_on_thread(
        ["--demo", "--device", "cpu"] + (["--paged"] if paged else []),
        port)
    try:
        got = [_post(port, "/v1/generate", {"tokens": p,
                                            "max_new_tokens": SERVE_NEW})
               ["tokens"] for p in SERVE_PROMPTS]
    finally:
        srv.stop_http()
        t.join(timeout=60)
    assert not t.is_alive()
    assert got == want
    assert srv.engine.paged is paged
    out = buf.getvalue()
    assert "serving DEMO transformer" in out and "listening on" in out
    stop = json.loads(out.split("stopped: ")[1].splitlines()[0])
    assert stop["requests"]["completed"] == len(SERVE_PROMPTS)
    assert stop["kernel_launches"]["paged_attention"] == 0   # the CPU
    assert stop["replays"] == 0                  # no exported program


def test_serve_cli_model_counts_replays(tiny_artifact):
    """`serve --model --device cpu` on an exported LM: its stop line
    counts the program's replays, one a forward of each exported-batch
    chunk of the running sequences, which the adapter counts too."""
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9, 10]]
    port = _free_port()
    srv, t, buf = run_cli_on_thread(
        ["--model", tiny_artifact, "--device", "cpu", "--max-batch", "4"],
        port)
    try:
        got = [_post(port, "/v1/generate", {"tokens": p,
                                            "max_new_tokens": 3})
               ["tokens"] for p in prompts]
    finally:
        srv.stop_http()
        t.join(timeout=60)
    assert not t.is_alive()
    assert all(len(g) == 3 for g in got)
    stop = json.loads(buf.getvalue().split("stopped: ")[1].splitlines()[0])
    # one request at a time: 3 forwards each, a batch of one a chunk
    assert stop["replays"] == srv.engine.model.replays == 3 * len(prompts)
    assert stop["kernel_launches"]["rnn_fwd"] == 0     # the CPU


def test_demo_model_is_seeded():
    a, cfg = serve.demo_model("cpu")
    b, _ = serve.demo_model("cpu")
    assert cfg.vocab == 256 and cfg.max_len == 128
    assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)


# ---------------------------------------------------------------------------
# aot_warm (tests/test_aot.py::test_aot_warm_verify_and_purge)
# ---------------------------------------------------------------------------


class _TinyLM(tmx.gluon.Block):
    """(B, S) token ids -> (B, S, V) logits: an embedding and a dense head."""

    def __init__(self):
        super().__init__(prefix="tiny_")
        with self.name_scope():
            self.emb = tmx.gluon.nn.Embedding(32, 8)
            self.out = tmx.gluon.nn.Dense(32, flatten=False)

    def forward(self, x):
        return self.out(self.emb(x))


@pytest.fixture
def tiny_artifact(tmp_path):
    with tmx.cpu():
        with tmx.name.NameManager():
            net = _TinyLM()
        net.initialize(tmx.init.Xavier())
        net(tmx.nd.zeros((2, 16)))
        path = str(tmp_path / "tiny.mxtpu")
        tmx.predict.export_model(net, [("data", (2, 16))], path,
                                 input_dtypes={"data": "int32"})
    return path


def test_aot_warm_fills_verifies_and_purges(tiny_artifact, tmp_path,
                                            capsys):
    cache = str(tmp_path / "cache")
    try:
        assert aot_warm.main(["--cache", cache, "--model", tiny_artifact,
                              "--device", "cpu", "--max-batch", "2",
                              "--prompt-buckets", "4,8"]) == 0
        out = capsys.readouterr().out
        assert "1 AOTInductor package(s) compiled" in out, out
        assert "0 nvcc build(s)" in out
        entries = aot.AOTCache(cache).entries()
        assert len(entries) == 1
        assert aot_warm.main(["--cache", cache, "--verify"]) == 0
        assert "0 corrupt" in capsys.readouterr().out
        # corrupt one entry -> nonzero exit naming it
        path = os.path.join(cache, entries[0])
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0x01
        open(path, "wb").write(bytes(blob))
        assert aot_warm.main(["--cache", cache, "--verify"]) == 1
        assert "CORRUPT" in capsys.readouterr().out
        assert aot_warm.main(["--cache", cache, "--purge"]) == 0
        assert not aot.AOTCache(cache).entries()
        # no cache anywhere -> a loud SystemExit, not a silent no-op
        aot.configure(None)
        with pytest.raises(SystemExit):
            aot_warm.main(["--verify"])
        with pytest.raises(SystemExit):
            aot_warm.main(["--demo", "--device", "cpu"])
    finally:
        aot.configure()


def test_aot_warm_is_a_prewarm_command(tmp_path):
    """tools/train_supervise.py's --prewarm-cmd seam runs the port's
    aot_warm before each incarnation: a sound cache passes quietly, a
    corrupt one is logged and the launch goes on cold."""
    sup = _ref_tool("train_supervise")
    cache = aot.AOTCache(str(tmp_path / "c"))
    cache.store("kernels_x", "k0", b"payload", b"trees")
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.aot_warm",
           "--cache", cache.path, "--verify"]
    logs = []
    assert sup.supervise(["cmd"], restart_max=1, backoff=0.0,
                         run=lambda: 0, sleep=lambda s: None,
                         log=logs.append, prewarm=cmd) == 0
    assert not any("continuing cold" in m for m in logs), logs
    path = os.path.join(cache.path, cache.entries()[0])
    with open(path, "r+b") as f:
        f.seek(40)
        f.write(b"\xff\xff")
    logs = []
    assert sup.supervise(["cmd"], restart_max=1, backoff=0.0,
                         run=lambda: 0, sleep=lambda s: None,
                         log=logs.append, prewarm=cmd) == 0
    assert any("prewarm exited rc=1" in m for m in logs), logs


# ---------------------------------------------------------------------------
# bandwidth, diagnose, chaos_serve (tests/test_misc.py, test_examples.py)
# ---------------------------------------------------------------------------


def test_bandwidth_cli_reports_staging_and_a_gloo_world(capsys):
    assert bandwidth.main(["--size-mb", "1", "--iters", "2", "--device",
                           "cpu", "--world", "4"]) == 0
    out = capsys.readouterr().out
    assert "host->device staging" in out
    assert "allreduce over 4 dev" in out and "(gloo)" in out


def test_diagnose_cli_without_the_probe(capsys):
    assert diagnose.main(["--no-device-probe"]) == 0
    out = capsys.readouterr().out
    assert "mxnet_tpu_torch" in out and "Native extension" in out
    for section in ("Platform", "Versions", "Kernel build", "Environment"):
        assert "----- %s -----" % section in out
    assert "torch       :" in out and "nvcc        :" in out


def test_diagnose_cli_probes_in_a_subprocess(capsys):
    import torch
    assert diagnose.main(["--device", "cpu"]) == 0
    assert "device      : cpu" in capsys.readouterr().out
    if torch.cuda.is_available():
        assert diagnose.main([]) == 0
        assert "nvidia-smi  :" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit, match="card probe failed"):
            diagnose.main([])


def test_chaos_serve_drill_passes_on_the_cpu(tmp_path):
    """The seven-fault drill (tests/test_examples.py's chaos_serve.py
    run) on the CPU: rc 0 and its pass line."""
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.chaos_serve",
         "--device", "cpu", "--flight-dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "== OK: availability 100.0%" in out.stdout
    for n in range(1, 8):
        assert "-- fault %d:" % n in out.stdout


# ---------------------------------------------------------------------------
# im2rec, rec2idx
# ---------------------------------------------------------------------------


@pytest.fixture
def images(tmp_path):
    """Two classes of synthetic images, JPEG and PNG, of odd sizes."""
    from PIL import Image
    root = tmp_path / "imgs"
    rng = np.random.RandomState(0)
    for c, (w, h) in enumerate([(37, 29), (24, 41)]):
        d = root / ("class%d" % c)
        d.mkdir(parents=True)
        for i in range(3):
            img = Image.fromarray(rng.randint(0, 255, (h, w, 3))
                                  .astype(np.uint8))
            img.save(str(d / ("im%d.%s" % (i, "jpg" if i % 2 else "png"))))
    return str(root)


@pytest.mark.parametrize("flags", [[], ["--resize", "24"],
                                   ["--resize", "20", "--center-crop"]])
def test_im2rec_writes_the_references_bytes(images, tmp_path, monkeypatch,
                                            flags):
    ref = _ref_tool("im2rec")
    out = {}
    for who in ("ref", "port"):
        prefix = str(tmp_path / who / "data")
        os.makedirs(os.path.dirname(prefix))
        for argv in (["--list", prefix, images], [prefix, images] + flags):
            if who == "ref":
                monkeypatch.setattr(sys, "argv", ["im2rec.py"] + argv)
                ref.main()
            else:
                assert im2rec.main(argv + ["--device", "cpu"]) == 0
        out[who] = {ext: open(prefix + ext, "rb").read()
                    for ext in (".lst", ".idx", ".rec")}
    assert out["port"] == out["ref"]
    assert out["port"][".lst"].count(b"\n") == 6


def test_rec2idx_random_access(tmp_path, capsys):
    """tests/test_misc.py::test_tool_rec2idx_roundtrip on the port: the
    .idx lets MXIndexedRecordIO read every record of a plain .rec out of
    order, and equals the reference tool's bytes."""
    rec = str(tmp_path / "a.rec")
    w = tmx.recordio.MXRecordIO(rec, "w")
    payloads = [("rec%03d" % i).encode() * (i + 1) for i in range(7)]
    for i, b in enumerate(payloads):
        w.write(tmx.recordio.pack(tmx.recordio.IRHeader(0, 0.0, i, 0), b))
    w.close()
    idx = str(tmp_path / "a.idx")
    assert rec2idx.build_index(rec, idx) == 7
    r = tmx.recordio.MXIndexedRecordIO(idx, rec, "r")
    for i in (6, 0, 3):
        _, blob = tmx.recordio.unpack(r.read_idx(i))
        assert blob == payloads[i]
    r.close()
    ref_idx = str(tmp_path / "ref.idx")
    assert _ref_tool("rec2idx").build_index(rec, ref_idx, True) == 7
    assert rec2idx.main([rec, "--key-from-header", "--device", "cpu"]) == 0
    assert "wrote 7 entries to %s" % idx in capsys.readouterr().out
    assert open(idx, "rb").read() == open(ref_idx, "rb").read()


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 32, rehearsed
# ---------------------------------------------------------------------------


def test_chip_smoke_phase_32_rehearses_on_the_cpu(monkeypatch, tmp_path):
    """Phase 32 at a tiny width on the CPU, exporting its own artifact:
    every check holds but those only the card can meet (the kernel
    library's warm load, K1's and K4a's launches: the CPU runs the plain
    versions and builds no library)."""
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch.serving import engine
    failed = []
    monkeypatch.setattr(cs, "check", lambda c, msg: c or failed.append(msg))
    for name, value in dict(LM_VOCAB=50, LM_EMBED=8, LM_HIDDEN=8,
                            LM_BPTT=5, LM_BATCH=3, WATCH_PROMPT_LEN=4,
                            WATCH_GEN=4, WATCH_MAX_LEN=16,
                            CLI_DEMO_GEN=4).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(tmx, "gpu", lambda i=0: tmx.cpu())
    real = engine.resolve_device
    monkeypatch.setattr(engine, "resolve_device",
                        lambda d=None: real("cpu" if d is None else d))
    aot.configure(str(tmp_path / "cache"))
    try:
        k1, k4a, out = cs.phase_cli(torch, np, torch.device("cpu"), "cpu")
    finally:
        aot.configure()
    assert out["32a"]["tokens_equal_31c"] and out["32a_demo"]["tokens_equal"]
    assert out["32a"]["nvcc_builds"] == 0
    # WATCH_GEN forwards of each of the 2 chunks of 2 prompts, at least
    assert out["32a"]["replays"] >= 2 * 4
    assert "0 corrupt" in out["32b"]
    assert any("allreduce over 1 dev" in ln for ln in out["32c"])
    assert "device      : cpu" in out["32d"]
    assert (k1, k4a) == (0, 0)
    assert len(failed) == 3 and all(
        any(w in m for w in ("launched K1", "launched K4a", "warm loads"))
        for m in failed), failed
