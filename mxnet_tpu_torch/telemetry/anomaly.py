"""Training anomaly detection: EWMA z-scores on loss and grad-norm (port
of `mxnet_tpu/telemetry/anomaly.py`).

The bad-step guard catches NaN/Inf — the *infinite* failure. This
module is its finite-but-wrong complement: a loss spike or a grad-norm
explosion that is numerically valid but statistically impossible against
the run's own history is invisible to the guard and, without this,
invisible to the operator until the curve diverges hours later.

`EwmaDetector` keeps an exponentially-weighted mean and variance per
signal and scores each new observation against the *previous* state:

    z = (x - m) / sqrt(v + eps)        # m, v BEFORE seeing x
    d = x - m
    m' = m + alpha * d
    v' = (1 - alpha) * (v + alpha * d^2)

(the standard incremental EW mean/variance pair — tests pin the math
against hand-computed sequences). An observation only *flags* once the
detector has warmed up (`warmup` observations) and |z| exceeds the
threshold; flagged or not, the state always updates, so a sustained
level shift re-baselines instead of flagging forever.

`AnomalyDetector` is the step-seam wrapper a resilient training loop
drives (the reference's `ResilientLoop`; the port's waits for its
distributed-training slice): one
EWMA per signal (loss, grad_norm), a flight-flagged
`train_anomalies_total` counter, a `train.anomaly` flight event naming
the signal/value/z/step, and `train_<signal>_zscore` gauges — all
no-ops under `MXNET_TELEMETRY=0` except the pure math (which is
behavior and stays testable).

Knobs (docs/ENV_VARS.md): `MXNET_ANOMALY_DETECT` (default off — the
detector forces the loss onto the host each step),
`MXNET_ANOMALY_ALPHA` (EWMA weight, default 0.05),
`MXNET_ANOMALY_ZSCORE` (flag threshold, default 6.0),
`MXNET_ANOMALY_WARMUP` (observations before flagging, default 20).
"""
from __future__ import annotations

import math
import os

from .metrics import enabled, default_registry

#: metric-name templates (docs/OBSERVABILITY.md; the doc-drift check
#: resolves `<signal>` against the %s template)
ANOMALIES_TOTAL = "train_anomalies_total"
SIGNAL_ZSCORE = "train_%s_zscore"

_EPS = 1e-12


def detect_enabled():
    """MXNET_ANOMALY_DETECT=1 arms the loop-level detector (default
    off: scoring the loss costs a device->host sync per step)."""
    return os.environ.get("MXNET_ANOMALY_DETECT", "0") == "1"


def _env_float(name, default, lo=None, hi=None):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        v = float(raw)
    except ValueError:
        raise ValueError("%s must be a number, got %r" % (name, raw))
    if (lo is not None and v < lo) or (hi is not None and v > hi):
        raise ValueError("%s must be in [%s, %s], got %r"
                         % (name, lo, hi, raw))
    return v


def anomaly_alpha():
    v = _env_float("MXNET_ANOMALY_ALPHA", 0.05, None, 1.0)
    if v <= 0.0:
        # exclusive lower bound: alpha=0 would freeze the EWMA, and the
        # lazy EwmaDetector would otherwise reject it mid-training with
        # an error that never names the knob
        raise ValueError("MXNET_ANOMALY_ALPHA must be in (0, 1], got %r"
                         % (v,))
    return v


def anomaly_zscore():
    return _env_float("MXNET_ANOMALY_ZSCORE", 6.0, 0.0)


def anomaly_warmup():
    return int(_env_float("MXNET_ANOMALY_WARMUP", 20, 0))


class EwmaDetector:
    """One signal's exponentially-weighted mean/variance + z-scoring."""

    def __init__(self, alpha=0.05, zscore=6.0, warmup=20):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1], got %r" % (alpha,))
        self.alpha = float(alpha)
        self.zscore = float(zscore)
        self.warmup = int(warmup)
        self.mean = None
        self.var = 0.0
        self.n = 0

    def observe(self, x):
        """Score `x` against the state BEFORE it, then fold it in.
        Returns (z, flagged): z is None for the very first observation
        (no history to score against) and for non-finite inputs (the
        guard's territory, not statistics'); flagged requires warmup."""
        x = float(x)
        if not math.isfinite(x):
            return None, False
        if self.mean is None:
            self.mean = x
            self.n = 1
            return None, False
        z = (x - self.mean) / math.sqrt(self.var + _EPS)
        d = x - self.mean
        self.mean += self.alpha * d
        self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1
        flagged = self.n > self.warmup and abs(z) > self.zscore
        return z, flagged


class AnomalyDetector:
    """The step-seam detector: one EWMA per named signal, recording
    flags as metrics + flight events. Pure math (z-scores, counts)
    works regardless of MXNET_TELEMETRY; only recording is gated."""

    def __init__(self, alpha=None, zscore=None, warmup=None,
                 registry=None):
        self.alpha = anomaly_alpha() if alpha is None else float(alpha)
        self.z_thresh = anomaly_zscore() if zscore is None \
            else float(zscore)
        self.warmup = anomaly_warmup() if warmup is None else int(warmup)
        self._signals = {}
        self._registry = registry
        self.anomalies = 0            # functional count (tests/statusz)
        self.last = {}                # signal -> last (value, z)

    def _ewma(self, signal):
        e = self._signals.get(signal)
        if e is None:
            e = self._signals[signal] = EwmaDetector(
                self.alpha, self.z_thresh, self.warmup)
        return e

    def observe(self, step, **signals):
        """Score one step's named signals; returns the list of flagged
        signal names. `ResilientLoop` calls
        `observe(t, loss=..., grad_norm=...)` at the step boundary."""
        reg = self._registry or default_registry()
        flagged_names = []
        for signal, value in signals.items():
            if value is None:
                continue
            z, flagged = self._ewma(signal).observe(value)
            if z is None:
                continue
            # copy-on-write: `last` is read by the train console's HTTP
            # thread mid-iteration — replace the dict atomically rather
            # than resizing one a reader may be walking
            self.last = dict(self.last, **{signal: (float(value), z)})
            if enabled():
                reg.gauge(SIGNAL_ZSCORE % signal,
                          help="EWMA z-score of %s, last step" % signal
                          ).set(z)
            if flagged:
                flagged_names.append(signal)
                self.anomalies += 1
                if enabled():
                    reg.counter(
                        ANOMALIES_TOTAL, flight=True,
                        help="finite-but-statistically-impossible "
                             "loss/grad-norm steps (EWMA z-score over "
                             "MXNET_ANOMALY_ZSCORE)"
                    ).inc(signal=signal, step=step)
                    from .flight import flight
                    flight().record("event", "train.anomaly",
                                    signal=signal, value=float(value),
                                    z=round(z, 3), step=step)
        return flagged_names
