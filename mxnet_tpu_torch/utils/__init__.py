"""Host-side helpers of the port (`serialization`, `legacy`, `chaos`)
and the two small utilities of `mxnet_tpu/utils/__init__.py` the serving
front door uses: `retry` and `makedirs`; and `atomic_publish`, which
`predict.export_model` writes its artifact through."""
import contextlib
import os
import threading


@contextlib.contextmanager
def atomic_publish(path):
    """Write-to-temp + atomic-rename publish (the port's copy of
    `mxnet_tpu/aot/cache.py::atomic_publish`): yields the temp path to
    write, renames it over `path` on success and removes it on failure,
    so a reader never sees a half-written file."""
    tmp = "%s.tmp.%d.%x" % (path, os.getpid(), threading.get_ident())
    try:
        yield tmp
        os.replace(tmp, path)
    finally:
        with contextlib.suppress(OSError):
            os.remove(tmp)


def makedirs(d):
    os.makedirs(d, exist_ok=True)


def retry(fn, attempts=3, backoff=0.1, jitter=0.1, retry_on=(OSError,),
          on_retry=None, deadline_s=None):
    """Call `fn()` with exponential backoff on transient failures.

    attempts  total tries (>=1); the last failure re-raises.
    backoff   base delay in seconds; try i sleeps backoff * 2**i.
    jitter    fraction of the delay randomized (decorrelates a fleet of
              workers retrying the same overloaded endpoint).
    retry_on  exception class or tuple caught as retryable; anything
              else propagates immediately.
    on_retry  optional callback (exc, attempt_index) before each sleep —
              the logging/metrics hook.
    deadline_s  cap on the TOTAL seconds this call may spend sleeping
              between attempts (measured from entry on the monotonic
              clock). A sleep that would cross the deadline is clamped
              to the remainder; once the deadline is spent the current
              failure re-raises instead of retrying. None = unbounded.

    The serving HTTP frontend's submit-on-QueueFull path uses it.
    """
    import random as _random
    import time as _time
    attempts = max(1, int(attempts))
    t0 = _time.monotonic()
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if i == attempts - 1:
                raise
            remaining = None
            if deadline_s is not None:
                remaining = float(deadline_s) - (_time.monotonic() - t0)
                if remaining <= 0:
                    raise
            if on_retry is not None:
                on_retry(e, i)
            delay = backoff * (2 ** i)
            delay *= 1.0 + jitter * _random.random()
            if remaining is not None:
                delay = min(delay, remaining)
            if delay > 0:
                _time.sleep(delay)
