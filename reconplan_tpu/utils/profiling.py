"""Per-stage timing + ``jax.profiler`` tracing (SURVEY §5 prescription).

The reference's only observability is ad-hoc wall-clock prints
(``redundancy.py:117,133``) and tqdm bars. Here every pipeline app can
carry a :class:`StageTimer` — a tiny struct of named, nestable stage
durations with an optional device fence per stage — and any region can
be wrapped in an XLA profiler trace for ``xprof``/TensorBoard via
:func:`trace` or the ``RECONPLAN_TRACE_DIR`` environment variable.

JAX dispatch is asynchronous: a stage that launches device work returns
before the work ends. ``fence=`` charges the stage until its result is
ready (pass the array most recently written by the stage).
"""

from __future__ import annotations

import contextlib
import json
import os
import time

__all__ = ["StageTimer", "trace", "maybe_trace"]


class StageTimer:
    """Named stage durations for one pipeline run.

    Usage::

        timer = StageTimer()
        with timer.stage("plan"):
            ...
        with timer.stage("fuse", fence=lambda: grid.weight):
            grid = integrate(...)
        print(timer.report())

    ``fence`` is a zero-arg callable returning a device array; the stage
    is charged until that array is ready (``jax.block_until_ready``).
    """

    def __init__(self):
        self.stages = []  # list of (name, seconds) in completion order

    @contextlib.contextmanager
    def stage(self, name, fence=None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if fence is not None:
                import jax

                jax.block_until_ready(fence())
            self.stages.append((name, time.perf_counter() - t0))

    def add(self, name, seconds):
        self.stages.append((name, float(seconds)))

    @property
    def total(self):
        return sum(s for _, s in self.stages)

    def as_dict(self):
        return {name: round(s, 4) for name, s in self.stages}

    def report(self, prefix="stage timings"):
        rows = "  ".join(f"{n}={s:.2f}s" for n, s in self.stages)
        return f"{prefix}: {rows}  (total {self.total:.2f}s)"

    def dump(self, path):
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1)


@contextlib.contextmanager
def trace(log_dir):
    """``jax.profiler.trace`` wrapper: captures an XLA trace viewable in
    TensorBoard / xprof (``tensorboard --logdir <log_dir>``)."""
    import jax

    with jax.profiler.trace(str(log_dir)):
        yield


@contextlib.contextmanager
def maybe_trace(log_dir=None, env="RECONPLAN_TRACE_DIR"):
    """Trace when ``log_dir`` or the ``env`` variable is set; no-op
    otherwise — lets every CLI grow a --profile flag for free."""
    target = log_dir or os.environ.get(env)
    if not target:
        yield
        return
    with trace(target):
        yield
    print(f"jax profiler trace written to {target}")
