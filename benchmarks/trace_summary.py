"""Reduce a ``jax.profiler`` trace to device metrics.

``summarize(trace_dir)`` reads the newest ``*.xplane.pb`` under
``trace_dir`` and, over the GPU device planes, returns:

  * ``window_ns``: first device event start to last device event end;
  * ``busy_ns`` / ``idle_share``: the union of device event intervals,
    and 1 - busy / window;
  * ``top_ops``: ``[name, total device ns, count]`` per kernel name,
    largest first;
  * ``top_modules``: the same per jitted program (``hlo_module`` stat;
    XLA runs a program's kernels as one command buffer, so finer
    attribution is by kernel name);
  * ``lines``: the device line (stream) names seen, for reading by hand.

Usage: python benchmarks/trace_summary.py <trace_dir> [top]
"""

from __future__ import annotations

import glob
import json
import os
import sys
from collections import defaultdict

# derived lines that repeat the stream events at another granularity
_SKIP_LINES = {"XLA Modules", "XLA Ops", "Steps", "Source", "XLA TraceMe",
               "Launch Stats", "Framework Ops", "Framework Name Scope"}


def _stats(ev):
    try:
        return {str(k): v for k, v in ev.stats}
    except (TypeError, ValueError):
        return {}


def _busy(intervals):
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def summarize(trace_dir, top=15):
    """Summary of the newest trace under ``trace_dir`` (see module doc)."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return summarize_data(
        ProfileData.from_file(max(paths, key=os.path.getmtime)), top)


def summarize_data(data, top=15):
    """Summary of one ``jax.profiler.ProfileData``."""
    per_op = defaultdict(lambda: [0, 0])
    per_module = defaultdict(lambda: [0, 0])
    intervals, lines = [], []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines.append(f"{plane.name}/{line.name}")
            if line.name in _SKIP_LINES:
                continue
            for ev in line.events:
                s, d = int(ev.start_ns), int(ev.duration_ns)
                intervals.append((s, s + d))
                per_op[ev.name][0] += d
                per_op[ev.name][1] += 1
                module = _stats(ev).get("hlo_module")
                if module:
                    per_module[str(module)][0] += d
                    per_module[str(module)][1] += 1
    if not intervals:
        raise ValueError("no GPU device events in the trace")
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = _busy(intervals)

    def ranked(table):
        return [[k, v[0], v[1]] for k, v in
                sorted(table.items(), key=lambda kv: -kv[1][0])[:top]]

    return {
        "window_ns": window,
        "busy_ns": busy,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "top_ops": ranked(per_op),
        "top_modules": ranked(per_module),
        "lines": sorted(set(lines)),
    }


if __name__ == "__main__":
    print(json.dumps(summarize(sys.argv[1], int(sys.argv[2]) if
                               len(sys.argv) > 2 else 15), indent=1))
