"""Entry-point contracts that hold on the CPU: the compilation-cache rule,
the GPU-only measurement scripts, and the trace reduction."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CACHE_PROBE = (
    "import jax; from reconplan_tpu.utils.compile_cache import "
    "enable_compilation_cache as e; d = e(); "
    "print(d); print(jax.config.jax_compilation_cache_dir)"
)


def _run(args, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_compile_cache_env_is_left_to_jax(tmp_path):
    r = _run(["-c", _CACHE_PROBE],
             env_extra={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_compile_cache_defaults_inside_checkout():
    r = _run(["-c", _CACHE_PROBE], drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    want = os.path.join(REPO, ".jax_cache")
    assert r.stdout.split() == [want, want]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_measurement_scripts_refuse_the_cpu(script):
    """A CPU run is not a device measurement: exit non-zero, no result."""
    r = _run([script])
    assert r.returncode != 0
    last = (r.stdout.strip().splitlines() or [""])[-1]
    assert '"ok": true' not in last and "frames/sec" not in last
    assert "GPU" in r.stderr, r.stderr[-2000:]


def test_trace_summary_reduces_device_events():
    """Busy time is the union of device intervals; ops rank by total."""
    from jax.profiler import ProfileData

    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from trace_summary import summarize_data

    # two streams; fusion.1 at [0, 10) and [30, 40) us, scatter at
    # [5, 20) us on the other stream: busy 30 us of a 40 us window
    ps = 1_000_000
    text = f"""
planes {{
  name: "/device:GPU:0"
  lines {{ id: 1 name: "Stream #1"
    events {{ metadata_id: 1 offset_ps: 0 duration_ps: {10 * ps}
              stats {{ metadata_id: 7 str_value: "jit_step" }} }}
    events {{ metadata_id: 1 offset_ps: {30 * ps} duration_ps: {10 * ps}
              stats {{ metadata_id: 7 str_value: "jit_step" }} }}
  }}
  lines {{ id: 2 name: "Stream #2"
    events {{ metadata_id: 2 offset_ps: {5 * ps} duration_ps: {15 * ps} }}
  }}
  event_metadata {{ key: 1 value {{ id: 1 name: "fusion.1" }} }}
  event_metadata {{ key: 2 value {{ id: 2 name: "scatter" }} }}
  stat_metadata {{ key: 7 value {{ id: 7 name: "hlo_module" }} }}
}}
planes {{ name: "/host:CPU" }}
"""
    s = summarize_data(ProfileData.from_text_proto(text))
    assert s["window_ns"] == 40_000 and s["busy_ns"] == 30_000
    assert s["idle_share"] == pytest.approx(0.25)
    assert s["top_ops"] == [["fusion.1", 20_000, 2], ["scatter", 15_000, 1]]
    assert s["top_modules"] == [["jit_step", 20_000, 2]]
    json.dumps(s)
