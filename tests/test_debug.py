"""Debug/sanitizer utilities."""

import logging

import jax
import jax.numpy as jnp
import numpy as np

from cfdsim_tpu.cases import lid_cavity
from cfdsim_tpu.solvers.poisson import PoissonConfig
from cfdsim_tpu.utils.debug import checked, nan_watch


def _tiny_case():
    # tiny Jacobi Poisson keeps XLA compile time low for these tests
    return lid_cavity(n=16, Re=100.0, poisson=PoissonConfig(method="jacobi", iters=2))


def test_nan_watch_flags_nonfinite(caplog):
    case = _tiny_case()

    def poisoned_step(state, cfl):
        s, m = case.step(state, cfl)
        bad = s.u.at[3, 3].set(jnp.nan)
        return s._replace(u=bad), m

    watched = jax.jit(nan_watch(poisoned_step, name="poisoned"))
    with caplog.at_level(logging.ERROR, logger="cfdsim_tpu.debug"):
        s, _ = watched(case.state, jnp.float32(1.0))
        jax.effects_barrier()
    assert any("non-finite" in r.message for r in caplog.records)


def test_nan_watch_silent_when_healthy(caplog):
    case = _tiny_case()
    watched = jax.jit(nan_watch(case.step))
    with caplog.at_level(logging.ERROR, logger="cfdsim_tpu.debug"):
        s, _ = watched(case.state, jnp.float32(1.0))
        jax.effects_barrier()
    assert not caplog.records
    assert bool(jnp.all(jnp.isfinite(s.u)))


def test_checked_step_runs_clean():
    case = _tiny_case()
    f = jax.jit(checked(case.step))
    err, (s, m) = f(case.state, jnp.float32(1.0))
    err.throw()  # no error expected
    assert bool(jnp.all(jnp.isfinite(s.u)))


def test_profiler_trace_captures(tmp_path):
    from cfdsim_tpu.utils.profiling import profiler_trace

    case = _tiny_case()
    with profiler_trace(str(tmp_path)):
        s, _ = jax.jit(case.step)(case.state, jnp.float32(1.0))
        float(s.t)
    captured = list(tmp_path.rglob("*"))
    assert captured, "profiler trace produced no files"


def test_profiler_trace_noop_without_dir():
    from cfdsim_tpu.utils.profiling import profiler_trace

    with profiler_trace(None):
        pass  # must not raise


def test_device_memory_stats_census():
    """Memory observability (VERDICT r4 #6): the live-array census works
    on every backend; allocator keys (peak bytes) appear only where the
    backend exposes memory_stats (GPU yes, XLA CPU no) — both shapes
    must be well-formed ints."""
    from cfdsim_tpu.utils.profiling import PerfTracker, device_memory_stats

    x = jnp.ones((64, 64))
    float(x.sum())  # materialize on device
    stats = device_memory_stats()
    assert stats["live_arrays"] >= 1
    assert stats["live_array_bytes"] >= x.nbytes
    for k, v in stats.items():
        assert isinstance(v, int), (k, type(v))

    report = PerfTracker(n_cells=64 * 64).report()
    assert "live_arrays" in report and "cell_updates_per_sec" in report
    assert "live_arrays" not in PerfTracker(n_cells=1).report(
        include_memory=False)
