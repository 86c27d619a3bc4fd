"""Benchmark of the solver on the GPU: cell-updates/s of the lid-driven
cavity, the Poisson solvers' rates and the predictor's share of the step.

The headline runs the full collocated solver step — adaptive CFL dt,
central convection, diffusion, BCs, exact DCT pressure projection (a
*direct* solve of the Neumann Poisson problem, strictly more accurate
than the reference's 1500-sweep iterative budget, v5.py:64-65) — as
jitted lax.scan chunks.

Throughput is measured marginally between two chunk lengths, each run
ending in ``jax.block_until_ready``: the per-call constant (host
dispatch) cancels out, leaving steady-state device throughput.

    python bench.py [--n=N]     headline at N² (default 1024²)
      --sweep                   + 2048², 4096² and 8192² headline rows
      --all                     + Poisson rates and tier throughputs at 1024²
      --poisson                 + rbsor sweeps/s and mg V-cycles/s at 1024²
                                  and 4096², autotuned DCT at 1024²-8192²
      --predictor               + the collocated predictor's fusions in the
                                  8192² step against their 16 B/cell minimum
      --roofline                + roofline rows per tier

Every line is one JSON object that names the device it ran on. Without
a GPU the script exits with an error: a CPU timing is not a benchmark.
"""

import json
import sys
import tempfile
import time
from typing import Any

import jax
import jax.numpy as jnp


def _timed_chunk(case, state, n_steps: int) -> tuple[float, Any]:
    """(best seconds of 3 runs of n_steps on the device, final state)."""

    def chunk(s, cfl):
        def body(st, _):
            return case.step(st, cfl)

        return jax.lax.scan(body, s, None, length=n_steps)

    f = jax.jit(chunk)
    out, _ = jax.block_until_ready(f(state, jnp.float32(1.0)))  # compile
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out, _ = jax.block_until_ready(f(state, jnp.float32(1.0)))
        best = min(best, time.perf_counter() - t0)
    return best, out


def run_bench(n=1024, short=100, long=600):
    from cfdsim_tpu.cases import lid_cavity
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    case = lid_cavity(
        n=n,
        Re=1000.0,
        # first call per (device kind, shape) times the exact DCT variants
        # on the live hardware and caches the winner — the headline always
        # rides the measured-best exact solver
        poisson=PoissonConfig(method="dct", dct_variant="auto"),
        compute_metrics=False,
    )

    t_short, _ = _timed_chunk(case, case.state, short)
    t_long, state_l = _timed_chunk(case, case.state, long)

    # sanity: simulation must be healthy after the long chunk
    assert bool(jnp.all(jnp.isfinite(state_l.u))), "non-finite state"
    max_u = float(jnp.max(jnp.abs(state_l.u)))
    assert max_u <= 1.5, f"velocity blow-up: {max_u}"

    cups = n * n * (long - short) / (t_long - t_short)
    return {
        "metric": f"cell_updates_per_sec_cavity{n}",
        "value": cups,
        "unit": "cells/s",
    }


def _random_rhs(n):
    import numpy as np

    rng = np.random.default_rng(0)
    rhs = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    return rhs - jnp.mean(rhs)


def poisson_rates(n) -> list:
    """rbsor sweeps/s and mg V-cycles/s at n² (marginal timing)."""
    from cfdsim_tpu.solvers.poisson import PoissonConfig, solve_poisson
    from cfdsim_tpu.utils.roofline import marginal_seconds

    h = 1.0 / (n - 1)
    rhs = _random_rhs(n)
    phi0 = jnp.zeros_like(rhs)
    out = []
    for method, unit in (("rbsor", "sweeps/s"), ("mg", "vcycles/s")):
        cfg = PoissonConfig(method=method, iters=1)
        m = marginal_seconds(lambda p: solve_poisson(p, rhs, h, h, cfg), phi0,
                             20, 200)
        out.append({"metric": f"poisson_{method}_{unit.split('/')[0]}"
                              f"_per_sec_{n}",
                    "value": 1.0 / m, "unit": unit})
    return out


def dct_tuning(n) -> dict:
    """The autotuner's record at n²: winner and ms per variant."""
    from cfdsim_tpu.solvers import autotune

    h = 1.0 / (n - 1)
    autotune.best_dct_variant((n, n), h, h)
    return {"metric": f"dct_autotune_{n}",
            **autotune.tuning_record((n, n))}


def run_secondary(n=1024):
    """Secondary metrics from BASELINE.md: Poisson sweeps/sec, multigrid
    V-cycles/sec, DCT direct solves/sec at 1024² (marginal timing), and
    the other tiers' throughputs."""
    from cfdsim_tpu.solvers.poisson import PoissonConfig, solve_poisson
    from cfdsim_tpu.utils.roofline import marginal_seconds

    results = poisson_rates(n)
    h = 1.0 / (n - 1)
    rhs = _random_rhs(n)
    m = marginal_seconds(lambda p: solve_poisson(
        p, rhs, h, h, PoissonConfig(method="dct")), jnp.zeros_like(rhs),
        20, 200)
    results.append({"metric": f"poisson_dct_solves_per_sec_{n}",
                    "value": 1.0 / m, "unit": "solves/s"})

    # solver-tier throughputs: the staggered accuracy tier and the
    # stretched FDM tier
    from cfdsim_tpu.cases import cavity_stretched, lid_cavity_mac

    case = lid_cavity_mac(n=n, Re=1000.0, poisson=PoissonConfig(method="dct"),
                          compute_metrics=False)
    t1, _ = _timed_chunk(case, case.state, 100)
    t2, _ = _timed_chunk(case, case.state, 600)
    results.append({
        "metric": f"cell_updates_per_sec_cavity_mac{n}",
        "value": n * n * 500 / (t2 - t1), "unit": "cells/s",
    })
    ns = n // 2
    case = cavity_stretched(n=ns, Re=1000.0, beta=1.5, compute_metrics=False)
    t1, _ = _timed_chunk(case, case.state, 100)
    t2, _ = _timed_chunk(case, case.state, 600)
    results.append({
        "metric": f"cell_updates_per_sec_cavity_stretched{ns}",
        "value": ns * ns * 500 / (t2 - t1), "unit": "cells/s",
    })

    # 3D IBM tier: full TVD + exact 3D DCT + sphere penalization at
    # 12 cells/D (the examples/sphere_wake.py validation configuration)
    from cfdsim_tpu.cases import sphere_mac3d

    case = sphere_mac3d(compute_metrics=False)
    ncells = case.grid.n_cells
    t1, _ = _timed_chunk(case, case.state, 50)
    t2, _ = _timed_chunk(case, case.state, 250)
    results.append({
        "metric": "cell_updates_per_sec_sphere3d",
        "value": ncells * 200 / (t2 - t1), "unit": "cells/s",
    })

    # unstructured FEM tier: implicit steps/sec on the reference Gridap
    # cylinder domain — monolithic (reference-parity scheme) and
    # projection (the production scheme, BENCHNOTES "FEM tier")
    from cfdsim_tpu.cases import cylinder_fem

    for scheme, metric in (("monolithic", "fem_cylinder_steps_per_sec"),
                           ("projection",
                            "fem_cylinder_projection_steps_per_sec")):
        case = cylinder_fem(re=100, wake_refine=True, scheme=scheme)
        t1, _ = _timed_chunk(case, case.state, 5)
        t2, _ = _timed_chunk(case, case.state, 30)
        results.append({"metric": metric, "value": 25 / (t2 - t1),
                        "unit": "steps/s"})
    return results


def run_predictor(n=8192, steps=5) -> list:
    """The collocated predictor (u·∇u + ν∇²u + axpy for u and v) inside
    the full step at n², against its minimum traffic — read u, v, write
    u*, v*: 16 B/cell — at the copy bandwidth measured in the same
    process. Its fusions are found by the model's "predictor" named scope
    in the compiled HLO and timed from a profiler trace."""
    from cfdsim_tpu.cases import lid_cavity
    from cfdsim_tpu.solvers.poisson import PoissonConfig
    from cfdsim_tpu.utils.profiling import device_kernel_times, scope_fusions
    from cfdsim_tpu.utils.roofline import measure_peaks

    bw = measure_peaks()["peak_bw"]
    floor_ms = 16.0 * n * n / bw * 1e3
    rows = [{"metric": "copy_bandwidth", "value": bw, "unit": "bytes/s"}]

    case = lid_cavity(n=n, Re=1000.0, compute_metrics=False,
                      poisson=PoissonConfig(method="dct", dct_variant="auto"))

    def chunk(s):
        return jax.lax.scan(lambda st, _: case.step(st, jnp.float32(1.0)),
                            s, None, length=steps)[0]

    f = jax.jit(chunk)
    fusions = scope_fusions(f.lower(case.state).compile().as_text(),
                            "predictor")
    state = jax.block_until_ready(f(case.state))
    with tempfile.TemporaryDirectory(prefix="predictor_trace_") as trace_dir:
        with jax.profiler.trace(trace_dir):
            state = jax.block_until_ready(f(state))
        times = device_kernel_times(trace_dir)
    if "command_buffer" in times:
        # kernels run inside a CUDA graph carry no per-kernel events
        print("warning: command buffers hide kernels from the trace; run "
              "with XLA_FLAGS=--xla_gpu_enable_command_buffer= to "
              "attribute them", file=sys.stderr)
    pred_ns = sum(times.get(k, 0.0) for k in fusions)
    step_ns = sum(times.values())
    pred_ms = pred_ns / steps * 1e-6
    top = sorted(times.items(), key=lambda kv: -kv[1])[:12]
    rows.append({
        "metric": f"predictor_in_step_{n}",
        "ms_per_step": pred_ms,
        "hlo_bytes_per_cell": sum(fusions.values()) / (n * n),
        "floor_ms_16B_per_cell": floor_ms,
        "ratio_to_floor": pred_ms / floor_ms,
        "step_device_ms": step_ns / steps * 1e-6,
        "fusions": {k: {"bytes": b, "ms_per_step": times.get(k, 0.0)
                        / steps * 1e-6} for k, b in fusions.items()},
        "top_kernels_ms_per_step": {k: v / steps * 1e-6 for k, v in top},
    })
    return rows


def run_roofline(n=1024):
    """Roofline rows per tier: flops/cell and HBM bytes/cell from the
    compiled step graph, the bound, and the speed-of-light ceilings
    against the measured and the published peaks of this device."""
    from cfdsim_tpu.cases import cavity_stretched, lid_cavity, lid_cavity_mac
    from cfdsim_tpu.solvers.poisson import PoissonConfig
    from cfdsim_tpu.utils.roofline import (
        measure_peaks, published_peaks, roofline)

    peaks = measure_peaks()
    published = published_peaks(jax.devices()[0].device_kind)
    rows = [{"metric": "machine_peaks", "peak_flops": peaks["peak_flops"],
             "matmul_precision": peaks["matmul_precision"],
             "peak_bw_bytes_per_sec": peaks["peak_bw"]}]

    def tier(name, case, n_cells, chunks=(100, 600)):
        t1, _ = _timed_chunk(case, case.state, chunks[0])
        t2, _ = _timed_chunk(case, case.state, chunks[1])
        rate = n_cells * (chunks[1] - chunks[0]) / (t2 - t1)
        row = roofline(case.step, case.state, n_cells, rate, peaks,
                       jnp.float32(1.0), published=published)
        row["metric"] = f"roofline_{name}"
        rows.append(row)

    tier(f"collocated{n}", lid_cavity(
        n=n, Re=1000.0, poisson=PoissonConfig(method="dct",
                                              dct_variant="auto"),
        compute_metrics=False), n * n)
    tier(f"mac{n}", lid_cavity_mac(
        n=n, Re=1000.0, poisson=PoissonConfig(method="dct"),
        compute_metrics=False), n * n)
    ns = n // 2
    tier(f"stretched{ns}", cavity_stretched(
        n=ns, Re=1000.0, beta=1.5, compute_metrics=False), ns * ns)

    from cfdsim_tpu.cases import sphere_mac3d

    case3 = sphere_mac3d(compute_metrics=False)
    tier("sphere3d", case3, case3.grid.n_cells, chunks=(50, 250))
    return rows


def main(argv):
    from cfdsim_tpu.utils.cache import enable_compilation_cache
    from cfdsim_tpu.utils.device import gpu_name_and_power_limit, require_gpu

    device = require_gpu()
    device["nvidia_smi"] = gpu_name_and_power_limit()
    enable_compilation_cache()

    def emit(row):
        print(json.dumps({**row, "device": device}), flush=True)

    ns = [int(a.split("=")[1]) for a in argv if a.startswith("--n=")]
    emit(run_bench(n=ns[0] if ns else 1024))
    if "--sweep" in argv:  # resolution-scaling rows (1024 printed above)
        for n in (2048, 4096, 8192):
            emit(run_bench(n=n))
    if "--all" in argv:
        for r in run_secondary():
            emit(r)
    if "--poisson" in argv:
        for n in (1024, 4096):
            for r in poisson_rates(n):
                emit(r)
        for n in (1024, 4096, 8192):
            emit(dct_tuning(n))
    if "--predictor" in argv:
        for r in run_predictor():
            emit(r)
    if "--roofline" in argv:
        for r in run_roofline():
            emit(r)


if __name__ == "__main__":
    main(sys.argv[1:])
