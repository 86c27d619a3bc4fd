"""Smoke test of the solver on the GPU: drives the main path once at a
size users run and checks the card's results against the CPU.

    python chip_smoke.py           one card (phases 0-3)
    python chip_smoke.py --four    four cards: the explicit shard_map
                                   twins against the single-card step

Phases, one JSON line each:

0. device: JAX's first device must be a GPU (no CPU fallback); the
   card's name and power limit from nvidia-smi, its kind, JAX's version.
1. collocated lid-driven cavity at 8192², Re=1000 — first through the
   CLI (``cases.build`` → ``runner.Simulation`` → health checks), then
   with the autotuned exact DCT projection: the variant picked and the
   ms per variant, compile seconds, steps/s, device memory; 50 steps on
   the card, then 5 more from that state on the card and on the CPU.
2. staggered (MAC) cavity at 8192² with the exact DCT projection, the
   same card-vs-CPU check.
3. 3D MAC cavity at 256³ with Smagorinsky LES and the exact 3D DCT
   projection, the same check over 3 steps; ``div_post`` at fp32
   roundoff.

``--four`` runs only the explicit shard_map MAC steps (pencil
``all_to_all`` DCT) at 8192² and 256³ on a 2×2 mesh, each against the
single-card step on ``devices()[0]`` over 5 steps. Both sharded steps
run before either reference, so that each raises every card's allocator
peak; the growth of the peak must be even across the mesh.

Tolerance: max|card − reference| ≤ 1e-4 · max|u| for each velocity
component (max|u| over all components of the reference), and ≤ 1e-4 ·
max|p| for p, both with the mean removed (the Neumann solve fixes p up
to a constant). Both sides are fp32, but cuFFT, the CPU FFT and the
pencil transform sum in different orders; no matmul on these paths runs
in TF32 (the matmul DCT forces fp32 precision).

The figures printed here are smoke figures, not benchmark results. The
last line is ``{"ok": true, "device": {...}}``; any failure raises, so
the script exits non-zero and prints no result.
"""

import json
import os
import sys
import tempfile
import time
from typing import NamedTuple

import jax

TOL = 1e-4


def _allow_cpu_reference():
    """The CPU reference needs the host backend beside the GPU. Where the
    environment restricts JAX's platforms, add "cpu" before any backend
    starts."""
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def compare(card, ref, tol=TOL) -> dict:
    """Compare fields {name: array} of the card's run with the reference
    run: max|Δ| ≤ tol·max|u| for the velocity components, with max|u|
    taken over all of them, and ≤ tol·max|p| for "p", its mean removed
    on both sides. Returns the figures; raises AssertionError on a
    miss."""
    import numpy as np

    card = {k: np.asarray(v, np.float64) for k, v in card.items()}
    ref = {k: np.asarray(v, np.float64) for k, v in ref.items()}
    for d in (card, ref):
        if "p" in d:
            d["p"] = d["p"] - d["p"].mean()
    u_max = max(float(np.max(np.abs(v))) for k, v in ref.items() if k != "p")
    out, bad = {}, []
    for name, b in ref.items():
        a = card[name]
        if a.shape != b.shape:
            raise AssertionError(f"{name}: shape {a.shape} vs {b.shape}")
        if not np.all(np.isfinite(a)):
            raise AssertionError(f"{name}: non-finite values on the card")
        diff = float(np.max(np.abs(a - b)))
        scale = float(np.max(np.abs(b))) if name == "p" else u_max
        bound = tol * scale
        out[name] = {"max_abs_diff": diff, "bound": bound}
        if not diff <= bound:
            bad.append(name)
    if bad:
        raise AssertionError(f"card vs reference beyond tolerance in {bad}: "
                             f"{out}")
    return out


def _scan(step, k):
    def run(s):
        return jax.lax.scan(lambda st, _: step(st, 1.0), s, None, length=k)
    return jax.jit(run)


def card_vs_cpu(case, warm_steps: int, check_steps: int, fields) -> dict:
    """``warm_steps`` on the card (compile and steps/s measured), then
    ``check_steps`` more from that state on the card and on the CPU with
    the same step function; returns the figures of the comparison."""
    from cfdsim_tpu.utils.profiling import device_memory_stats

    card = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    state = jax.device_put(case.state, card)

    t0 = time.perf_counter()
    warm = _scan(case.step, warm_steps).lower(state).compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, _ = jax.block_until_ready(warm(state))
    run_s = time.perf_counter() - t0

    host = jax.device_get(state)
    check = _scan(case.step, check_steps)
    s_card, m_card = jax.block_until_ready(check(jax.device_put(host, card)))
    with jax.default_device(cpu):
        s_cpu, m_cpu = check(jax.device_put(host, cpu))
    ok = compare({f: getattr(s_card, f) for f in fields},
                 {f: getattr(s_cpu, f) for f in fields})
    return {
        "cells": int(case.grid.n_cells),
        "warm_steps": warm_steps,
        "check_steps": check_steps,
        "compare": ok,
        "div_post_card": float(jax.device_get(m_card.div_post)[-1]),
        "div_post_cpu": float(jax.device_get(m_cpu.div_post)[-1]),
        # one short run each: smoke figures, not benchmark results
        "smoke_figures": {"compile_s": compile_s,
                          "steps_per_sec": warm_steps / run_s,
                          "memory": device_memory_stats(card)},
    }


def phase_cli(n: int) -> dict:
    """The headline case through the CLI, as a user runs it."""
    from cfdsim_tpu.__main__ import main
    from cfdsim_tpu.utils.profiling import device_memory_stats

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as out:
        t0 = time.perf_counter()
        report = main(["run", "cavity", "--n", str(n), "--Re", "1000",
                       "--chunk-steps", "20", "--max-steps", "60",
                       "--snapshot-interval", "0", "--out", out])
        wall = time.perf_counter() - t0
    if report["final_step"] != 60 or report["stopped_reason"]:
        raise AssertionError(f"CLI run did not finish healthy: {report}")
    return {"n": n, "final_step": report["final_step"],
            "smoke_figures": {"wall_s": wall,
                              "memory": device_memory_stats(jax.devices()[0])}}


def phase_collocated(n: int, warm_steps=50, check_steps=5) -> dict:
    from cfdsim_tpu.cases import lid_cavity
    from cfdsim_tpu.solvers import autotune
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    case = lid_cavity(n=n, Re=1000.0,
                      poisson=PoissonConfig(method="dct", dct_variant="auto"))
    tuning = autotune.tuning_record((n, n))
    if tuning is None:  # a forced variant (CFDSIM_DCT_VARIANT) was used
        tuning = {"variant": case.cfg.poisson.dct_variant}
    return {"n": n, "dct_autotune": tuning,
            **card_vs_cpu(case, warm_steps, check_steps, ("u", "v", "p"))}


def phase_mac(n: int, warm_steps=20, check_steps=5) -> dict:
    from cfdsim_tpu.cases import lid_cavity_mac
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    case = lid_cavity_mac(n=n, Re=1000.0, poisson=PoissonConfig(method="dct"))
    return {"n": n, **card_vs_cpu(case, warm_steps, check_steps,
                                  ("u", "v", "p"))}


def phase_mac3d(n: int, warm_steps=10, check_steps=3) -> dict:
    from cfdsim_tpu.cases import cavity3d_mac

    case = cavity3d_mac(n=n, Re=1000.0, use_les=True)
    r = card_vs_cpu(case, warm_steps, check_steps, ("u", "v", "w", "p"))
    # exact projection: the post-projection divergence is fp32 roundoff
    # (relative to max|u|/h, which is ~n for a unit lid)
    if not r["div_post_card"] < 1e-5 * n:
        raise AssertionError(f"3D div_post {r['div_post_card']} not at "
                             f"fp32 roundoff")
    return {"n": n, **r}


def _random_mac_state(case, seed: int):
    """Seeded random velocities (amplitude 0.1) on the host, so that the
    comparison exercises every face; p and the counters from the case."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s = jax.device_get(case.state)
    return s._replace(**{
        f: (0.1 * rng.standard_normal(getattr(s, f).shape)).astype(np.float32)
        for f in ("u", "v", "w") if hasattr(s, f)})


class FourPhase(NamedTuple):
    """One ``--four`` comparison: the case built on the host, its seeded
    state, the explicit shard_map step, and how to trim and shard it."""
    name: str
    n: int
    case: object
    host: object
    step_ex: object
    trim: object
    spec: object
    fields: tuple


def _memory(devices):
    """Each card's allocator (peak, in use) bytes; None off the GPU, whose
    host allocator keeps no such figures."""
    if any(d.platform != "gpu" for d in devices):
        return None
    stats = [d.memory_stats() for d in devices]
    return ([s["peak_bytes_in_use"] for s in stats],
            [s["bytes_in_use"] for s in stats])


def peak_growth(peak_before, in_use_base, peak_after) -> list:
    """Growth of each card's allocator peak over its bytes in use before
    anything of the ``--four`` phases was built. The peak never resets,
    so a run must raise it on every card for the growth to be its own: a
    card whose peak did not rise fails, and so does an uneven share (max >
    1.5·min), such as a table that lands whole on one card."""
    stale = [i for i, (a, b) in enumerate(zip(peak_before, peak_after))
             if not b > a]
    if stale:
        raise AssertionError(f"the allocator peak did not rise on cards "
                             f"{stale}: {peak_before} -> {peak_after}")
    growth = [b - a for a, b in zip(in_use_base, peak_after)]
    if max(growth) > 1.5 * min(growth):
        raise AssertionError(f"uneven device memory across the mesh: "
                             f"{growth}")
    return growth


def _run_sharded(ph: FourPhase, mesh, steps: int, base) -> dict:
    """The explicit shard_map step from the trimmed host state, placed
    straight from the host onto the mesh; the memory each card takes
    over ``base``, the (peak, in use) bytes before any phase was built."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    import numpy as np

    def place(x):
        x = np.asarray(x)
        return jax.device_put(
            x, NamedSharding(mesh, ph.spec if x.ndim == len(ph.spec) else P()))

    devices = list(mesh.devices.flat)
    before = _memory(devices)
    t = jax.tree_util.tree_map(place, ph.trim(ph.host))
    t0 = time.perf_counter()
    for _ in range(steps):
        t, m = ph.step_ex(t, jax.numpy.float32(1.0))
    jax.block_until_ready(t)
    wall = time.perf_counter() - t0
    after = _memory(devices)
    mem = None
    if base is not None:
        mem = {"peak_growth_per_device": peak_growth(before[0], base[1],
                                                     after[0]),
               "bytes_held_per_device": [a - b for a, b in
                                         zip(after[1], base[1])]}
    return {"state": jax.device_get(t), "div_post": float(m.div_post),
            "wall_s_incl_compile": wall, "memory": mem}


def run_four(builders, mesh, ref_device, steps=5) -> dict:
    """Build each phase from ``builders``, pairs (builder, n), then run
    every sharded step first, in the order given (smallest footprint
    first, so that each run raises every card's allocator peak), and
    only then the single-device step on ``ref_device`` from the same host
    state; compare the trimmed fields. Returns {name: figures}."""
    base = _memory(list(mesh.devices.flat))
    phases = [build(n, mesh) for build, n in builders]
    sharded = {ph.name: _run_sharded(ph, mesh, steps, base) for ph in phases}
    out = {}
    for ph in phases:
        sh = sharded[ph.name]
        step_ref = jax.jit(ph.case.step)
        with jax.default_device(ref_device):
            r = jax.device_put(ph.host, ref_device)
            for _ in range(steps):
                r, m_ref = step_ref(r, jax.numpy.float32(1.0))
        tr = ph.trim(jax.device_get(r))
        ok = compare({f: getattr(sh["state"], f) for f in ph.fields},
                     {f: getattr(tr, f) for f in ph.fields})
        out[ph.name] = {
            "n": ph.n, "mesh": dict(mesh.shape), "steps": steps,
            "sharded_wall_s_incl_compile": sh["wall_s_incl_compile"],
            "compare": ok, "memory": sh["memory"],
            "div_post_sharded": sh["div_post"],
            "div_post_single": float(m_ref.div_post)}
    return out


def four_phase_mac2d(n: int, mesh, seed=0) -> FourPhase:
    from jax.sharding import PartitionSpec as P

    from cfdsim_tpu.cases import lid_cavity_mac
    from cfdsim_tpu.parallel.mac_explicit import make_cavity_mac_explicit_step
    from cfdsim_tpu.parallel.mac_sharded import trim_state
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    # built on the host so nothing lands whole on one card
    with jax.default_device(jax.devices("cpu")[0]):
        case = lid_cavity_mac(n=n, Re=1000.0,
                              poisson=PoissonConfig(method="dct"))
        host = _random_mac_state(case, seed)
    return FourPhase("four_mac2d", n, case, host,
                     make_cavity_mac_explicit_step(case.cfg, mesh),
                     trim_state, P("y", "x"), ("u", "v", "p"))


def four_phase_mac3d(n: int, mesh, seed=1) -> FourPhase:
    from jax.sharding import PartitionSpec as P

    from cfdsim_tpu.cases import cavity3d_mac
    from cfdsim_tpu.parallel.mac3d_explicit import (
        make_cavity3d_mac_explicit_step, trim_state3d)

    with jax.default_device(jax.devices("cpu")[0]):
        case = cavity3d_mac(n=n, Re=1000.0, use_les=True)
        host = _random_mac_state(case, seed)
    return FourPhase("four_mac3d_les", n, case, host,
                     make_cavity3d_mac_explicit_step(case.cfg, mesh),
                     trim_state3d, P(None, "y", "x"), ("u", "v", "w", "p"))


def main(argv):
    _allow_cpu_reference()
    from cfdsim_tpu.utils.cache import enable_compilation_cache
    from cfdsim_tpu.utils.device import gpu_name_and_power_limit, require_gpu

    four = "--four" in argv
    device = require_gpu()
    smi = gpu_name_and_power_limit()
    print(smi, flush=True)
    emit("device", **device, nvidia_smi=smi, jax=jax.__version__,
         cache=str(enable_compilation_cache()))

    if four:
        from cfdsim_tpu.parallel.mesh import make_grid_mesh

        if device["count"] < 4:
            raise RuntimeError(f"--four needs 4 GPUs, found {device['count']}")
        mesh = make_grid_mesh(4)
        # 256³ first: its footprint per card is below 8192²'s
        builders = [(four_phase_mac3d, 256), (four_phase_mac2d, 8192)]
        for name, r in run_four(builders, mesh, jax.devices()[0]).items():
            emit(name, **r)
    else:
        emit("cli_cavity", **phase_cli(8192))
        emit("collocated", **phase_collocated(8192))
        jax.clear_caches()
        emit("mac", **phase_mac(8192))
        jax.clear_caches()
        emit("mac3d_les", **phase_mac3d(256))
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
