"""Roofline accounting for solver steps (VERDICT r2 item 4).

Round 2 reported cells/s only; "fast" was unquantified. This module
derives flops/cell and HBM bytes/cell analytically from the *compiled*
step graph (XLA's post-fusion cost analysis — exact for the graph that
actually runs, no hand counting), measures the machine's achievable
flop and HBM-bandwidth peaks with two microbenchmarks, and classifies
each tier as compute- or bandwidth-bound with its roofline ceiling:

    ceiling(cells/s) = min(peak_flops / flops_per_cell,
                           peak_bw / bytes_per_cell)

``%of roof`` close to 1 means the step runs at the speed of light for
its arithmetic intensity against the measured peaks; the same
flops/bytes per cell against the device's published peaks
(``PUBLISHED_PEAKS``) give the data-sheet ceiling.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

# Published per-device peaks, keyed by ``jax.Device.device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates
# (no sparsity), at the full 700 W power limit.
PUBLISHED_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_sec": 3.35e12,
        "fp32_flops": 67e12,
        "tf32_flops": 495e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet (SXM, dense)",
    },
}

# precision of measure_peaks' matmul: true fp32 ("default" runs the
# product in TF32 on an H100)
MATMUL_PRECISION = "highest"

_peaks_cache: dict = {}


def published_peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; an unknown device is an error,
    not a default."""
    try:
        return PUBLISHED_PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            f"PUBLISHED_PEAKS with its source") from None


def step_costs(step_fn, state, *args) -> dict:
    """flops and HBM bytes of one compiled step (post-fusion HLO cost
    analysis; bytes = operand + output traffic of every fused op)."""
    c = jax.jit(step_fn).lower(state, *args).compile().cost_analysis()
    if isinstance(c, list):
        c = c[0]
    flops = float(c.get("flops", 0.0))
    by = c.get("bytes accessed")
    if by is None:
        by = sum(v for k, v in c.items()
                 if k.startswith("bytes accessed") and isinstance(v, float))
    return {"flops": flops, "bytes": float(by),
            "transcendentals": float(c.get("transcendentals", 0.0))}


def marginal_seconds(body, x, r1: int, r2: int) -> float:
    """Marginal per-iteration seconds of ``body`` between scan lengths r1
    and r2 — the per-call dispatch constant cancels out, leaving device
    time.  Each run ends in ``jax.block_until_ready``."""

    def run(reps):
        f = jax.jit(lambda v: jax.lax.scan(
            lambda c, _: (body(c), None), v, None, length=reps)[0])
        jax.block_until_ready(f(x))  # compile + execute
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(f(x))
            best = min(best, time.perf_counter() - t0)
        return best

    t1, t2 = run(r1), run(r2)
    m = (t2 - t1) / (r2 - r1)
    # noise can invert the marginal; fall back to the long-run average
    # (conservative: still includes the constant)
    return m if m > 0 else t2 / r2


def measure_peaks(n_mm: int = 2048, copy_mb: int = 256) -> dict:
    """Achievable peaks on the live device: matmul flops/s at
    ``MATMUL_PRECISION`` and elementwise copy bytes/s.  Both are measured
    marginally inside a lax.scan chain so the per-call dispatch constant
    cancels."""
    key = (n_mm, copy_mb)
    if key in _peaks_cache:
        return _peaks_cache[key]
    a = jnp.full((n_mm, n_mm), 1.0 / n_mm, jnp.float32)

    # one n³ matmul per scan iteration; rescale keeps values O(1)
    sec = marginal_seconds(
        lambda x: jnp.matmul(x, x, precision=MATMUL_PRECISION), a, 4, 24)
    flops = 2.0 * n_mm**3 / sec

    n = int(copy_mb * 1e6 / 4)
    x = jnp.ones((n,), jnp.float32)
    sec = marginal_seconds(lambda v: v * 1.0000001 + 0.1, x, 8, 48)
    bw = 2.0 * n * 4 / sec  # one read + one write stream per iteration

    _peaks_cache[key] = {"peak_flops": flops, "peak_bw": bw,
                         "matmul_precision": MATMUL_PRECISION}
    return _peaks_cache[key]


def roofline(step_fn, state, n_cells: int, measured_cells_per_sec=None,
             peaks=None, *step_args, published=None) -> dict:
    """Roofline row for one tier: per-cell costs, the bound, the ceiling
    against the measured ``peaks``, the ceiling against the device's
    ``published`` peaks (a ``PUBLISHED_PEAKS`` entry, fp32 flops and HBM
    bandwidth) when given, and (if a measured rate is given) the
    fraction of the roof actually achieved."""
    costs = step_costs(step_fn, state, *step_args)
    f_c = costs["flops"] / n_cells
    b_c = costs["bytes"] / n_cells
    pk = peaks or measure_peaks()
    roof_flops = pk["peak_flops"] / max(f_c, 1e-12)
    roof_bw = pk["peak_bw"] / max(b_c, 1e-12)
    ceiling = min(roof_flops, roof_bw)
    row = {
        "flops_per_cell": f_c,
        "bytes_per_cell": b_c,
        "intensity_flops_per_byte": f_c / max(b_c, 1e-12),
        "bound": "compute" if roof_flops < roof_bw else "bandwidth",
        "ceiling_cells_per_sec": ceiling,
    }
    if published is not None:
        row["published_ceiling_cells_per_sec"] = min(
            published["fp32_flops"] / max(f_c, 1e-12),
            published["hbm_bytes_per_sec"] / max(b_c, 1e-12),
        )
    if measured_cells_per_sec is not None:
        row["measured_cells_per_sec"] = measured_cells_per_sec
        row["pct_of_roof"] = 100.0 * measured_cells_per_sec / ceiling
    return row
