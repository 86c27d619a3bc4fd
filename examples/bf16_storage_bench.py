"""bf16 inter-step velocity storage: the bandwidth experiment, measured.

Every tier is HBM-bound per the roofline table (BENCHNOTES); storing the
velocities in bf16 between steps halves the state's stencil-pass bytes
while keeping all compute (stencils + the Poisson solve) in fp32 — the
precision experiment VERDICT r4 #3 asked for, distinct from the invalid
bf16-*matmul* FDM incident (35% residual; solvers/fdm.py forces fp32
matmul precision since).

Measures marginal cell-updates/s (bench.py methodology: the per-call
dispatch constant cancels between two chunk lengths) for storage="fp32" vs
"bf16" on the collocated and MAC tiers at --n sizes, prints one row per
(tier, n, storage) plus the speedup.

Accuracy is a separate long run (cavity_accuracy_1024.py grew a
storage argv) — throughput alone never justifies adoption.

Usage: python examples/bf16_storage_bench.py [--n 1024 4096]
Reference anchor: v5.py:80-82 (the reference's own fp64->fp32 move).
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402

from bench import _timed_chunk  # noqa: E402


def measure(tier, n, storage, short=100, long=600):
    from cfdsim_tpu.cases import lid_cavity, lid_cavity_mac
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    if tier == "collocated":
        case = lid_cavity(
            n=n, Re=1000.0,
            poisson=PoissonConfig(method="dct", dct_variant="auto"),
            compute_metrics=False, storage=storage)
    else:
        case = lid_cavity_mac(
            n=n, Re=1000.0, poisson=PoissonConfig(method="dct"),
            compute_metrics=False, storage=storage)
    t1, _ = _timed_chunk(case, case.state, short)
    t2, sl = _timed_chunk(case, case.state, long)
    assert bool(jnp.all(jnp.isfinite(sl.u.astype(jnp.float32)))), "non-finite"
    return n * n * (long - short) / (t2 - t1)


def main(sizes, tiers=("collocated", "mac")):
    rows = []
    for tier in tiers:
        for n in sizes:
            r = {}
            for storage in ("fp32", "bf16"):
                cups = measure(tier, n, storage)
                r[storage] = cups
                print(json.dumps({
                    "metric": f"cells_per_sec_{tier}{n}_{storage}",
                    "value": cups, "unit": "cells/s"}), flush=True)
            rows.append((tier, n, r))
            print(f"  {tier}{n}: bf16/fp32 = {r['bf16'] / r['fp32']:.3f}x",
                  flush=True)
    print("\nRESULT bf16_storage_bench")
    for tier, n, r in rows:
        print(f"  {tier:10s} {n:5d}  fp32 {r['fp32']:.3e}  "
              f"bf16 {r['bf16']:.3e}  ratio {r['bf16'] / r['fp32']:.3f}")
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, nargs="+", default=[1024, 4096])
    p.add_argument("--tiers", nargs="+", default=["collocated", "mac"])
    a = p.parse_args()
    main(a.n, a.tiers)
