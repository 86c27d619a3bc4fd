"""Dütsch et al. (1998) KC=5, Re=100 in-line oscillating cylinder:
run `cylinder_oscillating` and least-squares fit the in-line body force
to the Morison decomposition

    F(t) = C_D · (D/2) · u_b|u_b|  +  C_m · (πD²/4) · a_b      (ρ = 1)

Published: C_D ≈ 2.09; the inertia coefficient carries the
penalization's fluid-in-body acceleration ρV·a ≡ +1 exactly, so the
added mass is C_m − 1 ≈ 1.45. BENCHNOTES "Moving-geometry IBM" has the
penalization ladder (uniform 20 c/D: C_D +22%; stretched 70 c/D:
+3.1%); `--ibm ghost` runs the moving sharp-interface ghost forcing
(ibm_ghost.moving_ghost_forcing_2d) on the uniform grid.

Run (accelerator; time on the H100 not measured):
    python examples/cylinder_oscillating_fit.py --ibm ghost --periods 4
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def run(ibm="ghost", nx=480, ny=240, periods=4.0, chunk_steps=200,
        verbose=True):
    from cfdsim_tpu.cases import build

    case = build("cylinder_oscillating", nx=nx, ny=ny, ibm_scheme=ibm)
    T = case.extras["period"]
    A = case.extras["amplitude"]
    D = 2 * case.extras["radius"]
    om = 2 * np.pi / T

    def chunk(state, _):
        def body(s, _):
            s2, m = case.step(s, jnp.float32(1.0))
            return s2, (m.fx, s2.t)

        return jax.lax.scan(body, state, None, length=chunk_steps)

    chunk = jax.jit(chunk)
    state = case.state
    ts, fxs = [], []
    t0 = time.perf_counter()
    while float(state.t) < periods * T:
        state, (fx, tt) = chunk(state, None)
        ts.append(np.asarray(tt))
        fxs.append(np.asarray(fx))
        if verbose:
            el = time.perf_counter() - t0
            print(f"  t={float(state.t):6.2f}/{periods * T:.0f}  "
                  f"fx={fxs[-1][-1]:+7.3f}  "
                  f"[{float(state.step) / el:6.1f} steps/s]", flush=True)

    t = np.concatenate(ts)
    fx = np.concatenate(fxs)
    tail = t > T  # drop the first period (startup transient)
    tt = t[tail]
    # body kinematics: x_c = x0 + A sin(ωt) → u_b = Aω cos, a_b = -Aω² sin
    ub = A * om * np.cos(om * tt)
    ab = -A * om * om * np.sin(om * tt)
    basis = np.stack([0.5 * D * ub * np.abs(ub),
                      0.25 * np.pi * D * D * ab], axis=1)
    coef, res, *_ = np.linalg.lstsq(basis, fx[tail], rcond=None)
    fit = basis @ coef
    rel_res = float(np.linalg.norm(fx[tail] - fit)
                    / np.linalg.norm(fx[tail]))
    cd, cm = float(abs(coef[0])), float(abs(coef[1]))
    print(f"\nRESULT ibm={ibm} {nx}x{ny} ({D / (24.0 / nx):.0f} cells/D): "
          f"C_D={cd:.3f} (pub 2.09, {100 * (cd / 2.09 - 1):+.1f}%)  "
          f"C_m-1={cm - 1:.3f} (pub ~1.45, "
          f"{100 * ((cm - 1) / 1.45 - 1):+.1f}%)  fit residual {rel_res:.1%}")
    return {"cd": cd, "cm": cm, "rel_res": rel_res}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--ibm", default="ghost", choices=["ghost", "penalize"])
    p.add_argument("--nx", type=int, default=480)
    p.add_argument("--ny", type=int, default=240)
    p.add_argument("--periods", type=float, default=4.0)
    a = p.parse_args()
    run(ibm=a.ibm, nx=a.nx, ny=a.ny, periods=a.periods)
