"""Uniform flow past a sphere — the 3D IBM validation run.

The 3D habitat of the reference's flagship immersed-boundary capability
(cylinder IBM, v5.py:275-283): sharp-mask penalization on the staggered
mac3d tier, exact 3D DCT projection, TVD convection. Validates the
penalization drag against the Schiller–Naumann standard-drag correlation
and the rear recirculation length against Johnson & Patel (1999)
(L_r/D ≈ 0.87 at Re=100; steady axisymmetric wake below Re≈210).

Run (GPU or CPU):
    python examples/sphere_wake.py [--re 100] [--n 12] [--t 40]
``--n`` is cells per diameter (12 → 192×96×96 on the default box).
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp


def run_sphere(re: float = 100.0, cells_per_d: int = 12, t_final: float = 40.0,
               chunk_steps: int = 100, verbose: bool = True,
               stretched: bool = False, heated: bool = False,
               ibm_scheme: str = "penalize", theta_scheme: str | None = None):
    from cfdsim_tpu.cases import build
    from cfdsim_tpu.validation import (
        sphere_drag_schiller_naumann,
        sphere_nusselt_ranz_marshall,
    )

    n = cells_per_d
    if heated:
        name = "heated_sphere_stretched" if stretched else "heated_sphere"
    else:
        name = "sphere_stretched" if stretched else "sphere"
    kw = {}
    if ibm_scheme != "penalize":
        kw["ibm_scheme"] = ibm_scheme
    if theta_scheme is not None:
        kw["theta_scheme"] = theta_scheme
    case = build(
        name, nx=16 * n, ny=8 * n, nz=8 * n, Re=re,
        domain=(16.0, 8.0, 8.0), center=(4.0, 4.0, 4.0),
        ibm_ramp_steps=100, compute_metrics=True, **kw,
    )
    if stretched and verbose:
        print(f"  stretched grid: h_min={case.extras['h_min']:.4f} "
              f"({1 / case.extras['h_min']:.0f} cells/D near the body)")

    def chunk(state, _):
        def body(s, _):
            s2, m = case.step(s, 1.0)
            nus = m.nusselt if heated else jnp.float32(0.0)
            return s2, (m.fx, m.fy, m.fz, m.dt, nus)

        return jax.lax.scan(body, state, None, length=chunk_steps)

    chunk = jax.jit(chunk)
    state, cs = case.state, case.extras["coeff_scale"]
    t0 = time.perf_counter()
    cd = nu_meas = float("nan")
    while float(state.t) < t_final:
        state, (fx, fy, fz, dt, nus) = chunk(state, None)
        cd = float(fx[-1]) * cs
        nu_meas = float(nus[-1])
        if verbose:
            el = time.perf_counter() - t0
            extra = f"  Nu={nu_meas:6.3f}" if heated else ""
            print(f"  t={float(state.t):6.2f}  Cd={cd:6.3f}  "
                  f"Cl_y={float(fy[-1]) * cs:+7.4f}  "
                  f"Cl_z={float(fz[-1]) * cs:+7.4f}{extra}  "
                  f"[{float(state.step) / el:6.1f} steps/s]")

    # rear recirculation length from the centerline u(x): distance from
    # the rear stagnation point (x = center_x + R) to where u crosses
    # back to positive (Johnson & Patel 1999: L_r/D ≈ 0.87 at Re=100)
    g = case.grid
    jmid = g.ny // 2
    kmid = g.nz // 2
    u_line = 0.25 * (
        state.u[kmid - 1, jmid - 1] + state.u[kmid - 1, jmid]
        + state.u[kmid, jmid - 1] + state.u[kmid, jmid]
    )  # (nx+1,) at the y=z=4 centerline
    if stretched:
        xf = jnp.asarray(case.extras["x_faces"], jnp.float32)
    else:
        xf = g.x_min + jnp.arange(g.nx + 1) * g.dx
    cx, r = case.extras["center"][0], case.extras["radius"]
    behind = xf > cx + r
    neg = (u_line < 0.0) & behind
    l_r = jnp.where(
        neg.any(), jnp.max(jnp.where(neg, xf, -jnp.inf)) - (cx + r), 0.0
    )
    l_r_d = float(l_r) / (2 * r)
    cd_sn = sphere_drag_schiller_naumann(re)
    if verbose:
        print(f"sphere Re={re:g} at {n} cells/D: Cd={cd:.3f} "
              f"(Schiller-Naumann {cd_sn:.3f}, {(cd / cd_sn - 1) * 100:+.1f}%)"
              f"  L_r/D={l_r_d:.2f} (J&P Re=100: 0.87)")
    out = {"cd": cd, "cd_sn": cd_sn, "l_r_d": l_r_d}
    if heated:
        nu_rm = sphere_nusselt_ranz_marshall(re)
        if verbose:
            print(f"  Nu={nu_meas:.3f} (Ranz-Marshall {nu_rm:.3f}, "
                  f"{(nu_meas / nu_rm - 1) * 100:+.1f}%)")
        out.update({"nu": nu_meas, "nu_rm": nu_rm})
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--re", type=float, default=100.0)
    ap.add_argument("--n", type=int, default=12,
                    help="cells per diameter (nominal for --stretched)")
    ap.add_argument("--t", type=float, default=40.0)
    ap.add_argument("--stretched", action="store_true",
                    help="body+wake-refined stretched grid "
                         "(~2.5x the near-body resolution per cell)")
    ap.add_argument("--heated", action="store_true",
                    help="isothermal sphere: forced-convection Nusselt "
                         "vs Ranz-Marshall (heated_sphere case)")
    ap.add_argument("--ibm", default="penalize",
                    choices=["penalize", "ghost"],
                    help="IBM scheme (ghost = sharp-interface ghost-cell "
                         "direct forcing; --stretched only)")
    ap.add_argument("--theta-scheme", default=None,
                    choices=["upwind", "central", "tvd"],
                    help="θ face scheme for --heated (tvd = van Leer "
                         "MUSCL, kills the upwind thermal-BL diffusion)")
    args = ap.parse_args()
    run_sphere(re=args.re, cells_per_d=args.n, t_final=args.t,
               stretched=args.stretched, heated=args.heated,
               ibm_scheme=args.ibm, theta_scheme=args.theta_scheme)
