"""The cylinder across the three solver tiers: collocated (reference
parity), uniform MAC (exact projection + TVD), and stretched MAC
(body/wake-refined grid + dense fast-diagonalization Poisson).

Runs each tier at a comparable cost budget, measures the Strouhal number
from a wake probe and the drag/lift coefficients from the IBM
penalization force, and prints a comparison table against the empirical
values (St ≈ 0.183 at Re=150; mean C_D ≈ 1.33 unconfined).

Run:  python examples/cylinder_accuracy_tiers.py [Re] [t_final]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def run_case(case, probe_xy, t_final, label):
    from cfdsim_tpu.validation import strouhal_number

    xg = case.extras.get("x_faces")
    if xg is not None:
        yf = case.extras["y_faces"]
        xc = 0.5 * (xg[:-1] + xg[1:])
        ix = int(np.argmin(np.abs(xc - probe_xy[0])))
        iy = int(np.argmin(np.abs(yf - probe_xy[1])))
    else:
        g = case.grid
        ix = int(round(probe_xy[0] / g.dx - 0.5))
        iy = int(round(probe_xy[1] / g.dy))

    step = case.step

    def chunk(s):
        def body(c, _):
            c2, m = step(c, jnp.float32(1.0))
            return c2, (m.dt, c2.v[iy, ix], m.fx, m.fy)

        return jax.lax.scan(body, s, None, length=1000)

    cj = jax.jit(chunk)
    s = case.state
    dts, probes, fxs, fys = [], [], [], []
    while float(s.t) < t_final:
        s, (dt, pv, fx, fy) = cj(s)
        dts.append(np.asarray(dt))
        probes.append(np.asarray(pv))
        fxs.append(np.asarray(fx))
        fys.append(np.asarray(fy))
    dts = np.concatenate(dts)
    probes = np.concatenate(probes)
    fxs = np.concatenate(fxs)
    fys = np.concatenate(fys)
    tg = np.cumsum(dts)
    sel = tg > 0.5 * tg[-1]
    tu = np.linspace(tg[sel][0], tg[-1], int(sel.sum()))
    pu = np.interp(tu, tg[sel], probes[sel])
    st = strouhal_number(pu, tu[1] - tu[0], 1.0, 1.0)
    cd = 2.0 * np.average(fxs[sel], weights=dts[sel])
    cl = 2.0 * 0.5 * (fys[sel].max() - fys[sel].min())
    print(f"{label:34s} cells={case.grid.n_cells/1e3:6.0f}k  "
          f"St={st:.3f}  mean C_D={cd:.3f}  C_L amp={cl:.3f}")
    return st, cd


def main(Re=150.0, t_final=150.0):
    from cfdsim_tpu.cases import cylinder, cylinder_mac, cylinder_stretched

    probe = (8.0, 4.0)
    print(f"Re={Re}: empirical St≈0.183 (Re=150) / 0.196 (Re=200); "
          f"mean C_D≈1.33 unconfined\n")
    run_case(
        cylinder_mac(nx=720, ny=240, Re=Re),
        probe, t_final, "uniform MAC 720x240 (tvd)",
    )
    run_case(
        cylinder_stretched(nx=384, ny=192, Re=Re),
        probe, t_final, "stretched MAC 384x192 (tvd)",
    )
    # collocated reference-style tier (its own geometry/probe)
    case = cylinder(nx=300, ny=90, Re=Re, domain=(15.0, 4.0),
                    center=(3.0, 2.0), dt_max=2e-3, warmup_steps=200,
                    warmup_dt=5e-4, ibm_ramp_steps=200)
    run_case(case, (5.0, 2.0), t_final, "collocated 300x90 (upwind, 25% blk)")


if __name__ == "__main__":
    Re = float(sys.argv[1]) if len(sys.argv) > 1 else 150.0
    tf = float(sys.argv[2]) if len(sys.argv) > 2 else 150.0
    main(Re, tf)
