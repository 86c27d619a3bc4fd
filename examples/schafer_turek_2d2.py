"""Schäfer–Turek 2D-2 transient benchmark driver (FEM tier).

Runs the `schafer_turek_fem` case (channel [0,2.2]×[0,0.41], D=0.1
cylinder at (0.2,0.2), Re=100) to t_final and reports the published
quantities: tail-mean Cd, Strouhal from the lift FFT AND from lift
zero crossings, and the Cl amplitude. Published bands: Cd 3.22–3.24,
St 0.295–0.305, Cl amp ≈ ±1.0.

This is the reproducible form of the BENCHNOTES "FEM tier" transient
rows (projection P1-P1, PSPG monolithic, Taylor–Hood+SU). The
reference's Gridap family (v2.jl:373-439) runs the same geometry but
never measured the coefficients.

Run (CPU ~2.5 steps/s at 10.7k tris; H100 not measured):
    python examples/schafer_turek_2d2.py --scheme projection --t 12
    python examples/schafer_turek_2d2.py --scheme monolithic --stab pspg \
        --t 14   # the PSPG monolithic row
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def run(scheme="projection", stab="bp", space="p1p1", h_near=0.0035,
        h_far=0.015, wake_refine=True, dt=0.002, t_final=12.0,
        t_tail=None, supg=0.0, chunk_steps=50, verbose=True):
    from cfdsim_tpu.cases import build

    case = build(
        "schafer_turek_fem", re=100.0, space=space, scheme=scheme,
        stab=stab, supg=supg, h_near=h_near, h_far=h_far,
        wake_refine=wake_refine, dt=dt, theta=0.5,
    )
    coeff = case.extras["coeff_scale"]
    if verbose:
        print(f"mesh {case.extras['mesh'].n_tris} tris, scheme={scheme} "
              f"stab={stab} space={space} dt={dt}")

    def chunk(state, _):
        def body(s, _):
            s2, m = case.step(s, 1.0)
            return s2, (m.fx, m.fy, m.poisson_res)

        return jax.lax.scan(body, state, None, length=chunk_steps)

    chunk = jax.jit(chunk)
    state = case.state
    n_chunks = int(round(t_final / dt / chunk_steps))
    cd_h, cl_h = [], []
    t0 = time.perf_counter()
    for c in range(n_chunks):
        state, (fx, fy, res) = chunk(state, None)
        cd_h.append(np.asarray(fx) * coeff)
        cl_h.append(np.asarray(fy) * coeff)
        if verbose and (c % 10 == 9 or c == n_chunks - 1):
            el = time.perf_counter() - t0
            t_now = (c + 1) * chunk_steps * dt
            print(f"  t={t_now:6.2f}  Cd={cd_h[-1][-1]:6.3f}  "
                  f"Cl={cl_h[-1][-1]:+6.3f}  relres={float(res[-1]):.1e}  "
                  f"[{(c + 1) * chunk_steps / el:5.2f} steps/s]",
                  flush=True)
        if not np.isfinite(cd_h[-1][-1]):
            print("NON-FINITE force — aborting")
            return None

    cd = np.concatenate(cd_h)
    cl = np.concatenate(cl_h)
    t = dt * np.arange(1, len(cd) + 1)
    if t_tail is None:
        t_tail = 0.5 * t_final
    tail = t > t_tail
    # St from the lift FFT (dominant bin) and from zero crossings
    clt = cl[tail] - cl[tail].mean()
    spec = np.abs(np.fft.rfft(clt))
    freqs = np.fft.rfftfreq(len(clt), dt)
    f_fft = freqs[1:][np.argmax(spec[1:])]
    zc = np.where(np.diff(np.signbit(clt)))[0]
    f_zc = (0.5 * (len(zc) - 1) / (dt * (zc[-1] - zc[0]))
            if len(zc) > 2 else float("nan"))
    D, u_mean = case.extras["diameter"], case.extras["u_mean"]
    st_fft = f_fft * D / u_mean
    st_zc = f_zc * D / u_mean
    cd_mean = float(cd[tail].mean())
    cl_amp = float(0.5 * (cl[tail].max() - cl[tail].min()))
    print(f"\nRESULT {scheme}/{stab}/{space} "
          f"{case.extras['mesh'].n_tris} tris t={t_final:g}: "
          f"Cd={cd_mean:.3f} (inst {cd[-1]:.3f})  "
          f"St={st_fft:.3f} (FFT) / {st_zc:.3f} (ZC)  Cl_amp={cl_amp:.3f}"
          f"  [bands: Cd 3.22-3.24, St 0.295-0.305, Cl ~1.0]")
    return {"cd": cd_mean, "cd_inst": float(cd[-1]), "st": float(st_fft),
            "st_zc": float(st_zc), "cl_amp": cl_amp,
            "n_tris": case.extras["mesh"].n_tris}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--scheme", default="projection",
                   choices=["projection", "monolithic"])
    p.add_argument("--stab", default="bp", choices=["bp", "pspg"])
    p.add_argument("--space", default="p1p1", choices=["p1p1", "p2p1"])
    p.add_argument("--h-near", type=float, default=0.0035)
    p.add_argument("--h-far", type=float, default=0.015)
    p.add_argument("--no-wake", action="store_true")
    p.add_argument("--dt", type=float, default=0.002)
    p.add_argument("--t", type=float, default=12.0)
    p.add_argument("--tail", type=float, default=None)
    p.add_argument("--supg", type=float, default=0.0)
    a = p.parse_args()
    run(scheme=a.scheme, stab=a.stab, space=a.space, h_near=a.h_near,
        h_far=a.h_far, wake_refine=not a.no_wake, dt=a.dt, t_final=a.t,
        t_tail=a.tail, supg=a.supg)
