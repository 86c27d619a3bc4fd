"""Rossiter feedback modes of the Mach-2.5 open cavity (L/D = 2).

The reference's supersonic-cavity flagship (cavity_flow_v1.py:38-87:
600×180, NG=2, M=2.5, CFL 0.3) validated QUANTITATIVELY: wall-pressure
probes in/around the cavity, a Hann-windowed tail PSD, and the measured
tone frequencies compared against the semi-empirical Rossiter formula

    St_m = f_m L / U_inf = (m - gamma_r) / (M + 1/kappa),

kappa ~= 0.57, gamma_r ~= 0.25, and its Heller-Bliss correction (the
standard form above M ~ 1.5; the cavity sound speed is the stagnation
value, so M -> M / sqrt(1 + (g-1)/2 M^2)):

    St_m = (m - gamma_r) / (M/sqrt(1 + (g-1)/2 M^2) + 1/kappa).

At M = 2.5: Rossiter St_1..3 = 0.176, 0.411, 0.646; Heller-corrected
St_1..3 = 0.219, 0.512, 0.804.  Accepted agreement for this formula
class is ~10-15%.

Probes (cavity x in [0.5, 1.0], depth 0.25 at the defaults):
  0: aft wall, mid-depth   (x=0.98, y=0.12) — the classic Rossiter tap
  1: cavity floor, aft     (x=0.95, y=0.02)
  2: above the trailing lip (x=1.00, y=0.30) — meaningful in BOTH
     geometry modes (the pin-state mode freezes the cavity interior to
     quiescent fluid each step, reference parity cavity_flow_v1.py:165-170,
     so probes 0-1 carry no acoustics there; the shear-layer/lip tone is
     what that mode can show).

Usage:
    python examples/cavity_rossiter.py --t 60 --geometry real
    python examples/cavity_rossiter.py --t 60 --geometry pin
"""

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

KAPPA = 0.57
GAMMA_R = 0.25


def rossiter_modes(mach, gamma=1.4, n_modes=3, heller=False):
    """Predicted Strouhal numbers St_m = f_m L/U for modes m=1..n."""
    m_eff = mach / np.sqrt(1 + 0.5 * (gamma - 1) * mach**2) if heller else mach
    return np.array([(m - GAMMA_R) / (m_eff + 1.0 / KAPPA)
                     for m in range(1, n_modes + 1)])


def _atomic_savez(path, **arrays):
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def run(nx=600, ny=180, mach=2.5, t_final=60.0, t_tail=10.0,
        chunk_steps=2000, real_geometry=True, save=None, verbose=True,
        **case_kw):
    from cfdsim_tpu.cases import build
    from cfdsim_tpu.models.compressible import cons_to_prim

    case = build("cavity_supersonic", nx=nx, ny=ny, mach=mach,
                 real_geometry=real_geometry, **case_kw)
    cfg, grid = case.cfg, case.grid
    L = 0.5  # cavity length (case default)
    U_inf = float(case.extras["U_inf"][1] / case.extras["U_inf"][0])

    xs, ys = grid.x_coords(), grid.y_coords()
    pts = [(0.98, 0.12), (0.95, 0.02), (1.00, 0.30)]
    idx = [(int(np.abs(ys - y).argmin()), int(np.abs(xs - x).argmin()))
           for x, y in pts]

    def probe_p(U):
        g = cfg.gamma
        p = (g - 1.0) * (U[3] - 0.5 * (U[1] ** 2 + U[2] ** 2)
                         / jnp.maximum(U[0], cfg.eps))
        return jnp.stack([p[j, i] for (j, i) in idx])

    def chunk(state, _):
        def body(s, _):
            s2, m = case.step(s, 1.0)
            return s2, (s2.t, m.dt, probe_p(s2.U), m.min_rho, m.min_p)

        return jax.lax.scan(body, state, None, length=chunk_steps)

    chunk = jax.jit(chunk)
    state = case.state
    hist_t, hist_p = [], []
    t0 = time.perf_counter()
    while float(state.t) < t_final:
        state, (tt, dts, pp, min_rho, min_p) = chunk(state, None)
        hist_t.append(np.asarray(tt))
        hist_p.append(np.asarray(pp))
        if not (np.isfinite(hist_p[-1][-1]).all() and float(min_rho[-1]) > 0):
            print("NON-FINITE state — aborting")
            return None
        if verbose:
            el = time.perf_counter() - t0
            print(f"  t={float(state.t):7.2f}  p_aft={hist_p[-1][-1][0]:7.3f}"
                  f"  p_lip={hist_p[-1][-1][2]:7.3f}"
                  f"  [{float(state.step) / el:7.0f} steps/s]", flush=True)
        if save:
            _atomic_savez(save, t=np.concatenate(hist_t),
                          p=np.concatenate(hist_p),
                          probe_pts=np.asarray(pts))

    t = np.concatenate(hist_t)
    p = np.concatenate(hist_p)  # (n_steps, 3)
    tail = t > t_tail
    tu = np.linspace(t[tail][0], t[tail][-1], int(tail.sum()))
    n = len(tu)
    win = np.hanning(n)
    freqs = np.fft.rfftfreq(n, tu[1] - tu[0])
    st_axis = freqs * L / U_inf

    psd = np.zeros((p.shape[1], len(freqs)))
    for k in range(p.shape[1]):
        sig = np.interp(tu, t[tail], p[tail, k])
        psd[k] = np.abs(np.fft.rfft((sig - sig.mean()) * win)) ** 2

    # mode table: for each prediction, the tallest PSD peak within +-25%
    ross = rossiter_modes(mach)
    hell = rossiter_modes(mach, heller=True)
    probe_for_mode = 2 if not real_geometry else 0
    rows = []
    for m, (sr, sh) in enumerate(zip(ross, hell), start=1):
        lo, hi = 0.75 * min(sr, sh), 1.25 * max(sr, sh)
        band = (st_axis >= lo) & (st_axis <= hi)
        if band.sum() < 3:
            continue
        st_meas = float(st_axis[band][np.argmax(psd[probe_for_mode][band])])
        rows.append((m, st_meas, sr, sh,
                     100 * (st_meas / sr - 1), 100 * (st_meas / sh - 1)))

    # global dominant peaks (context): top-5 local maxima of the probe PSD
    s = psd[probe_for_mode]
    interior = (st_axis > 0.05) & (st_axis < 1.5)
    locmax = np.r_[False, (s[1:-1] > s[:-2]) & (s[1:-1] > s[2:]), False]
    cand = np.where(locmax & interior)[0]
    top = cand[np.argsort(s[cand])[::-1][:5]]
    peaks = sorted(float(st_axis[i]) for i in top)

    geom = "real" if real_geometry else "pin"
    print(f"\nRESULT cavity_rossiter M={mach:g} L/D=2 {nx}x{ny} "
          f"geometry={geom} t={t_final:g} (tail t>{t_tail:g}, "
          f"probe {probe_for_mode} at {pts[probe_for_mode]})")
    print(f"  dominant PSD peaks (St_L): "
          f"{', '.join(f'{q:.3f}' for q in peaks)}")
    print("  mode |  measured | Rossiter (err) | Heller (err)")
    for m, st_meas, sr, sh, er, eh in rows:
        print(f"   {m}   |   {st_meas:.3f}   |  {sr:.3f} ({er:+5.1f}%) |"
              f"  {sh:.3f} ({eh:+5.1f}%)")
    if save:
        _atomic_savez(save, t=t, p=p, probe_pts=np.asarray(pts),
                      st_axis=st_axis, psd=psd,
                      rossiter=ross, heller=hell)
        print(f"series saved to {save}")
    return {"t": t, "p": p, "st_axis": st_axis, "psd": psd,
            "rows": rows, "peaks": peaks}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=600)
    ap.add_argument("--ny", type=int, default=180)
    ap.add_argument("--mach", type=float, default=2.5)
    ap.add_argument("--t", type=float, default=60.0)
    ap.add_argument("--tail", type=float, default=10.0)
    ap.add_argument("--geometry", default="real", choices=["real", "pin"])
    ap.add_argument("--save", default=None)
    ap.add_argument("--flux", default="rusanov",
                    choices=["rusanov", "hllc", "roe"],
                    help="rusanov = reference parity; hllc resolves the "
                         "cavity shear layer the Rossiter loop feeds on")
    ap.add_argument("--av", type=float, default=1e-3,
                    help="artificial viscosity (reference default 1e-3 "
                         "damps the feedback loop below unity gain)")
    a = ap.parse_args()
    run(nx=a.nx, ny=a.ny, mach=a.mach, t_final=a.t, t_tail=a.tail,
        real_geometry=(a.geometry == "real"), save=a.save,
        flux=a.flux, artificial_viscosity=a.av)
