"""Unstructured-FEM cylinder flow — the reference's Julia/Gridap driver
(v2.jl:373-439 ``run_efficient_simulation``) on the JAX FEM tier.

Per-Re loop: graded mesh → steady Stokes init → semi-implicit NS steps
(one jitted GMRES solve per step, scanned in chunks) → sampled-field
frames + MP4/GIF, plus what the reference never computed: reaction-force
drag/lift histories and a Strouhal number from the lift oscillation.

Run:  python examples/cylinder_fem.py [Re ...] [--t-final T] [--space p1p1|p2p1]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def run_re(re, t_final=150.0, space="p1p1", wake_refine=True,
           out_dir=None, n_frames=40, chunk_steps=50, verbose=True,
           **case_kw):
    from cfdsim_tpu.cases import build
    from cfdsim_tpu.fem.sample import sample_fields

    case = build(
        "cylinder_fem", re=re, space=space, wake_refine=wake_refine,
        **case_kw,
    )
    ops = case.extras["ops"]
    if verbose:
        print(f"Re={re}: mesh {case.extras['mesh'].n_tris} tris, "
              f"{ops.n_u} velocity nodes ({space})")

    def chunk(state, _):
        def body(s, _):
            s2, m = case.step(s, 1.0)
            return s2, (m.fx, m.fy)

        return jax.lax.scan(body, state, None, length=chunk_steps)

    chunk = jax.jit(chunk)
    state = case.state
    n_chunks = int(round(t_final / case.cfg.dt / chunk_steps))
    frame_every = max(1, n_chunks // max(n_frames, 1))
    fx_hist, fy_hist, frames = [], [], []
    t0 = time.perf_counter()
    for ci in range(n_chunks):
        state, (fx, fy) = chunk(state, None)
        fx_hist.append(np.asarray(fx))
        fy_hist.append(np.asarray(fy))
        if out_dir is not None and ci % frame_every == 0:
            f = sample_fields(case.extras["sampler"], state.u, state.p)
            frames.append((float(state.t), jax.device_get(f)))
        if verbose and (ci + 1) % max(1, n_chunks // 10) == 0:
            el = time.perf_counter() - t0
            print(f"  t={float(state.t):7.2f}  Cd={2*fx_hist[-1][-1]:6.3f} "
                  f"Cl={2*fy_hist[-1][-1]:+6.3f}  "
                  f"[{(ci+1)*chunk_steps/el:6.1f} steps/s]")

    fx = np.concatenate(fx_hist)
    fy = np.concatenate(fy_hist)
    dt = case.cfg.dt
    st, cd_mean, cl_amp = shedding_stats(fx, fy, dt)
    if verbose:
        print(f"Re={re}: St={st:.3f}  mean Cd={cd_mean:.3f}  "
              f"Cl amplitude={cl_amp:.3f}")

    if out_dir is not None:
        save_frames(frames, case, Path(out_dir) / f"Re_{int(re)}", verbose)
    return {"St": st, "Cd": cd_mean, "Cl_amp": cl_amp,
            "fx": fx, "fy": fy, "state": state, "case": case}


def shedding_stats(fx, fy, dt, tail_frac=0.5):
    """Strouhal from the dominant lift-oscillation frequency (f·D/V∞,
    D=V∞=1), mean drag coefficient, lift amplitude — over the tail of
    the run (shedding established)."""
    n = len(fy)
    tail = slice(int(n * tail_frac), n)
    cl = 2.0 * fy[tail]
    cd = 2.0 * fx[tail]
    cl0 = cl - cl.mean()
    spec = np.abs(np.fft.rfft(cl0 * np.hanning(len(cl0))))
    freqs = np.fft.rfftfreq(len(cl0), d=dt)
    st = float(freqs[np.argmax(spec)])
    return st, float(cd.mean()), float(np.abs(cl0).max())


def save_frames(frames, case, out_dir, verbose=True):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir.mkdir(parents=True, exist_ok=True)
    g = case.grid
    X, Y = np.meshgrid(g.x_coords(), g.y_coords())
    geo = case.extras["mesh"].geometry
    for i, (t, f) in enumerate(frames):
        for name, cmap, data, lim in (
            ("vorticity", "plasma", f["vorticity"], 2.0),
            ("velocity", "viridis", f["speed"], None),
        ):
            fig, ax = plt.subplots(figsize=(8, 5), dpi=100)
            if lim:
                scale = np.nanquantile(np.abs(data), 0.9) + 1e-9
                cf = ax.pcolormesh(X, Y, np.clip(data / scale, -lim, lim),
                                   cmap=cmap, vmin=-lim, vmax=lim)
            else:
                cf = ax.pcolormesh(X, Y, data, cmap=cmap, vmin=0, vmax=1.5)
            from matplotlib import patches

            ax.add_patch(patches.Circle(geo["cylinder_center"],
                                        geo["cylinder_radius"],
                                        facecolor="black", edgecolor="white"))
            ax.set_aspect("equal")
            ax.set_title(f"{name}, t={t:.1f}")
            fig.savefig(out_dir / f"{name}_{i:04d}.png",
                        bbox_inches="tight")
            plt.close(fig)
    try:
        from cfdsim_tpu.viz.video import make_video

        for name in ("vorticity", "velocity"):
            make_video(out_dir, out_dir / f"{name}.mp4",
                       pattern=f"{name}_*.png", fps=10)
        if verbose:
            print(f"frames + video in {out_dir}")
    except Exception as e:  # pragma: no cover
        if verbose:
            print(f"video skipped: {e}")


def run_schafer_turek(t_final=8.0, space="p1p1", chunk_steps=100,
                      verbose=True, **case_kw):
    """Schäfer–Turek 2D-2 benchmark driver: published targets at Re=100
    are Cd≈3.22–3.24, Cl amplitude ≈1.0, St≈0.295–0.305."""
    from cfdsim_tpu.cases import build

    case = build("schafer_turek_fem", space=space, **case_kw)
    scale = case.extras["coeff_scale"]
    if verbose:
        print(f"S-T 2D-2: mesh {case.extras['mesh'].n_tris} tris, "
              f"{case.extras['ops'].n_u} velocity nodes")

    def chunk(state, _):
        def body(s, _):
            s2, m = case.step(s, 1.0)
            return s2, (m.fx, m.fy)

        return jax.lax.scan(body, state, None, length=chunk_steps)

    chunk = jax.jit(chunk)
    state = case.state
    n_chunks = int(round(t_final / case.cfg.dt / chunk_steps))
    fx_hist, fy_hist = [], []
    t0 = time.perf_counter()
    for ci in range(n_chunks):
        state, (fx, fy) = chunk(state, None)
        fx_hist.append(np.asarray(fx))
        fy_hist.append(np.asarray(fy))
        if verbose and (ci + 1) % max(1, n_chunks // 16) == 0:
            el = time.perf_counter() - t0
            cl = scale * fy_hist[-1]
            # report the chunk's lift RANGE, not one sample — a shedding
            # period that divides the print interval phase-aliases
            # single-sample prints into misleading constants
            print(f"  t={float(state.t):6.3f}  Cd={scale*fx_hist[-1][-1]:6.3f} "
                  f"Cl=[{cl.min():+6.3f},{cl.max():+6.3f}]  "
                  f"[{(ci+1)*chunk_steps/el:6.1f} steps/s]", flush=True)
    fx = np.concatenate(fx_hist) * scale / 2.0  # shedding_stats re-doubles
    fy = np.concatenate(fy_hist) * scale / 2.0
    # Strouhal: f·D/ū with D=0.1, ū=1 → multiply raw frequency by 0.1
    st_raw, cd_mean, cl_amp = shedding_stats(fx, fy, case.cfg.dt)
    D = case.extras["diameter"]
    u_mean = case.extras["u_mean"]
    st = st_raw * D / u_mean
    if verbose:
        print(f"S-T 2D-2: St={st:.3f} (target 0.295-0.305)  "
              f"Cd={cd_mean:.3f} (target 3.22-3.24)  "
              f"Cl_amp={cl_amp:.3f} (target ~1.0)")
    return {"St": st, "Cd": cd_mean, "Cl_amp": cl_amp, "fx": fx, "fy": fy,
            "state": state, "case": case}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("re", nargs="*", type=float, default=[100.0])
    ap.add_argument("--t-final", type=float, default=150.0)
    ap.add_argument("--space", default="p1p1", choices=["p1p1", "p2p1"])
    ap.add_argument("--no-wake-refine", action="store_true")
    ap.add_argument("--out", default="out/cylinder_fem")
    ap.add_argument("--schafer-turek", action="store_true",
                    help="run the 2D-2 benchmark instead")
    ap.add_argument("--scheme", default="monolithic",
                    choices=["monolithic", "projection"],
                    help="projection = segregated solver: converged "
                    "solves at >=10k tris and the benchmark-band St "
                    "(BENCHNOTES); add supg=1.0 via --space p2p1 runs")
    args = ap.parse_args()
    if args.schafer_turek:
        kw = {"scheme": args.scheme}
        if args.space == "p2p1" and args.scheme == "projection":
            kw["supg"] = 1.0  # P2 Galerkin convection needs SU
        run_schafer_turek(t_final=args.t_final, space=args.space, **kw)
        return
    for re in args.re or [100.0]:
        run_re(re, t_final=args.t_final, space=args.space,
               wake_refine=not args.no_wake_refine, out_dir=args.out)


if __name__ == "__main__":
    main()
