"""The reference's flagship v5 workflow, end to end, in JAX.

Reproduces `python/flow_over_cylinder (Fischer)/v5.py main()` (reference
v5.py:615-698): Re=600 flow over a cylinder on a 600×180 grid with SUPG,
artificial viscosity, IBM force ramp, fixed-dt warmup, adaptive dt,
periodic health checks, HDF5 snapshots every 200 steps — then deferred
frame rendering, an energy-history plot, and video assembly.

Differences from the reference (see PARITY.md): the whole hot loop is one
jitted scan on device; the Poisson solve is unmasked multigrid by default
(pass --ref-parity for the masked 1500-sweep red-black SOR of v5.py:202).

Run:  python examples/cylinder_reference_v5.py [--t-final 30.0] [--ref-parity]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--t-final", type=float, default=2.0,
                    help="simulated time (reference runs 30.0)")
    ap.add_argument("--ref-parity", action="store_true")
    ap.add_argument("--out", default="out/cylinder_v5")
    ap.add_argument("--snapshot-interval", type=int, default=200)
    args = ap.parse_args()

    from cfdsim_tpu.cases import cylinder
    from cfdsim_tpu.io_ import SnapshotWriter
    from cfdsim_tpu.runner import RunnerConfig, Simulation
    from cfdsim_tpu.utils.logging import setup_logging
    from cfdsim_tpu.viz import make_video, plot_energy_history, render_frames_from_hdf5

    out = Path(args.out)
    log = setup_logging("cylinder_v5", log_dir=out / "logs")

    # reference v5.py:616-634 configuration
    case = cylinder(
        nx=600, ny=180, Re=600.0, ref_parity=args.ref_parity,
        use_les=False, artificial_viscosity=1e-3,
    )
    writer = SnapshotWriter(out / "snapshots.h5")

    def snapshot(state, step, t):
        writer.save(step, t, u=state.u, v=state.v, p=state.p)

    sim = Simulation(
        case.step, case.state,
        RunnerConfig(
            t_final=args.t_final,
            chunk_steps=200,
            snapshot_interval=args.snapshot_interval,
            max_velocity=5.0,            # v5.py:66
            warmup_steps=1000,           # divergence threshold switch v5.py:611
            on_unhealthy="stop",         # v5 behavior (v5.py:657-660)
        ),
        case.grid.n_cells,
        snapshot_fn=snapshot,
        logger=log,
    )
    state, report = sim.run()
    print("run report:", report)

    render_frames_from_hdf5(
        out / "snapshots.h5", out / "frames", grid=case.grid,
        cylinder=(case.extras["center"], case.extras["radius"]),
    )
    plot_energy_history(sim.metrics_history, out / "energy_history.png")
    video = make_video(out / "frames" / "velocity_frames", out / "cylinder.mp4",
                       duration_s=10.0)
    print(f"artifacts: {out}/snapshots.h5, frames/, energy_history.png, {video}")


if __name__ == "__main__":
    main()
