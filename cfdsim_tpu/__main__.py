"""Command-line interface: run cases, render frames, assemble videos.

The reference has no CLI — every solver is a hand-edited script
(SURVEY.md §0). Here:

    python -m cfdsim_tpu list
    python -m cfdsim_tpu run cavity --n 128 --t-final 5.0 --out out/cavity
    python -m cfdsim_tpu run wedge --nx 400 --ny 200 --t-final 1.5
    python -m cfdsim_tpu render out/cavity/snapshots.h5 out/cavity/frames
    python -m cfdsim_tpu video out/cavity/frames/velocity_frames movie.gif
    python -m cfdsim_tpu thin out/cavity/frames/velocity_frames --keep-every 3
    python -m cfdsim_tpu bench

Unknown ``--key value`` pairs on ``run`` are forwarded to the case builder
(ints/floats/bools auto-parsed), so any case parameter is reachable.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _parse_value(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    if v and v[0] in "([":
        # tuple/list literals, e.g. --viz-shape "(24,36)"
        import ast

        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
    return v


def _extra_kwargs(unknown: list[str]) -> dict:
    kwargs = {}
    i = 0
    while i < len(unknown):
        key = unknown[i]
        if not key.startswith("--"):
            raise SystemExit(f"unexpected argument {key!r}")
        name = key[2:].replace("-", "_")
        if i + 1 < len(unknown) and not unknown[i + 1].startswith("--"):
            kwargs[name] = _parse_value(unknown[i + 1])
            i += 2
        else:
            kwargs[name] = True
            i += 1
    return kwargs


DIV_THRESHOLD = 50.0
WARMUP_DIV_THRESHOLD = 20.0
# The collocated projection leaves max|div u| ∝ U/h at no-slip corners
# (max|div u|·h ≈ 0.02 for the cavity from 24² to 8192²), so its default
# bounds grow as 1/h past the absolute ones. The staggered, 3D and
# stretched projections keep the absolute bounds.
COLLOCATED_DIV_H = 0.5


def div_bounds(case, div_threshold=None) -> tuple[float, float]:
    """(bound, warmup bound) on max|div u| for ``run``'s health check. A
    ``--div-threshold`` given by the user is absolute for every case."""
    from cfdsim_tpu.models.incompressible import IncompressibleConfig

    if div_threshold is not None:
        return div_threshold, WARMUP_DIV_THRESHOLD
    if isinstance(case.cfg, IncompressibleConfig):
        floor = COLLOCATED_DIV_H / min(case.grid.dx, case.grid.dy)
        return max(DIV_THRESHOLD, floor), max(WARMUP_DIV_THRESHOLD, floor)
    return DIV_THRESHOLD, WARMUP_DIV_THRESHOLD


def cmd_list(_args, _extra):
    from cfdsim_tpu.cases import CASES

    for name, builder in sorted(CASES.items()):
        doc = (builder.__doc__ or "").strip().splitlines()[0]
        print(f"{name:20s} {doc}")


def cmd_run(args, extra):
    from cfdsim_tpu.cases import build
    from cfdsim_tpu.runner import RunnerConfig, Simulation
    from cfdsim_tpu.utils.logging import setup_logging

    out = Path(args.out or f"out/{args.case}")
    out.mkdir(parents=True, exist_ok=True)
    log = setup_logging("cfdsim_tpu", log_dir=out / "logs")
    case = build(args.case, **extra)

    snapshot_fn = None
    snap_path = out / ("snapshots.csnap" if args.io == "native" else "snapshots.h5")

    state = case.state
    if args.resume is not None:
        # actual checkpoint-restart (SURVEY.md §5: the reference only ever
        # writes snapshots, v5.py:454-470; we read them back): restore
        # fields + step + t from the latest snapshot and continue — the
        # appending writers skip already-present steps, so numbering in
        # the same file simply continues
        from cfdsim_tpu.io_ import restore

        src = Path(args.resume) if args.resume != "latest" else snap_path
        if src.suffix == ".csnap":
            from cfdsim_tpu.io_.native import csnap_to_hdf5

            src = csnap_to_hdf5(src, out / "_resume_tmp.h5")
        state = restore(case.state, src)
        log.info(
            "resumed %s from %s at t=%g step=%d",
            args.case, src, float(state.t), int(state.step),
        )

    writer = None
    if args.snapshot_interval > 0:
        if args.io == "native":
            from cfdsim_tpu.io_.native import NativeSnapshotWriter

            writer = NativeSnapshotWriter(snap_path)
        else:
            from cfdsim_tpu.io_ import SnapshotWriter

            writer = SnapshotWriter(snap_path)

        fem_sampler = (case.extras or {}).get("sampler")

        def snapshot_fn(state, step, t):
            if fem_sampler is not None:
                # unstructured FEM state: snapshot the sampled structured
                # fields so the deferred renderer works unchanged (the
                # reference also rasterizes before plotting, v2.jl:275-296)
                from cfdsim_tpu.fem.sample import sample_fields

                f = sample_fields(fem_sampler, state.u, state.p)
                writer.save(step, t, u=f["u"], v=f["v"], p=f["p"],
                            vorticity=f["vorticity"])
                return
            fields = {
                k: v
                for k in state._fields
                if hasattr(v := getattr(state, k), "ndim") and v.ndim >= 2
            }
            # nested states (e.g. transport's CoupledState.flow)
            for k in state._fields:
                v = getattr(state, k)
                if hasattr(v, "_fields"):
                    fields.update(
                        {
                            kk: vv
                            for kk in v._fields
                            if hasattr(vv := getattr(v, kk), "ndim") and vv.ndim >= 2
                        }
                    )
            writer.save(step, t, **fields)

    health_fn = None
    if args.case in ("wedge", "cavity_supersonic"):
        from cfdsim_tpu.monitor import check_compressible

        health_fn = lambda m, step: check_compressible(m)

    div_bound, warmup_div_bound = div_bounds(case, args.div_threshold)
    cfg = RunnerConfig(
        t_final=args.t_final,
        max_steps=args.max_steps,
        chunk_steps=args.chunk_steps,
        snapshot_interval=args.snapshot_interval,
        on_unhealthy=args.on_unhealthy,
        wall_clock_limit_s=args.wall_clock_limit,
        div_threshold=div_bound,
        warmup_div_threshold=warmup_div_bound,
        max_velocity=getattr(case.cfg, "max_velocity", 1e3)
        if not isinstance(case.cfg, tuple)
        else 1e3,
    )
    sim = Simulation(
        case.step, state, cfg, case.grid.n_cells,
        snapshot_fn=snapshot_fn, logger=log, health_fn=health_fn,
    )
    state, report = sim.run()
    if writer is not None and hasattr(writer, "close"):
        if hasattr(writer, "flush"):
            writer.flush()
        writer.close()
    print(json.dumps(report))
    if args.render and args.snapshot_interval > 0:
        h5 = snap_path
        if args.io == "native":
            from cfdsim_tpu.io_.native import csnap_to_hdf5

            h5 = csnap_to_hdf5(snap_path, out / "snapshots.h5")
        from cfdsim_tpu.viz import render_frames_from_hdf5

        fields = ("velocity", "vorticity")
        if hasattr(case.state, "theta"):  # scalar-coupled states
            fields = ("velocity", "vorticity", "temperature")
        mesh = (case.extras or {}).get("mesh")
        cyl = None
        if mesh is not None and "cylinder_center" in getattr(mesh, "geometry", {}):
            cyl = (mesh.geometry["cylinder_center"],
                   mesh.geometry["cylinder_radius"])
        render_frames_from_hdf5(h5, out / "frames", grid=case.grid,
                                fields=fields, cylinder=cyl)
        print(f"frames in {out / 'frames'}")
    return report


def cmd_render(args, _extra):
    from cfdsim_tpu.viz import render_frames_from_hdf5

    paths = render_frames_from_hdf5(args.snapshots, args.out)
    print(json.dumps({k: len(v) for k, v in paths.items()}))


def cmd_video(args, _extra):
    from cfdsim_tpu.viz import make_video

    out = make_video(args.frames, args.out, duration_s=args.duration)
    print(out)


def cmd_thin(args, _extra):
    from cfdsim_tpu.viz import thin_frames

    r = thin_frames(args.frames, keep_every=args.keep_every,
                    dry_run=args.dry_run,
                    confirm=not (args.yes or args.dry_run))
    print(json.dumps({"kept": r["kept"], "deleted": r["deleted"],
                      "aborted": r.get("aborted", False)}))


def cmd_bench(_args, _extra):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import bench

    bench.main([])


def main(argv=None):
    from cfdsim_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    p = argparse.ArgumentParser(prog="cfdsim_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list named cases")

    pr = sub.add_parser("run", help="run a named case")
    pr.add_argument("case")
    pr.add_argument("--t-final", type=float, default=1.0)
    pr.add_argument("--max-steps", type=int, default=10_000_000)
    pr.add_argument("--chunk-steps", type=int, default=100)
    pr.add_argument("--snapshot-interval", type=int, default=200)
    pr.add_argument("--io", choices=["hdf5", "native"], default="hdf5")
    pr.add_argument("--out", default=None)
    pr.add_argument("--on-unhealthy", choices=["stop", "backoff"], default="stop")
    pr.add_argument("--wall-clock-limit", type=float, default=0.0)
    pr.add_argument("--div-threshold", type=float, default=None,
                    help=f"health bound on max|div u| (default "
                         f"{DIV_THRESHOLD:g}, {WARMUP_DIV_THRESHOLD:g} in "
                         f"warmup; for the collocated projection at least "
                         f"{COLLOCATED_DIV_H:g}/h)")
    pr.add_argument("--render", action="store_true")
    pr.add_argument(
        "--resume", nargs="?", const="latest", default=None,
        metavar="SNAPSHOTS",
        help="resume from a snapshot file (bare --resume: the case's own "
             "snapshots file under --out)",
    )

    pv = sub.add_parser("render", help="render frames from snapshots")
    pv.add_argument("snapshots")
    pv.add_argument("out")

    pm = sub.add_parser("video", help="frames -> mp4/gif")
    pm.add_argument("frames")
    pm.add_argument("out")
    pm.add_argument("--duration", type=float, default=10.0)

    pt = sub.add_parser("thin", help="thin a frame directory")
    pt.add_argument("frames")
    pt.add_argument("--keep-every", type=int, default=2)
    pt.add_argument("--dry-run", action="store_true")
    pt.add_argument("--yes", "-y", action="store_true",
                    help="skip the interactive delete confirmation "
                         "(reference cleanup_python.py asks y/n)")

    sub.add_parser("bench", help="run the headline benchmark (GPU only)")

    args, unknown = p.parse_known_args(argv)
    extra = _extra_kwargs(unknown)
    return {
        "list": cmd_list,
        "run": cmd_run,
        "render": cmd_render,
        "video": cmd_video,
        "thin": cmd_thin,
        "bench": cmd_bench,
    }[args.cmd](args, extra)


if __name__ == "__main__":
    main()
