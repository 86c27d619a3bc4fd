"""CLI smoke tests (subprocess, CPU platform, tiny configs)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _cli(*args, timeout=420):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "cfdsim_tpu", *args],
        capture_output=True, text=True, env=env, timeout=timeout, cwd=REPO,
    )


def test_list_cases():
    r = _cli("list")
    assert r.returncode == 0
    for name in ("cavity", "cylinder", "wedge", "kolmogorov"):
        assert name in r.stdout


def test_run_render_video_thin(tmp_path):
    out = tmp_path / "run"
    r = _cli(
        "run", "cavity", "--n", "24", "--t-final", "0.2", "--chunk-steps", "10",
        "--snapshot-interval", "10", "--out", str(out),
        "--poisson", "jacobi:4",  # fast compile
    )
    assert r.returncode == 0, r.stderr[-2000:]
    report = json.loads(r.stdout.strip().splitlines()[-1])
    assert report["final_time"] >= 0.2
    assert (out / "snapshots.h5").exists()

    r = _cli("render", str(out / "snapshots.h5"), str(out / "frames"))
    assert r.returncode == 0, r.stderr[-2000:]
    counts = json.loads(r.stdout.strip().splitlines()[-1])
    assert counts["velocity"] >= 2

    r = _cli("video", str(out / "frames" / "velocity_frames"),
             str(out / "movie.gif"), "--duration", "1")
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out / "movie.gif").exists()

    # without --yes and no tty the interactive confirm refuses to delete
    r = _cli("thin", str(out / "frames" / "velocity_frames"), "--keep-every", "2")
    assert r.returncode == 0
    assert json.loads(r.stdout.strip().splitlines()[-1])["aborted"] is True
    r = _cli("thin", str(out / "frames" / "velocity_frames"),
             "--keep-every", "2", "--yes")
    assert r.returncode == 0
    assert json.loads(r.stdout.strip().splitlines()[-1])["deleted"] >= 0


def test_unknown_case_errors():
    r = _cli("run", "definitely_not_a_case", "--t-final", "0.1")
    assert r.returncode != 0
    assert "unknown case" in (r.stderr + r.stdout)


def test_every_registered_case_builds_and_steps():
    # the registry contract: every named case builds with tiny shapes and
    # advances one step with finite state
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cfdsim_tpu.cases import CASES, build

    tiny = {
        "cavity": dict(n=16),
        "cavity_mac": dict(n=16),
        "cavity_stretched": dict(n=16),
        "channel": dict(nx=32, ny=16),
        "cylinder": dict(nx=48, ny=24),
        "cylinder_mac": dict(nx=48, ny=16),
        "cylinder_stretched": dict(nx=48, ny=24),
        "cylinder_oscillating": dict(nx=48, ny=24, domain=(8.0, 4.0),
                                     center=(4.0, 2.0)),
        "wedge": dict(nx=40, ny=20),
        "cavity_supersonic": dict(nx=40, ny=16),
        "kolmogorov": dict(ny=18),
        "kolmogorov_ps": dict(ny=18, noise=0.01),
        "transport": dict(n=16),
        "cavity3d": dict(n=8),
        "cavity3d_mac": dict(n=8),
        "cavity3d_stretched": dict(n=8),
        "sphere": dict(nx=24, ny=12, nz=12, domain=(8.0, 4.0, 4.0),
                       center=(2.0, 2.0, 2.0), ibm_ramp_steps=2),
        "sphere_stretched": dict(
            nx=24, ny=12, nz=12, domain=(8.0, 4.0, 4.0),
            center=(2.0, 2.0, 2.0), refine_strength=1.0,
            refine_width=1.0, wake_length=1.0, ibm_ramp_steps=2,
        ),
        "heated_sphere": dict(nx=24, ny=12, nz=12, domain=(8.0, 4.0, 4.0),
                              center=(2.0, 2.0, 2.0), ibm_ramp_steps=2),
        "heated_sphere_stretched": dict(
            nx=24, ny=12, nz=12, domain=(8.0, 4.0, 4.0),
            center=(2.0, 2.0, 2.0), refine_strength=1.0,
            refine_width=1.0, wake_length=1.0, ibm_ramp_steps=2,
        ),
        "heated_cavity": dict(n=16),
        "rayleigh_benard": dict(ny=8, aspect=2.0),
        "heated_cube": dict(n=8),
        "blast3d": dict(n=12),
        "cylinder_fem": dict(
            h_far=0.5, h_near=0.12, viz_shape=(24, 36), gmres_tol=1e-4
        ),
        "schafer_turek_fem": dict(
            h_far=0.08, h_near=0.025, viz_shape=(24, 64), gmres_tol=1e-4
        ),
        "cavity_fem": dict(n=8, viz_shape=(16, 16), gmres_tol=1e-4),
    }
    assert set(tiny) == set(CASES), "update the tiny-shape table"
    for name, kw in tiny.items():
        case = build(name, **kw)
        state, metrics = jax.jit(case.step)(case.state, jnp.float32(1.0))
        leaves = jax.tree_util.tree_leaves(state)
        assert all(np.all(np.isfinite(np.asarray(x))) for x in leaves), name


def test_run_resume_bit_exact(tmp_path):
    """Kill-and-resume via the CLI matches an uninterrupted run bit-for-bit
    (VERDICT r2 item 7: io_.restore wired into `run --resume`)."""
    import h5py
    import numpy as np

    common = ["--n", "32", "--chunk-steps", "20", "--snapshot-interval", "20",
              "--poisson", "jacobi:8"]
    out_a = tmp_path / "a"
    out_b = tmp_path / "b"

    # interrupted run to t=0.3, then resume (from its own snapshot file)
    # out to t=0.6
    r = _cli("run", "cavity", "--t-final", "0.3", "--out", str(out_a), *common)
    assert r.returncode == 0, r.stderr[-2000:]
    r = _cli("run", "cavity", "--t-final", "0.6", "--out", str(out_a),
             "--resume", *common)
    assert r.returncode == 0, r.stderr[-2000:]
    report = json.loads(r.stdout.strip().splitlines()[-1])
    assert report["final_time"] >= 0.6

    # uninterrupted control to t=0.6
    r = _cli("run", "cavity", "--t-final", "0.6", "--out", str(out_b), *common)
    assert r.returncode == 0, r.stderr[-2000:]

    with h5py.File(out_a / "snapshots.h5") as fa, \
            h5py.File(out_b / "snapshots.h5") as fb:
        steps_a = {k for k in fa.keys() if k.startswith("step_")}
        steps_b = {k for k in fb.keys() if k.startswith("step_")}
        shared = sorted(steps_a & steps_b)
        # resume continued the numbering past the interruption point
        assert max(steps_a) >= max(shared)
        key = max(shared)
        assert int(key.split("_")[1]) * 1.0 > 0
        for field in ("u", "v", "p"):
            np.testing.assert_array_equal(fa[key][field][:], fb[key][field][:])
        assert fa[key].attrs["time"] == fb[key].attrs["time"]


@pytest.mark.parametrize("builder,n,given,expected", [
    ("lid_cavity", 16, None, (50.0, 20.0)),  # coarse: the absolute bounds
    ("lid_cavity", 256, None, "1/h"),  # fine collocated: 0.5/h
    ("lid_cavity_mac", 256, None, (50.0, 20.0)),  # exact projection
    ("lid_cavity", 256, 7.0, (7.0, 20.0)),  # a given bound is absolute
])
def test_div_bounds(builder, n, given, expected):
    from cfdsim_tpu import cases
    from cfdsim_tpu.__main__ import COLLOCATED_DIV_H, div_bounds

    case = getattr(cases, builder)(n=n)
    if expected == "1/h":
        b = COLLOCATED_DIV_H / min(case.grid.dx, case.grid.dy)
        assert b > 50.0
        expected = (b, b)
    assert div_bounds(case, given) == expected


def test_run_that_blows_up_is_stopped_by_the_divergence_check(tmp_path):
    # one Jacobi sweep per projection leaves the divergence to grow until
    # it passes the default bound, before the velocity bound trips
    r = _cli("run", "cavity", "--n", "24", "--Re", "1000",
             "--poisson", "jacobi:1", "--chunk-steps", "10",
             "--max-steps", "400", "--t-final", "100",
             "--out", str(tmp_path / "run"))
    assert r.returncode == 0, r.stderr[-2000:]
    report = json.loads(r.stdout.strip().splitlines()[-1])
    assert report["stopped_reason"].startswith("unhealthy: high divergence")
    assert report["final_step"] < 400
