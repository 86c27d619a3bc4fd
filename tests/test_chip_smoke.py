"""chip_smoke.py off the card: its comparison rule, its phases at tiny
sizes (the CPU standing in for the card), the ``--four`` phases on 4 of
the 8 virtual CPU devices, and its refusal to run without a GPU."""

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from cfdsim_tpu.parallel.mesh import make_grid_mesh  # noqa: E402


def _fields(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((8, 8)).astype(np.float32)
            for k in ("u", "v", "p")}


def test_compare_accepts_roundoff():
    ref = _fields()
    card = {k: v * (1 + 1e-6) for k, v in ref.items()}
    out = chip_smoke.compare(card, ref)
    assert set(out) == {"u", "v", "p"}
    assert all(r["max_abs_diff"] <= r["bound"] for r in out.values())


def test_compare_rejects_a_difference_beyond_the_bound():
    ref = _fields()
    card = dict(ref, v=ref["v"] + 1e-2)
    # a uniform shift of v is a real difference ...
    with pytest.raises(AssertionError, match=r"\['v'\]"):
        chip_smoke.compare(card, ref)


def test_compare_ignores_the_pressure_constant():
    # ... but p is fixed only up to a constant by the Neumann solve
    ref = _fields()
    card = dict(ref, p=ref["p"] + 3.0)
    assert chip_smoke.compare(card, ref)["p"]["max_abs_diff"] < 1e-6


def test_compare_velocity_bound_uses_the_largest_component():
    ref = _fields()
    ref["v"] = ref["v"] * 1e-3  # a small component keeps u's scale
    out = chip_smoke.compare(dict(ref), ref)
    assert out["v"]["bound"] == pytest.approx(
        chip_smoke.TOL * float(np.abs(ref["u"]).max()))


@pytest.mark.parametrize("bad", ["nan", "shape"])
def test_compare_rejects_nonfinite_and_misshapen(bad):
    ref = _fields()
    card = dict(ref)
    card["u"] = (np.full_like(ref["u"], np.nan) if bad == "nan"
                 else ref["u"][:4])
    with pytest.raises(AssertionError, match="u"):
        chip_smoke.compare(card, ref)


def test_phase_cli_runs_the_headline_case_small(tmp_path, capsys):
    r = chip_smoke.phase_cli(32)
    assert r["n"] == 32 and r["smoke_figures"]["wall_s"] > 0
    assert '"final_step": 60' in capsys.readouterr().out


def test_phase_collocated_small():
    r = chip_smoke.phase_collocated(32, warm_steps=10, check_steps=2)
    assert r["dct_autotune"]["variant"]
    assert r["cells"] == 32 * 32 and r["smoke_figures"]["compile_s"] > 0
    assert set(r["compare"]) == {"u", "v", "p"}


def test_phase_mac_small():
    r = chip_smoke.phase_mac(32, warm_steps=5, check_steps=2)
    assert set(r["compare"]) == {"u", "v", "p"}
    assert r["div_post_card"] < 1e-3  # exact projection


def test_phase_mac3d_les_small():
    r = chip_smoke.phase_mac3d(16, warm_steps=3, check_steps=2)
    assert set(r["compare"]) == {"u", "v", "w", "p"}


@pytest.mark.parametrize("phase,n", [("four_phase_mac2d", 32),
                                     ("four_phase_mac3d", 16)])
def test_four_phases_on_four_virtual_devices(phase, n):
    mesh = make_grid_mesh(4)
    assert dict(mesh.shape) == {"y": 2, "x": 2}
    (r,) = chip_smoke.run_four([(getattr(chip_smoke, phase), n)], mesh,
                               jax.devices()[0]).values()
    assert r["n"] == n and r["steps"] == 5
    assert r["memory"] is None  # the CPU keeps no allocator figures
    assert r["div_post_sharded"] < 1e-3


def test_run_four_runs_every_sharded_step_before_the_references():
    calls = []

    def logged(tag, fn):
        def run(*a):
            calls.append(tag)
            return fn(*a)
        return run

    def builder(phase):
        def build(n, mesh):
            ph = phase(n, mesh)
            case = dataclasses.replace(
                ph.case, step=logged("single:" + ph.name, ph.case.step))
            return ph._replace(case=case,
                               step_ex=logged("sharded:" + ph.name,
                                              ph.step_ex))
        return build

    mesh = make_grid_mesh(4)
    out = chip_smoke.run_four(
        [(builder(chip_smoke.four_phase_mac3d), 16),
         (builder(chip_smoke.four_phase_mac2d), 32)], mesh, jax.devices()[0])
    assert list(out) == ["four_mac3d_les", "four_mac2d"]
    last_sharded = max(i for i, c in enumerate(calls)
                       if c.startswith("sharded:"))
    first_single = min(i for i, c in enumerate(calls)
                       if c.startswith("single:"))
    assert last_sharded < first_single


def test_peak_growth_counts_from_the_base():
    assert chip_smoke.peak_growth([5, 5, 5, 5], [1, 1, 1, 1],
                                  [11, 12, 11, 11]) == [10, 11, 10, 10]


@pytest.mark.parametrize("peak_after,match", [
    ([11, 5, 11, 11], "did not rise on cards \\[1\\]"),  # a card left out
    ([41, 11, 11, 11], "uneven"),  # a table whole on the first card
])
def test_peak_growth_rejects(peak_after, match):
    with pytest.raises(AssertionError, match=match):
        chip_smoke.peak_growth([5, 5, 5, 5], [1, 1, 1, 1], peak_after)


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_refuses_to_run_without_a_gpu(argv, capsys):
    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.main(argv)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.gpu
def test_collocated_on_the_card_matches_cpu(gpu):
    r = chip_smoke.phase_collocated(256, warm_steps=20, check_steps=5)
    assert r["smoke_figures"]["memory"]["device_peak_bytes"] > 0
