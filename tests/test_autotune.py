"""Autotuned exact-DCT dispatch (solvers/autotune.py): every variant is
exact and identical; the auto dispatch measures once and caches."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfdsim_tpu.solvers import autotune
from cfdsim_tpu.solvers.poisson import (
    PoissonConfig,
    poisson_residual,
    solve_poisson,
)


@pytest.fixture()
def rhs():
    rng = np.random.default_rng(3)
    r = rng.standard_normal((48, 64)).astype(np.float32)
    return jnp.asarray(r - r.mean())


@pytest.mark.parametrize("variant", ["rfft", "rfft2", "rfft_split",
                                     "rfft_split4", "rfft_split8",
                                     "packed", "matmul"])
def test_every_variant_is_exact_and_identical(rhs, variant):
    dx, dy = 1.0 / 64, 1.0 / 48
    cfg = PoissonConfig(method="dct", dct_variant=variant)
    phi = solve_poisson(jnp.zeros_like(rhs), rhs, dx, dy, cfg)
    res = float(poisson_residual(phi, rhs, dx, dy, None, "neumann"))
    assert res < 5e-3 * float(jnp.max(jnp.abs(rhs)))  # exact to fp32
    ref = solve_poisson(jnp.zeros_like(rhs), rhs, dx, dy,
                        PoissonConfig(method="dct"))
    np.testing.assert_allclose(np.asarray(phi), np.asarray(ref),
                               rtol=0, atol=2e-4)


def test_auto_dispatch_measures_once_and_caches(rhs, tmp_path, monkeypatch):
    monkeypatch.setenv("CFDSIM_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("CFDSIM_DCT_VARIANT", raising=False)
    autotune._MEM.clear()
    dx, dy = 1.0 / 64, 1.0 / 48
    v1 = autotune.best_dct_variant(rhs.shape, dx, dy)
    assert v1 in autotune._VARIANTS
    data = json.loads((tmp_path / "autotune.json").read_text())
    key = next(iter(data))
    assert data[key]["variant"] == v1
    assert set(data[key]["ms"]) <= set(autotune._VARIANTS)
    assert all(t > 0 for t in data[key]["ms"].values())
    # a fresh process (cleared _MEM) must hit the disk cache, not re-time
    autotune._MEM.clear()
    monkeypatch.setattr(autotune, "measure_dct_variants",
                        lambda *a: pytest.fail("re-measured despite cache"))
    assert autotune.best_dct_variant(rhs.shape, dx, dy) == v1

    # the jitted solve path picks it up (dct_variant="auto" resolves at
    # trace time with a concrete shape)
    cfg = PoissonConfig(method="dct", dct_variant="auto")
    phi = jax.jit(
        lambda r: solve_poisson(jnp.zeros_like(r), r, dx, dy, cfg)
    )(rhs)
    ref = solve_poisson(jnp.zeros_like(rhs), rhs, dx, dy,
                        PoissonConfig(method="dct"))
    np.testing.assert_allclose(np.asarray(phi), np.asarray(ref),
                               rtol=0, atol=2e-4)


def test_env_force_overrides(monkeypatch):
    monkeypatch.setenv("CFDSIM_DCT_VARIANT", "matmul")
    assert autotune.best_dct_variant((8, 8), 0.1, 0.1) == "matmul"


def test_roofline_costs_and_classification():
    from cfdsim_tpu.cases import lid_cavity_mac
    from cfdsim_tpu.utils.roofline import (
        published_peaks, roofline, step_costs)

    case = lid_cavity_mac(n=32, Re=100.0)
    costs = step_costs(case.step, case.state, jnp.float32(1.0))
    assert costs["flops"] > 32 * 32  # at least O(cells) work
    assert costs["bytes"] > 32 * 32 * 4
    published = published_peaks("NVIDIA H100 80GB HBM3")
    row = roofline(case.step, case.state, 32 * 32, 1e6,
                   {"peak_flops": 1e12, "peak_bw": 1e11},
                   jnp.float32(1.0), published=published)
    assert row["bound"] in ("compute", "bandwidth")
    assert row["ceiling_cells_per_sec"] > 0
    assert 0 < row["pct_of_roof"] < 1e6
    # the data-sheet ceiling sits above the one from the slower peaks
    assert (row["published_ceiling_cells_per_sec"]
            > row["ceiling_cells_per_sec"])
