"""Stretched-grid MAC solver + fast-diagonalization Poisson (the
boundary-layer-refinement capability of the reference's gmsh/FEM path,
v1.jl:24-97, on structured grids)."""

import jax
import jax.numpy as jnp
import numpy as np

from cfdsim_tpu.models import mac
from cfdsim_tpu.models import mac_stretched as ms
from cfdsim_tpu.solvers.fdm import make_fdm_solver, neumann_operator_1d


def test_fdm_solves_stretched_operator_exactly():
    rng = np.random.RandomState(0)
    hx = 0.5 + rng.rand(24)
    hy = 0.5 + rng.rand(16)
    solve = make_fdm_solver(hx, hy)
    rhs = rng.randn(16, 24).astype(np.float32)
    w = np.outer(hy, hx)
    rhs = rhs - (w * rhs).sum() / w.sum()  # remove the nullspace component
    phi = np.asarray(solve(jnp.asarray(rhs)))
    Lx = neumann_operator_1d(hx)
    Ly = neumann_operator_1d(hy)
    res = Ly @ phi + phi @ Lx.T - rhs
    assert np.abs(res).max() < 1e-4 * np.abs(rhs).max()


def test_fdm_uniform_matches_dct():
    from cfdsim_tpu.solvers.poisson import solve_poisson_neumann_dct

    rng = np.random.RandomState(1)
    n = 32
    h = 1.0 / n
    solve = make_fdm_solver(np.full(n, h), np.full(n, h))
    rhs = jnp.asarray(rng.randn(n, n), jnp.float32)
    rhs = rhs - jnp.mean(rhs)
    a = np.asarray(solve(rhs))
    b = np.asarray(solve_poisson_neumann_dct(rhs, h, h))
    assert np.abs(a - b).max() < 1e-5 * max(np.abs(b).max(), 1e-6)


def test_fdm_analytic_uniform_eigs_match_numeric():
    """The analytic DCT-II eigenbasis (autotune's matmul candidate —
    O(n²) build) gives the same solve as the numeric eigendecomposition
    on a uniform grid, on non-square shapes."""
    from cfdsim_tpu.solvers.fdm import uniform_neumann_eigs

    rng = np.random.RandomState(2)
    n, m, dx, dy = 48, 32, 0.013, 0.021
    rhs = jnp.asarray(rng.randn(m, n), jnp.float32)
    rhs = rhs - jnp.mean(rhs)
    s_num = make_fdm_solver(np.full(n, dx), np.full(m, dy))
    s_ana = make_fdm_solver(
        np.full(n, dx), np.full(m, dy),
        eigs=(uniform_neumann_eigs(n, dx), uniform_neumann_eigs(m, dy)))
    a, b = np.asarray(s_num(rhs)), np.asarray(s_ana(rhs))
    assert np.abs(a - b).max() < 1e-5 * max(np.abs(a).max(), 1e-6)


def test_stretched_uniform_matches_mac_step():
    # on uniform faces the stretched step must reproduce models.mac
    from cfdsim_tpu.cases import lid_cavity_mac

    n = 32
    xf = np.linspace(0, 1, n + 1)
    cfg = ms.StretchedMACConfig(nx=n, ny=n, nu=0.01, cfl_target=0.5,
                                dt_max=0.5 / n)
    bcs = mac.cavity_bcs(1.0)
    step_s = jax.jit(ms.make_step(cfg, bcs, xf, xf))
    case_u = lid_cavity_mac(n=n, Re=100.0)
    step_u = jax.jit(case_u.step)
    ss, su = ms.init_state(cfg), case_u.state
    for _ in range(15):
        ss, _ = step_s(ss, jnp.float32(1.0))
        su, _ = step_u(su, jnp.float32(1.0))
    np.testing.assert_allclose(np.asarray(ss.u), np.asarray(su.u),
                               rtol=0, atol=5e-6)
    np.testing.assert_allclose(np.asarray(ss.v), np.asarray(su.v),
                               rtol=0, atol=5e-6)


def test_stretched_uniform_matches_mac_step_tvd():
    from cfdsim_tpu.cases import lid_cavity_mac

    n = 32
    xf = np.linspace(0, 1, n + 1)
    cfg = ms.StretchedMACConfig(nx=n, ny=n, nu=2.5e-3, scheme="tvd",
                                cfl_target=0.5, dt_max=0.5 / n)
    bcs = mac.cavity_bcs(1.0)
    step_s = jax.jit(ms.make_step(cfg, bcs, xf, xf))
    case_u = lid_cavity_mac(n=n, Re=400.0, scheme="tvd")
    step_u = jax.jit(case_u.step)
    ss, su = ms.init_state(cfg), case_u.state
    for _ in range(15):
        ss, _ = step_s(ss, jnp.float32(1.0))
        su, _ = step_u(su, jnp.float32(1.0))
    np.testing.assert_allclose(np.asarray(ss.u), np.asarray(su.u),
                               rtol=0, atol=5e-6)


def test_stretched_projection_exact():
    n = 40
    xf = ms.wall_clustered_faces(n, 1.0, beta=2.0)
    cfg = ms.StretchedMACConfig(nx=n, ny=n, nu=0.01, cfl_target=0.5,
                                dt_max=0.1 / n)
    bcs = mac.cavity_bcs(1.0)
    step = jax.jit(ms.make_step(cfg, bcs, xf, xf))
    s = ms.init_state(cfg)
    for _ in range(40):
        s, m = step(s, jnp.float32(1.0))
    assert np.all(np.isfinite(np.asarray(s.u)))
    # FDM projection leaves the stretched divergence at solver precision
    assert float(m.div_post) < 1e-3 * max(1.0, float(m.div_pre))


def test_face_generators_monotone_and_exact_span():
    xf = ms.wall_clustered_faces(33, 2.5, beta=2.0, x_min=-1.0)
    assert xf[0] == -1.0 and xf[-1] == 1.5
    assert np.all(np.diff(xf) > 0)
    # wall cells finer than center cells
    assert np.diff(xf)[0] < 0.3 * np.diff(xf)[16]

    xf2 = ms.stretched_faces(40, 10.0, refine=[(3.0, 1.0, 3.0)])
    assert xf2[0] == 0.0 and xf2[-1] == 10.0
    assert np.all(np.diff(xf2) > 0)
    h = np.diff(xf2)
    xc = 0.5 * (xf2[:-1] + xf2[1:])
    i_near = int(np.argmin(np.abs(xc - 3.0)))
    assert h[i_near] < 0.45 * h.max()


def test_cavity_stretched_beats_uniform_at_matched_cells():
    # short-horizon proxy of the measured result (full numbers in
    # BENCHNOTES): at matched cell count the wall-clustered grid develops
    # a sharper lid boundary layer (larger |u| gradient at the wall)
    from cfdsim_tpu.cases import cavity_stretched, lid_cavity_mac

    n = 48
    cs = cavity_stretched(n=n, Re=1000.0, beta=1.5)
    cu = lid_cavity_mac(n=n, Re=1000.0)

    def run(case, t_end=3.0):
        f = jax.jit(lambda s: jax.lax.scan(
            lambda st, _: case.step(st, jnp.float32(1.0)), s, None,
            length=200)[0])
        s = case.state
        while float(s.t) < t_end:
            s = f(s)
        return s

    ss, su = run(cs), run(cu)
    # wall-normal resolution of the lid layer: du/dy at the lid evaluated
    # with each grid's own first-row offset; the stretched grid's first
    # cell is ~3x finer so its measured wall gradient is closer to the
    # sharp truth (monotone in resolution for this layer)
    yf = cs.extras["y_faces"]
    dy_s = 1.0 - 0.5 * (yf[-1] + yf[-2])
    g_s = (1.0 - float(jnp.mean(ss.u[-1, 1:-1]))) / dy_s
    dy_u = 0.5 / n
    g_u = (1.0 - float(jnp.mean(su.u[-1, 1:-1]))) / dy_u
    assert g_s > g_u, (g_s, g_u)


def test_cylinder_stretched_healthy():
    from cfdsim_tpu.cases import cylinder_stretched

    case = cylinder_stretched(nx=96, ny=48, Re=100.0, ibm_ramp_steps=20,
                              perturb_ramp_steps=20)
    step = jax.jit(case.step)
    s = case.state
    for _ in range(80):
        s, m = step(s, jnp.float32(1.0))
    assert np.all(np.isfinite(np.asarray(s.u)))
    assert float(m.div_post) < 1e-3
    assert float(m.max_vel) < 3.0
    # refinement actually concentrates cells at the body
    h = np.diff(case.extras["x_faces"])
    assert case.extras["h_near"] < 0.5 * h.max()


def test_stretched_rk2_taylor_green_temporal():
    """time_scheme="rk2" on the stretched tier: with UNIFORM faces the
    stage equals the uniform MAC stage, so Heun must cut the temporal
    error exactly as in test_taylor_green.test_rk2_temporal_order —
    measured against a tiny-dt reference on the same grid."""
    import numpy as np

    from cfdsim_tpu.models import mac, mac_stretched as ms

    PI = np.pi
    n, NU, T = 24, 0.1, 0.4
    faces = np.linspace(0.0, PI, n + 1)

    def run(ts, dt):
        cfg = ms.StretchedMACConfig(
            nx=n, ny=n, nu=NU, scheme="central", time_scheme=ts,
            adaptive_dt=False, dt_base=dt, compute_metrics=False,
        )
        step = jax.jit(ms.make_step(cfg, mac.free_slip_bcs(), faces, faces))
        h = PI / n
        xu = np.arange(n + 1) * h
        yu = (np.arange(n) + 0.5) * h
        u0 = (np.sin(xu)[None, :] * np.cos(yu)[:, None]).astype(np.float32)
        v0 = (-np.cos(yu)[None, :] * np.sin(xu)[:, None]).T.astype(np.float32)
        xv = (np.arange(n) + 0.5) * h
        yv = np.arange(n + 1) * h
        v0 = (-np.cos(xv)[None, :] * np.sin(yv)[:, None]).astype(np.float32)
        s = ms.init_state(cfg)._replace(u=jnp.asarray(u0), v=jnp.asarray(v0))
        for _ in range(int(round(T / dt))):
            s, _ = step(s, jnp.float32(1.0))
        return np.asarray(s.u), np.asarray(s.v)

    ur, vr = run("rk2", 1e-3)
    def err(ts, dt):
        u, v = run(ts, dt)
        return np.sqrt(np.mean((u - ur) ** 2) + np.mean((v - vr) ** 2))

    e_eu = err("euler", 0.016)
    e_rk = err("rk2", 0.016)
    assert e_rk < 0.05 * e_eu  # 2nd order vs 1st at the same dt


def test_stretched3d_rk2_runs_divergence_free():
    """rk2 on the stretched 3D tier: graded cavity stays finite and
    exactly projected (the average of two FDM-projected stages)."""
    from cfdsim_tpu.cases import cavity3d_stretched

    case = cavity3d_stretched(n=12, Re=200.0, time_scheme="rk2")
    step = jax.jit(case.step)
    s = case.state
    for _ in range(8):
        s, m = step(s, jnp.float32(1.0))
    assert bool(jnp.isfinite(s.u).all())
    assert float(m.div_post) < 1e-4
