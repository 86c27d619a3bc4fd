"""Pseudo-spectral vorticity tier (models/spectral_ps.py): the
dissipation-free upgrade of the stable-fluids spectral solver.

Reference context: plot.jl:23-167 solves this flow with bilinear
semi-Lagrangian advection whose numerical viscosity damps the cascade
(BENCHNOTES "Kolmogorov spectrum"); the pseudo-spectral method's only
dissipation is the physical ν/α, which these tests pin exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfdsim_tpu.models import spectral_ps as ps


def _run(step, state, n):
    f = jax.jit(lambda s: jax.lax.scan(
        lambda st, _: step(st, None), s, None, length=n)[0])
    return f(state)


def _tg(n, m=4):
    y, x = np.meshgrid(np.arange(n) / n, np.arange(n) / n, indexing="ij")
    # ω of the Taylor–Green field u=sin cos, v=−cos sin at wavenumber m
    k = 2 * np.pi * m
    return -2 * k * np.sin(k * x) * np.sin(k * y)


def test_single_mode_viscous_friction_decay_exact():
    """With no forcing, a single Fourier mode decays EXACTLY by
    exp(−(νk²+α)t): the Strang-split integrating factor is exact for the
    linear terms and the mode's self-advection vanishes identically."""
    n, m, nu, alpha, dt = 64, 3, 2e-3, 0.3, 5e-3
    cfg = ps.PseudoSpectralConfig(ny=n, aspect=1.0, nu=nu, dt=dt,
                                  forcing_scale=0.0, linear_friction=alpha)
    y = np.arange(n) / n
    w0 = np.cos(2 * np.pi * m * y)[:, None] * np.ones((1, n))
    s = ps.init_state(cfg, w0=w0)
    steps = 200
    s = _run(ps.make_step(cfg), s, steps)
    wh = np.asarray(s.w_hat)
    w = np.fft.irfft2(wh[0] + 1j * wh[1], s=(n, n))
    k2 = (2 * np.pi * m) ** 2
    expect = w0 * np.exp(-(nu * k2 + alpha) * dt * steps)
    np.testing.assert_allclose(w, expect, atol=2e-5 * np.abs(w0).max())


def test_inviscid_taylor_green_conserves_energy():
    """The TG vortex is a steady Euler solution; with ν=α=0 the
    pseudo-spectral nonlinear term is zero to round-off, so energy is
    conserved to fp32 precision — the property the SL tier loses 89% of
    in one time unit (tests/test_spectral.py bfecc comparison)."""
    n = 96
    cfg = ps.PseudoSpectralConfig(ny=n, aspect=1.0, nu=0.0, dt=2e-3,
                                  forcing_scale=0.0)
    s0 = ps.init_state(cfg, w0=_tg(n))
    step = ps.make_step(cfg)
    u0, v0 = ps.velocities(cfg, s0)
    e0 = float(jnp.mean(u0**2 + v0**2))
    s = _run(step, s0, 500)  # t = 1.0
    u1, v1 = ps.velocities(cfg, s)
    e1 = float(jnp.mean(u1**2 + v1**2))
    assert abs(e1 - e0) / e0 < 1e-4, (e0, e1)


def test_forced_laminar_fixed_point():
    """Forcing per unit TIME: the laminar Kolmogorov profile saturates at
    u* = fs/(νk²+α) (continuous-time balance, to O(dt²) of the scheme) —
    this pins the forcing normalization the stable-fluids tier ties to dt."""
    n, kf, nu, alpha = 64, 8, 1e-3, 0.5
    cfg = ps.PseudoSpectralConfig(ny=n, aspect=1.0, nu=nu, dt=2e-3,
                                  forcing_wavenumber=kf, forcing_scale=0.05,
                                  linear_friction=alpha)
    s = _run(ps.make_step(cfg), ps.init_state(cfg), 8000)  # t = 16
    u, v = ps.velocities(cfg, s)
    k = np.pi * kf
    u_star = 0.05 / (nu * k * k + alpha)
    assert float(jnp.max(jnp.abs(u))) == pytest.approx(u_star, rel=5e-3)
    assert float(jnp.max(jnp.abs(v))) < 1e-4 * u_star


def test_dealias_mask_and_shapes():
    cfg = ps.PseudoSpectralConfig(ny=48, aspect=1.0)
    s = ps.init_state(cfg, noise=0.1, seed=1)
    # float32 re/im planes: complex exists only inside the jitted step
    assert s.w_hat.shape == (2, 48, 25) and s.w_hat.dtype == jnp.float32
    st, m = jax.jit(ps.make_step(cfg))(s, None)
    assert np.isfinite(np.asarray(st.w_hat)).all()
    assert float(m.energy) >= 0.0
    # modes beyond the 2/3 boundary are annihilated after one step
    w = np.asarray(st.w_hat)
    assert np.abs(w[:, :, 17:]).max() == 0.0  # kx cycles > 48/3
    assert np.abs(w[:, 17:48 - 16, :]).max() == 0.0  # |ky| cycles > 16


def test_sharded_ps_step_matches_single_device():
    """The pencil-FFT shard_map step (parallel/spectral_ps_explicit.py)
    reproduces the single-device tier on a 2x2 mesh: same Strang+SSP-RK3
    math through a different transform layout (full-complex pencils vs
    rfft half-spectrum), so real-space vorticity must agree to fp32
    round-off accumulated over the FFT round trips."""
    from cfdsim_tpu.parallel.mesh import make_grid_mesh
    from cfdsim_tpu.parallel.spectral_ps_explicit import (
        full_spectrum_state, make_ps_explicit_step)

    cfg = ps.PseudoSpectralConfig(ny=24, aspect=1.0, nu=1e-3, dt=5e-3,
                                  forcing_wavenumber=4, forcing_scale=0.3,
                                  linear_friction=0.2)
    s0 = ps.init_state(cfg, noise=0.3, seed=2)
    step1 = jax.jit(ps.make_step(cfg))
    mesh = make_grid_mesh(n_devices=4, topology=(2, 2))
    stepN = jax.jit(make_ps_explicit_step(cfg, mesh))

    s_single, s_shard = s0, full_spectrum_state(cfg, s0)
    for _ in range(5):
        s_single, m1 = step1(s_single, None)
        s_shard, mN = stepN(s_shard, None)
    wh = np.asarray(s_single.w_hat)
    w_single = np.fft.irfft2(wh[0] + 1j * wh[1], s=(24, 24))
    whN = np.asarray(s_shard.w_hat)
    w_shard = np.real(np.fft.ifft2(whN[0] + 1j * whN[1]))
    scale = np.abs(w_single).max()
    np.testing.assert_allclose(w_shard, w_single, atol=2e-5 * scale)
    np.testing.assert_allclose(float(mN.energy), float(m1.energy),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mN.enstrophy), float(m1.enstrophy),
                               rtol=1e-5)
