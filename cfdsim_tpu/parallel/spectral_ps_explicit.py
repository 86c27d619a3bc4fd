"""Explicit shard_map pseudo-spectral vorticity step (multi-chip PS tier).

The distributed twin of ``models/spectral_ps.py``: the vorticity
spectrum lives block-sharded over the ("y","x") mesh as float32 re/im
planes, every 2D FFT runs as the classic pencil decomposition
(``parallel/transforms.py``: all_to_all to full-x rows, local 1D FFT,
transpose to full-y columns, local 1D FFT — on hardware the
all_to_alls cross devices), and the wavenumber/dealias/decay tables are
derived IN-TRACE from ``lax.axis_index`` + iota, so nothing is gathered
from closed-over constants (the shard_map gather-on-constants
miscompile, CLAUDE.md).

Differences from the single-device tier, by construction:
- FULL complex spectrum (ny, nx) instead of the rfft half-spectrum —
  nx/2+1 is odd and cannot ride the pencil divisibility rules; the
  redundant conjugate half costs 2× spectral memory/flops but keeps
  every all_to_all tiled and even.
- complex64 never appears in the state or the collectives: re/im
  float32 planes are exchanged separately and complex is assembled
  locally around each 1D FFT (the float layout mirrors the
  single-device state, ROADMAP Design 4).

Step math is identical (Strang half-decay + SSP-RK3 on advection+
forcing, 2/3 dealias on the nonlinear product) — equality-tested
against the single-device tier in tests/test_spectral_ps.py.

Layout: ny divisible by py·px and nx by px·py (pencil rules).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from cfdsim_tpu.models.spectral_ps import (
    PseudoSpectralConfig,
    PSMetrics,
    PSState,
)
from cfdsim_tpu.parallel.transforms import (
    from_x_pencil,
    from_y_pencil,
    to_x_pencil,
    to_y_pencil,
)


def _fft1_pair(zr, zi, axis, inverse):
    z = lax.complex(zr, zi)
    z = jnp.fft.ifft(z, axis=axis) if inverse else jnp.fft.fft(z, axis=axis)
    return jnp.real(z).astype(jnp.float32), jnp.imag(z).astype(jnp.float32)


def _fft2_pencil(zr, zi, py, px, inverse=False):
    """Distributed complex FFT2 on re/im float blocks (ny_l, nx_l)."""
    # x transform on full-x rows
    xr, xi = to_x_pencil(zr, px), to_x_pencil(zi, px)
    xr, xi = _fft1_pair(xr, xi, axis=1, inverse=inverse)
    zr, zi = from_x_pencil(xr, px), from_x_pencil(xi, px)
    # y transform on full-y columns
    yr, yi = to_y_pencil(zr, py), to_y_pencil(zi, py)
    yr, yi = _fft1_pair(yr, yi, axis=0, inverse=inverse)
    return from_y_pencil(yr, py), from_y_pencil(yi, py)


def _psum2(x):
    return lax.psum(lax.psum(x, "y"), "x")


def full_spectrum_state(cfg: PseudoSpectralConfig, state: PSState) -> PSState:
    """Host-side: single-device rfft half-spectrum state → full-spectrum
    (2, ny, nx) state for the sharded step (hermitian reconstruction via
    a real-space round trip)."""
    wh = np.asarray(state.w_hat)
    w = np.fft.irfft2(wh[0] + 1j * wh[1], s=(cfg.ny, cfg.nx))
    wc = np.fft.fft2(w)
    return PSState(
        w_hat=jnp.asarray(np.stack([wc.real, wc.imag]).astype(np.float32)),
        t=state.t, step=state.step)


def half_spectrum_state(cfg: PseudoSpectralConfig, state: PSState) -> PSState:
    """Host-side inverse of ``full_spectrum_state``."""
    wh = np.asarray(state.w_hat)
    w = np.real(np.fft.ifft2(wh[0] + 1j * wh[1]))
    wc = np.fft.rfft2(w)
    return PSState(
        w_hat=jnp.asarray(np.stack([wc.real, wc.imag]).astype(np.float32)),
        t=state.t, step=state.step)


def make_ps_explicit_step(cfg: PseudoSpectralConfig, mesh: Mesh):
    """Sharded step over ``mesh`` ("y","x"): state w_hat is the FULL
    complex spectrum as (2, ny, nx) float32, P(None, "y", "x")-sharded."""
    ny, nx = cfg.ny, cfg.nx
    py, px = mesh.shape["y"], mesh.shape["x"]
    ny_l, nx_l = ny // py, nx // px
    if ny_l % px or nx_l % py:
        raise ValueError(
            f"pencil layout needs ny_l % px == 0 and nx_l % py == 0; got "
            f"({ny_l},{nx_l}) blocks on a {py}x{px} mesh")
    dt = jnp.float32(cfg.dt)
    kf = cfg.forcing_wavenumber * np.pi
    fs = cfg.forcing_scale

    spec = P(None, "y", "x")
    state_spec = PSState(w_hat=spec, t=P(), step=P())
    metric_spec = PSMetrics(*([P()] * len(PSMetrics._fields)))

    def _tables():
        """Per-block spectral tables from global indices (in-trace)."""
        gy = lax.axis_index("y") * ny_l + lax.iota(jnp.int32, ny_l)
        gx = lax.axis_index("x") * nx_l + lax.iota(jnp.int32, nx_l)
        my = jnp.where(gy < ny // 2, gy, gy - ny).astype(jnp.float32)
        mx = jnp.where(gx < nx // 2, gx, gx - nx).astype(jnp.float32)
        KY = (2.0 * np.pi / cfg.ly) * my[:, None] * jnp.ones((1, nx_l))
        KX = (2.0 * np.pi / cfg.lx) * jnp.ones((ny_l, 1)) * mx[None, :]
        k2 = KX * KX + KY * KY
        inv_k2 = jnp.where(k2 > 0.0, 1.0 / jnp.maximum(k2, 1e-30), 0.0)
        dealias = ((jnp.abs(mx)[None, :] <= nx / 3.0)
                   & (jnp.abs(my)[:, None] <= ny / 3.0)).astype(jnp.float32)
        ehalf = jnp.exp(-0.5 * dt * (cfg.nu * k2 + cfg.linear_friction))
        # real-space forcing rows for this block's global y range
        y = (lax.axis_index("y") * ny_l
             + lax.iota(jnp.float32, ny_l)) / jnp.float32(ny)
        f_real = (-fs * kf) * jnp.cos(kf * y)[:, None] * jnp.ones((1, nx_l))
        return KX, KY, inv_k2, dealias, ehalf, f_real

    def _rhs(wr, wi, tables):
        KX, KY, inv_k2, dealias, _, f_real = tables
        pr, pi = wr * inv_k2, wi * inv_k2  # ψ̂ = ω̂ / k²
        # u = irfft(i·KY·ψ̂): i·(a+bi) = (−b+ai)
        ur, _ = _fft2_pencil(-KY * pi, KY * pr, py, px, inverse=True)
        vr, _ = _fft2_pencil(KX * pi, -KX * pr, py, px, inverse=True)
        wxr, _ = _fft2_pencil(-KX * wi, KX * wr, py, px, inverse=True)
        wyr, _ = _fft2_pencil(-KY * wi, KY * wr, py, px, inverse=True)
        rhs_real = -(ur * wxr + vr * wyr) + f_real
        rr, ri = _fft2_pencil(rhs_real, jnp.zeros_like(rhs_real), py, px)
        return rr * dealias, ri * dealias, ur, vr

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(state_spec, P()), out_specs=(state_spec, metric_spec))
    def step(state: PSState, _cfl):
        tables = _tables()
        ehalf = tables[4]
        wr, wi = ehalf * state.w_hat[0], ehalf * state.w_hat[1]
        n0r, n0i, ur, vr = _rhs(wr, wi, tables)
        w1r, w1i = wr + dt * n0r, wi + dt * n0i
        n1r, n1i, _, _ = _rhs(w1r, w1i, tables)
        w2r = 0.75 * wr + 0.25 * (w1r + dt * n1r)
        w2i = 0.75 * wi + 0.25 * (w1i + dt * n1i)
        n2r, n2i, _, _ = _rhs(w2r, w2i, tables)
        wnr = ehalf * (wr / 3.0 + (2.0 / 3.0) * (w2r + dt * n2r))
        wni = ehalf * (wi / 3.0 + (2.0 / 3.0) * (w2i + dt * n2i))
        new = PSState(w_hat=jnp.stack([wnr, wni]).astype(jnp.float32),
                      t=state.t + dt, step=state.step + 1)
        if cfg.compute_metrics:
            n_tot = jnp.float32(ny * nx)
            energy = 0.5 * _psum2(jnp.sum(ur * ur + vr * vr)) / n_tot
            maxv = lax.pmax(lax.pmax(
                jnp.max(jnp.sqrt(ur * ur + vr * vr)), "y"), "x")
            # enstrophy from the spectrum (Parseval: mean ω² = Σ|ω̂|²/N²)
            ens = 0.5 * _psum2(jnp.sum(wr * wr + wi * wi)) / (n_tot * n_tot)
            m = PSMetrics(dt=dt, max_vel=maxv, energy=energy, enstrophy=ens)
        else:
            z = jnp.float32(0.0)
            m = PSMetrics(dt=dt, max_vel=z, energy=z, enstrophy=z)
        return new, m

    return step
