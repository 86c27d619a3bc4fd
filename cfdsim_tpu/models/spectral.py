"""Periodic spectral "stable fluids" solver (Kolmogorov flow).

JAX rebuild of the reference's FFTW solver
(julia/youtube_kolmogorov_turbulence/plot.jl:23-167): per step —
(1) sinusoidal body force, (2) semi-Lagrangian self-advection by
backtracing + bilinear interpolation, (3) mean-velocity subtraction,
(4) rfft → spectral diffusion decay exp(−ν dt k²) → pseudo-pressure
projection û −= k̂(k̂·û) → irfft, (5) mean subtraction. The FFTs run on
the XLA FFT; the backtrace interpolation uses periodic bilinear gathers.

The reference uses *integer* (cycles-per-domain) wavenumbers in the decay
factor (plot.jl:42), which under-diffuses by (2π)² on a unit domain;
``angular_wavenumbers=True`` (default) uses the physically scaled
k = 2π·cycles/L, ``False`` reproduces the reference exactly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class SpectralState(NamedTuple):
    u: jax.Array  # (ny, nx)
    v: jax.Array
    t: jax.Array
    step: jax.Array


class SpectralMetrics(NamedTuple):
    dt: jax.Array
    max_vel: jax.Array
    energy: jax.Array
    max_div: jax.Array  # spectral divergence after projection (≈ 0)


@dataclasses.dataclass(frozen=True)
class SpectralConfig:
    ny: int = 360
    aspect: float = 16.0 / 9.0
    nu: float = 1e-3
    dt: float = 0.01
    forcing_wavenumber: int = 8  # force_x = scale·sin(k·π·y) (plot.jl:47)
    forcing_scale: float = 0.1
    # Ekman/linear drag −α·u, applied spectrally as û *= exp(−α dt).
    # plot.jl has no large-scale sink, so its inverse cascade piles into
    # a box-scale condensate (BENCHNOTES "Kolmogorov spectrum"); α > 0
    # arrests the cascade at k_α ~ (α³/ε)^(1/2) and makes the k^-5/3
    # range stationary. 0 = reference parity.
    linear_friction: float = 0.0
    # "sl" = the reference's bilinear semi-Lagrangian backtrace
    # (plot.jl:84-97; first-order, numerical viscosity ∝ dx²/dt damps
    # the inertial flux). "bfecc" = BFECC/MacCormack error compensation
    # (fwd + ½(f − bwd), clamped to the advected 3×3 bounds, Selle et
    # al. 2008): second-order, 4× the gather cost (fwd/bwd/lo/hi), recovers most of
    # the cascade flux the bilinear trace dissipates.
    advection: str = "sl"  # sl | bfecc
    angular_wavenumbers: bool = True
    compute_metrics: bool = True

    @property
    def nx(self) -> int:
        return int(self.ny * self.aspect)

    @property
    def lx(self) -> float:
        return self.nx / self.ny  # unit-height domain (plot.jl:25-28)

    @property
    def ly(self) -> float:
        return 1.0


def init_state(cfg: SpectralConfig, u0=None, v0=None) -> SpectralState:
    shape = (cfg.ny, cfg.nx)
    z = jnp.zeros(shape, jnp.float32)
    return SpectralState(
        u=z if u0 is None else jnp.asarray(u0, jnp.float32),
        v=jnp.zeros(shape, jnp.float32) if v0 is None else jnp.asarray(v0, jnp.float32),
        t=jnp.float32(0.0),
        step=jnp.int32(0),
    )


def _wavenumbers(cfg: SpectralConfig):
    """(kx, ky, k_norm, kx_hat, ky_hat, decay) arrays on the rfft2 grid
    (ny, nx//2+1). Projection uses unit-normalized k̂ (scale-free); the
    diffusion decay honors ``angular_wavenumbers``."""
    kx_c = np.fft.rfftfreq(cfg.nx) * cfg.nx / cfg.lx  # cycles per unit length
    ky_c = np.fft.fftfreq(cfg.ny) * cfg.ny / cfg.ly
    KX, KY = np.meshgrid(kx_c, ky_c)
    norm = np.sqrt(KX**2 + KY**2)
    norm_safe = np.where(norm == 0.0, 1.0, norm)
    kx_hat = KX / norm_safe
    ky_hat = KY / norm_safe
    scale = 2.0 * np.pi if cfg.angular_wavenumbers else 1.0
    decay = np.exp(-cfg.dt * (cfg.nu * (scale * norm) ** 2
                              + cfg.linear_friction))
    return (
        jnp.asarray(KX, jnp.float32),
        jnp.asarray(KY, jnp.float32),
        jnp.asarray(kx_hat, jnp.float32),
        jnp.asarray(ky_hat, jnp.float32),
        jnp.asarray(decay, jnp.float32),
    )


def _advect_semi_lagrangian(field, u, v, dt, cfg: SpectralConfig):
    """Backtrace grid points by dt·velocity and bilinearly interpolate with
    periodic wrap (plot.jl:84-97). Coordinates are in grid-index units."""
    ny, nx = field.shape
    iy = jax.lax.broadcasted_iota(jnp.float32, (ny, nx), 0)
    ix = jax.lax.broadcasted_iota(jnp.float32, (ny, nx), 1)
    # index spacing: dx = lx/nx
    x_back = ix - dt * u * (nx / cfg.lx)
    y_back = iy - dt * v * (ny / cfg.ly)
    return jax.scipy.ndimage.map_coordinates(
        field, [y_back, x_back], order=1, mode="wrap"
    )


def _advect_bfecc(field, u, v, dt, cfg: SpectralConfig):
    """Back-and-forth error compensation (MacCormack) on the bilinear
    trace: fwd + ½(field − back(fwd)), clamped to the bilinearly advected
    3×3 local bounds (Selle et al. 2008) so the antidiffusive correction
    cannot create new extrema."""
    fwd = _advect_semi_lagrangian(field, u, v, dt, cfg)
    bwd = _advect_semi_lagrangian(fwd, u, v, -dt, cfg)
    out = fwd + 0.5 * (field - bwd)
    # periodic 3×3 min/max pools advected along the same trace bracket
    # the values the forward stencil read
    def pool(f, op):
        f = op(op(f, jnp.roll(f, 1, 0)), jnp.roll(f, -1, 0))
        return op(op(f, jnp.roll(f, 1, 1)), jnp.roll(f, -1, 1))

    lo = _advect_semi_lagrangian(pool(field, jnp.minimum), u, v, dt, cfg)
    hi = _advect_semi_lagrangian(pool(field, jnp.maximum), u, v, dt, cfg)
    return jnp.clip(out, lo, hi)


def make_step(cfg: SpectralConfig):
    if cfg.advection not in ("sl", "bfecc"):
        raise ValueError(f"unknown advection {cfg.advection!r}")
    KX, KY, kx_hat, ky_hat, decay = _wavenumbers(cfg)
    y = (np.arange(cfg.ny) + 0.0) / cfg.ny  # unit-height coordinates
    force_x = jnp.asarray(
        cfg.forcing_scale
        * np.sin(cfg.forcing_wavenumber * np.pi * y)[:, None]
        * np.ones((1, cfg.nx)),
        jnp.float32,
    )
    dt = cfg.dt

    def step(state: SpectralState, _unused_cfl=None):
        # (1) body force (plot.jl:81; per-step impulse, reference parity)
        u = state.u + force_x
        v = state.v

        # (2) semi-Lagrangian self-advection (plot.jl:84-97); "bfecc"
        # adds MacCormack error compensation on the same trace
        adv = (_advect_bfecc if cfg.advection == "bfecc"
               else _advect_semi_lagrangian)
        u_adv = adv(u, u, v, dt, cfg)
        v_adv = adv(v, u, v, dt, cfg)

        # (3) stabilize: subtract means (plot.jl:99-101)
        u_adv = u_adv - jnp.mean(u_adv)
        v_adv = v_adv - jnp.mean(v_adv)

        # (4) spectral diffusion + pseudo-pressure projection (plot.jl:103-124)
        u_hat = jnp.fft.rfft2(u_adv) * decay
        v_hat = jnp.fft.rfft2(v_adv) * decay
        p_hat = u_hat * kx_hat + v_hat * ky_hat
        u_hat = u_hat - p_hat * kx_hat
        v_hat = v_hat - p_hat * ky_hat
        u_new = jnp.fft.irfft2(u_hat, s=(cfg.ny, cfg.nx)).astype(jnp.float32)
        v_new = jnp.fft.irfft2(v_hat, s=(cfg.ny, cfg.nx)).astype(jnp.float32)

        # (5) subtract means again (plot.jl:126-128)
        u_new = u_new - jnp.mean(u_new)
        v_new = v_new - jnp.mean(v_new)

        new_state = SpectralState(
            u=u_new, v=v_new, t=state.t + dt, step=state.step + 1
        )
        if cfg.compute_metrics:
            div_hat = u_hat * KX + v_hat * KY  # ∝ spectral divergence
            metrics = SpectralMetrics(
                dt=jnp.float32(dt),
                max_vel=jnp.maximum(jnp.max(jnp.abs(u_new)), jnp.max(jnp.abs(v_new))),
                energy=jnp.mean(0.5 * (u_new**2 + v_new**2)),
                max_div=jnp.max(jnp.abs(div_hat)) / (cfg.nx * cfg.ny),
            )
        else:
            z = jnp.float32(0.0)
            metrics = SpectralMetrics(z, z, z, z)
        return new_state, metrics

    return step


import functools


@functools.partial(jax.jit, static_argnums=(1,))
def spectral_curl(state: SpectralState, cfg: SpectralConfig):
    """Vorticity via spectral derivatives (plot.jl:134-141), for viz.

    Jitted (cfg static): some backends lack eager complex-FFT kernels."""
    KX, KY, *_ = _wavenumbers(cfg)
    scale = 2.0 * jnp.pi if cfg.angular_wavenumbers else 1.0
    u_hat = jnp.fft.rfft2(state.u)
    v_hat = jnp.fft.rfft2(state.v)
    curl_hat = 1j * scale * (KX * v_hat - KY * u_hat)
    return jnp.fft.irfft2(curl_hat, s=state.u.shape).astype(jnp.float32)
