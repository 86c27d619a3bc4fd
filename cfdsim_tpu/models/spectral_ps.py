"""Pseudo-spectral 2D vorticity solver (dealiased, integrating factor).

The high-fidelity upgrade of the spectral tier: where `models/spectral.py`
rebuilds the reference's stable-fluids scheme (plot.jl:23-167 — bilinear
semi-Lagrangian advection whose numerical viscosity damps the inertial
flux; BENCHNOTES "Kolmogorov spectrum"), this module solves the same
periodic Kolmogorov-flow problem in vorticity form

    ω_t + u·∇ω = ν ∇²ω − α ω + f_ω,   ∇²ψ = −ω,  u = ∂_y ψ, v = −∂_x ψ

with the textbook pseudo-spectral method: nonlinear term evaluated in
real space on a 2/3-dealiased grid, SSP-RK2 in time, and the stiff
viscous+friction terms integrated EXACTLY by the spectral factor
exp(−(νk²+α)dt) — zero advection dissipation, so the inverse/enstrophy
cascades carry the full resolved flux. Everything is rfft2/irfft2 +
elementwise — an op mix XLA fuses well (the 2D-DCT headline solve rides
the same FFT path).

The Kolmogorov body force fs·sin(k_f π y) x̂ enters as its curl
f_ω = −fs·k_f π·cos(k_f π y), applied continuously (per unit time, the
standard forced-turbulence convention — unlike the reference's per-step
impulse, which ties the injection rate to dt).

State is the vorticity spectrum ω̂ on the rfft2 grid, stored as float32
re/im planes (complex exists only inside the jitted step; a plain
complex64 state is the simpler form, ROADMAP Design 4); use
``velocities(cfg, state)`` to get (u, v) for diagnostics/spectra.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class PSState(NamedTuple):
    # vorticity spectrum on the rfft2 grid, stored as float32 re/im
    # planes (2, ny, nx//2+1): complex values exist only INSIDE the
    # jitted step — never as state leaves or baked device constants
    # (ROADMAP Design 4 lists plain complex64 state as the simpler form)
    w_hat: jax.Array
    t: jax.Array
    step: jax.Array


def _to_c(w):
    return jax.lax.complex(w[0], w[1])


def _from_c(wc):
    return jnp.stack([jnp.real(wc), jnp.imag(wc)]).astype(jnp.float32)


class PSMetrics(NamedTuple):
    dt: jax.Array
    max_vel: jax.Array
    energy: jax.Array
    enstrophy: jax.Array


@dataclasses.dataclass(frozen=True)
class PseudoSpectralConfig:
    ny: int = 512
    aspect: float = 1.0
    nu: float = 1e-5
    dt: float = 2e-3
    forcing_wavenumber: int = 8  # sin(k_f π y), k_f/2 cycles per box
    forcing_scale: float = 0.1   # force per unit TIME (not per step)
    linear_friction: float = 0.0
    compute_metrics: bool = True

    @property
    def nx(self) -> int:
        return int(self.ny * self.aspect)

    @property
    def lx(self) -> float:
        return self.nx / self.ny

    @property
    def ly(self) -> float:
        return 1.0


def _wavenumbers(cfg: PseudoSpectralConfig):
    """Angular wavenumber grids on the rfft2 layout + 2/3 dealias mask +
    inverse Laplacian (zero-mean gauge)."""
    kx = 2.0 * np.pi * np.fft.rfftfreq(cfg.nx) * cfg.nx / cfg.lx
    ky = 2.0 * np.pi * np.fft.fftfreq(cfg.ny) * cfg.ny / cfg.ly
    KX, KY = np.meshgrid(kx, ky)
    k2 = KX**2 + KY**2
    inv_k2 = np.where(k2 == 0.0, 0.0, 1.0 / np.where(k2 == 0.0, 1.0, k2))
    # 2/3-rule: zero every mode with |m| > n/3 in either axis
    mx = np.abs(np.fft.rfftfreq(cfg.nx) * cfg.nx)
    my = np.abs(np.fft.fftfreq(cfg.ny) * cfg.ny)
    dealias = ((mx[None, :] <= cfg.nx / 3.0)
               & (my[:, None] <= cfg.ny / 3.0)).astype(np.float32)
    return (jnp.asarray(KX, jnp.float32), jnp.asarray(KY, jnp.float32),
            jnp.asarray(inv_k2, jnp.float32), jnp.asarray(dealias))


def init_state(cfg: PseudoSpectralConfig, w0=None, seed: int = 0,
               noise: float = 0.0) -> PSState:
    """Start from rest (plus optional white-noise vorticity to seed the
    Kolmogorov instability — the laminar state is an exact solution)."""
    shape = (cfg.ny, cfg.nx)
    if w0 is None:
        w = np.zeros(shape, np.float32)
    else:
        w = np.asarray(w0, np.float32)
    if noise > 0.0:
        rng = np.random.default_rng(seed)
        w = w + noise * rng.standard_normal(shape).astype(np.float32)
    # host-side FFT + dealias: the step's linear terms never re-mask the
    # state, and a 2/3-clean state stays 2/3-clean (only N products are
    # masked). numpy throughout — the state holds no complex buffer
    kx_keep = np.abs(np.fft.rfftfreq(cfg.nx) * cfg.nx) <= cfg.nx / 3.0
    ky_keep = np.abs(np.fft.fftfreq(cfg.ny) * cfg.ny) <= cfg.ny / 3.0
    wc = np.fft.rfft2(w) * (ky_keep[:, None] & kx_keep[None, :])
    return PSState(
        w_hat=jnp.asarray(
            np.stack([wc.real, wc.imag]).astype(np.float32)),
        t=jnp.float32(0.0), step=jnp.int32(0))


@partial(jax.jit, static_argnums=0)
def _uv(cfg: PseudoSpectralConfig, w_hat):
    KX, KY, inv_k2, _ = _wavenumbers(cfg)
    psi_hat = _to_c(w_hat) * inv_k2
    s = (cfg.ny, cfg.nx)
    u = jnp.fft.irfft2(1j * KY * psi_hat, s=s).astype(jnp.float32)
    v = jnp.fft.irfft2(-1j * KX * psi_hat, s=s).astype(jnp.float32)
    return u, v


def velocities(cfg: PseudoSpectralConfig, state: PSState):
    """(u, v) real-space fields from ω̂ (for spectra/visualisation).
    Jitted (cfg static — frozen dataclasses hash) so the complex
    intermediates stay device-resident and repeat calls hit the
    jit cache instead of retracing."""
    return _uv(cfg, state.w_hat)


def make_step(cfg: PseudoSpectralConfig):
    KX, KY, inv_k2, dealias = _wavenumbers(cfg)
    s = (cfg.ny, cfg.nx)
    y = (np.arange(cfg.ny) + 0.0) / cfg.ny
    kf = cfg.forcing_wavenumber * np.pi
    # f_ω = curl of fs·sin(k_f π y) x̂  =  −fs·k_f π·cos(k_f π y).
    # Host-side FFT, split re/im: no complex constant is baked; the
    # complex constant is assembled in-trace from baked float planes
    f_w_np = np.fft.rfft2(
        -cfg.forcing_scale * kf * np.cos(kf * y)[:, None]
        * np.ones((1, cfg.nx), np.float64))
    f_w_re = jnp.asarray(f_w_np.real, jnp.float32)
    f_w_im = jnp.asarray(f_w_np.imag, jnp.float32)
    lam = cfg.nu * (KX**2 + KY**2) + cfg.linear_friction
    # Strang splitting: exact half-step decay exp(−λ dt/2), SSP-RK3 on
    # the advection+forcing part (imaginary-axis stable, unlike RK2),
    # exact half-step decay again — O(dt²) splitting, exact ν/α damping
    ehalf = jnp.exp(-0.5 * lam * cfg.dt).astype(jnp.float32)
    dt = jnp.float32(cfg.dt)

    def rhs(w_hat):
        """−dealias(u·∇ω)̂ + f̂_ω (the non-stiff part)."""
        psi_hat = w_hat * inv_k2
        u = jnp.fft.irfft2(1j * KY * psi_hat, s=s)
        v = jnp.fft.irfft2(-1j * KX * psi_hat, s=s)
        wx = jnp.fft.irfft2(1j * KX * w_hat, s=s)
        wy = jnp.fft.irfft2(1j * KY * w_hat, s=s)
        adv_hat = jnp.fft.rfft2(u * wx + v * wy)
        f_w_hat = jax.lax.complex(f_w_re, f_w_im)
        return (-adv_hat + f_w_hat) * dealias, u, v

    def step(state: PSState, _unused_cfl=None):
        w = ehalf * _to_c(state.w_hat)
        # SSP-RK3 (Shu–Osher) on dω̂/dt = N(ω̂)
        n0, u, v = rhs(w)
        w1 = w + dt * n0
        n1, _, _ = rhs(w1)
        w2 = 0.75 * w + 0.25 * (w1 + dt * n1)
        n2, _, _ = rhs(w2)
        w_new = ehalf * (w / 3.0 + (2.0 / 3.0) * (w2 + dt * n2))
        new_state = PSState(w_hat=_from_c(w_new),
                            t=state.t + dt, step=state.step + 1)
        if cfg.compute_metrics:
            energy = 0.5 * jnp.mean(u * u + v * v)
            w_real = jnp.fft.irfft2(w, s=s)
            m = PSMetrics(dt=dt,
                          max_vel=jnp.max(jnp.sqrt(u * u + v * v)),
                          energy=energy,
                          enstrophy=0.5 * jnp.mean(w_real * w_real))
        else:
            z = jnp.float32(0.0)
            m = PSMetrics(dt=dt, max_vel=z, energy=z, enstrophy=z)
        return new_state, m

    return step
