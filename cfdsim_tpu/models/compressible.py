"""Compressible Euler finite-volume solver (shock-capturing).

JAX rebuild of the reference's shockwave family
(``ShockwaveSolver`` v1_shock.py:225-328 — Mach-2 wedge with HLLC/Roe
fluxes; ``CavityFlowSolver`` cavity_flow_v1.py:248-308 — Mach-2.5
supersonic cavity with Rusanov fluxes, ghost cells, artificial viscosity).

Conserved state U = (ρ, ρu, ρv, ρE) is stored component-leading,
shape (4, ny, nx). One jitted step performs: BC ghost writes → acoustic
CFL dt → (optional MUSCL minmod reconstruction) → whole-face Riemann
fluxes in both sweep directions → conservative update with positivity
floors → artificial viscosity → solid/pinned-mask handling → BCs.

The reference's per-interface scalar flux loops (v1_shock.py:301-306)
become two vectorized flux calls; its per-row Rusanov kernel
(cavity_flow_v1.py:224-230) becomes one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from cfdsim_tpu.grid import Grid
from cfdsim_tpu.ops.limiters import minmod
from cfdsim_tpu.solvers.riemann import (
    FLUXES,
    cons_to_prim,
    prim_to_cons,
    sound_speed,
)


class CompressibleState(NamedTuple):
    U: jax.Array  # (4, ny, nx)
    t: jax.Array
    step: jax.Array


class CompressibleMetrics(NamedTuple):
    dt: jax.Array
    max_vel: jax.Array
    min_rho: jax.Array
    min_p: jax.Array
    energy: jax.Array  # mean kinetic energy ½ρ|u|² (cavity_flow_v1.py:289)
    max_mach: jax.Array


@dataclasses.dataclass(frozen=True)
class CompressibleConfig:
    grid: Grid  # use centering="cell"; ng ghost layers for cavity-style BCs
    gamma: float = 1.4
    flux: str = "hllc"  # rusanov | hllc | roe (textbook) | roe_ref
    reconstruction: str = "none"  # none (1st order) | muscl
    limiter: str = "minmod"  # minmod | superbee | vanleer (MUSCL slopes)
    cfl: float = 0.4
    time_order: int = 1  # 1 = forward Euler (reference), 2 = SSP-RK2 (Heun)
    eps: float = 1e-8
    rho_min: float = 1e-8
    p_min: float = 1e-8
    max_val: float = 1e3
    artificial_viscosity: float = 0.0
    compute_metrics: bool = True


def freestream(cfg: CompressibleConfig, mach: float, p=1.0, rho=1.0):
    """Uniform freestream conserved state values (ρ, ρu, 0, ρE)."""
    a = (cfg.gamma * p / rho) ** 0.5
    u = mach * a
    E = p / (rho * (cfg.gamma - 1.0)) + 0.5 * u * u
    return jnp.asarray([rho, rho * u, 0.0, rho * E], jnp.float32)


def init_state(cfg: CompressibleConfig, U_inf) -> CompressibleState:
    ny, nx = cfg.grid.shape
    U = jnp.broadcast_to(U_inf[:, None, None], (4, ny, nx)).astype(jnp.float32)
    return CompressibleState(U=jnp.array(U), t=jnp.float32(0.0), step=jnp.int32(0))


def acoustic_dt(cfg: CompressibleConfig, U, cfl_scale):
    """dt = CFL·min(dx/max(|u|+a), dy/max(|v|+a))
    (parity: compute_dt v1_shock.py:263-275)."""
    rho, u, v, p = cons_to_prim(U, cfg.gamma, cfg.eps, cfg.max_val)
    a = sound_speed(rho, p, cfg.gamma, cfg.eps)
    sx = jnp.minimum(jnp.max(jnp.abs(u) + a), cfg.max_val)
    sy = jnp.minimum(jnp.max(jnp.abs(v) + a), cfg.max_val)
    dt_x = cfg.grid.dx / jnp.maximum(sx, cfg.eps)
    dt_y = cfg.grid.dy / jnp.maximum(sy, cfg.eps)
    return (cfg.cfl * cfl_scale * jnp.minimum(dt_x, dt_y)).astype(jnp.float32)


def _muscl_faces(W, axis: int, limiter=minmod):
    """Slope-limited MUSCL reconstruction of a primitive array W along
    ``axis`` → (W_left, W_right) at the faces between adjacent cells.

    Capability parity with the reference's limited reconstruction
    (cons_to_prim_limited cavity_flow_v1.py:95-121 + minmod :89-93, and the
    superbee-limited deltas inside its Roe path v1_shock.py:124-138); the
    reference's minmod version divides its slopes by ε=1e-8 — numerically
    broken — so this is the standard, correct MUSCL scheme with a
    selectable slope limiter (minmod | superbee | vanleer).
    """
    n = W.shape[axis]
    Wm = jax.lax.slice_in_dim(W, 0, n - 2, axis=axis)
    Wc = jax.lax.slice_in_dim(W, 1, n - 1, axis=axis)
    Wp = jax.lax.slice_in_dim(W, 2, n, axis=axis)
    slope = limiter(Wc - Wm, Wp - Wc)
    pad = [(0, 0)] * W.ndim
    pad[axis] = (1, 1)
    slope = jnp.pad(slope, pad)  # zero slope in the outermost cells
    WL = jax.lax.slice_in_dim(W + 0.5 * slope, 0, n - 1, axis=axis)
    WR = jax.lax.slice_in_dim(W - 0.5 * slope, 1, n, axis=axis)
    return WL, WR


def _face_states(cfg: CompressibleConfig, U, axis: int):
    """(UL, UR) conserved states at faces along ``axis`` (axis counts in
    the (ny, nx) plane: 1 = x faces, 0 = y faces; array axis is +1)."""
    arr_axis = axis + 1
    n = U.shape[arr_axis]
    if cfg.reconstruction == "none":
        UL = jax.lax.slice_in_dim(U, 0, n - 1, axis=arr_axis)
        UR = jax.lax.slice_in_dim(U, 1, n, axis=arr_axis)
        return UL, UR
    if cfg.reconstruction == "muscl":
        from cfdsim_tpu.ops.limiters import SLOPE_LIMITERS

        limiter = SLOPE_LIMITERS[cfg.limiter]
        rho, u, v, p = cons_to_prim(U, cfg.gamma, cfg.eps, cfg.max_val)
        faces = [_muscl_faces(w, axis, limiter) for w in (rho, u, v, p)]
        (rL, rR), (uL, uR), (vL, vR), (pL, pR) = faces
        rL = jnp.maximum(rL, cfg.rho_min)
        rR = jnp.maximum(rR, cfg.rho_min)
        pL = jnp.maximum(pL, cfg.p_min)
        pR = jnp.maximum(pR, cfg.p_min)
        return (
            prim_to_cons(rL, uL, vL, pL, cfg.gamma),
            prim_to_cons(rR, uR, vR, pR, cfg.gamma),
        )
    raise ValueError(f"unknown reconstruction {cfg.reconstruction!r}")


def make_step(
    cfg: CompressibleConfig,
    bc_fn: Callable,
    zero_momentum_mask: Optional[jax.Array] = None,
    pin_mask: Optional[jax.Array] = None,
    pin_state: Optional[jax.Array] = None,
) -> Callable:
    """Build the jitted step.

    ``bc_fn(U, step, t) -> U`` writes ghost/edge cells. ``zero_momentum_mask``
    zeroes momentum inside an embedded solid (the reference wedge,
    v1_shock.py:312-313). ``pin_mask``/``pin_state`` pin cells to a fixed
    state each step (the reference's quiescent cavity block,
    cavity_flow_v1.py:165-170).
    """
    g = cfg.grid
    dx, dy = g.dx, g.dy
    flux_fn = FLUXES[cfg.flux]

    def euler_update(U, dt):
        """One conservative forward-Euler update with artificial viscosity
        and positivity floors (parity: update_state v1_shock.py:211-223,
        cavity_flow_v1.py:224-244)."""
        UL, UR = _face_states(cfg, U, axis=1)
        F = flux_fn(UL, UR, cfg.gamma, 1, cfg.eps, cfg.max_val)
        dF = (F[:, :, 1:] - F[:, :, :-1]) / dx  # valid for cells 1..nx-2

        VL, VR = _face_states(cfg, U, axis=0)
        G = flux_fn(VL, VR, cfg.gamma, 0, cfg.eps, cfg.max_val)
        dG = (G[:, 1:, :] - G[:, :-1, :]) / dy  # valid for cells 1..ny-2

        U_new = U.at[:, 1:-1, 1:-1].add(
            -dt * (dF[:, 1:-1, :] + dG[:, :, 1:-1])
        )

        if cfg.artificial_viscosity > 0.0:
            mom = U[1:3]
            lap = (
                (mom[:, 1:-1, 2:] - 2.0 * mom[:, 1:-1, 1:-1] + mom[:, 1:-1, :-2])
                / (dx * dx)
                + (mom[:, 2:, 1:-1] - 2.0 * mom[:, 1:-1, 1:-1] + mom[:, :-2, 1:-1])
                / (dy * dy)
            )
            U_new = U_new.at[1:3, 1:-1, 1:-1].add(
                dt * cfg.artificial_viscosity * lap
            )

        rho_f = jnp.maximum(U_new[0], cfg.rho_min)
        return jnp.stack(
            [
                rho_f,
                jnp.clip(U_new[1], -cfg.max_val * rho_f, cfg.max_val * rho_f),
                jnp.clip(U_new[2], -cfg.max_val * rho_f, cfg.max_val * rho_f),
                jnp.maximum(U_new[3], cfg.eps * rho_f),
            ]
        )

    def step(state: CompressibleState, cfl_scale):
        U = bc_fn(state.U, state.step, state.t)
        dt = acoustic_dt(cfg, U, cfl_scale)

        if cfg.time_order == 2:
            # SSP-RK2 (Heun): a convex combination of Euler updates keeps
            # the TVD property of the limited fluxes at 2nd order in time
            U1 = bc_fn(euler_update(U, dt), state.step, state.t)
            U_new = 0.5 * U + 0.5 * euler_update(U1, dt)
        else:
            U_new = euler_update(U, dt)

        if zero_momentum_mask is not None:
            keep = 1.0 - zero_momentum_mask.astype(U_new.dtype)
            U_new = U_new.at[1].mul(keep)
            U_new = U_new.at[2].mul(keep)
        if pin_mask is not None:
            m = pin_mask.astype(U_new.dtype)[None]
            U_new = U_new * (1.0 - m) + pin_state[:, None, None] * m

        U_new = bc_fn(U_new, state.step + 1, state.t + dt)

        new_state = CompressibleState(U=U_new, t=state.t + dt, step=state.step + 1)

        if cfg.compute_metrics:
            rho, u, v, p = cons_to_prim(U_new, cfg.gamma, cfg.eps, cfg.max_val)
            a = sound_speed(rho, p, cfg.gamma, cfg.eps)
            vel = jnp.sqrt(u * u + v * v)
            metrics = CompressibleMetrics(
                dt=dt,
                max_vel=jnp.max(vel),
                min_rho=jnp.min(U_new[0]),
                min_p=jnp.min(p),
                energy=jnp.mean(0.5 * rho * vel * vel),
                max_mach=jnp.max(vel / a),
            )
        else:
            z = jnp.float32(0.0)
            metrics = CompressibleMetrics(dt, z, z, z, z, z)
        return new_state, metrics

    return step
