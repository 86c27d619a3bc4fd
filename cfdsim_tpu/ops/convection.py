"""Convection operators: first-order upwind and SUPG-stabilized central.

JAX equivalents of the reference's convection kernels
(``compute_convection_fast`` v5.py:112-125, ``compute_convection_supg_fast``
v5.py:127-147, ``compute_supg_stabilization_fast`` v5.py:149-162). The
branchy per-cell upwind selects become ``jnp.where`` masks that the VPU
evaluates in one fused pass.
"""

from __future__ import annotations

import jax.numpy as jnp

from cfdsim_tpu.ops.stencil import _pad1


def convection_upwind(u, v, phi, dx: float, dy: float):
    """First-order upwind u·∇φ; zero on boundary frame.

    Parity: reference ``compute_convection_fast`` v5.py:112-125 (backward
    difference when velocity > 0, forward otherwise).
    """
    uc = u[1:-1, 1:-1]
    vc = v[1:-1, 1:-1]
    pc = phi[1:-1, 1:-1]
    bwd_x = (pc - phi[1:-1, :-2]) * (1.0 / dx)
    fwd_x = (phi[1:-1, 2:] - pc) * (1.0 / dx)
    bwd_y = (pc - phi[:-2, 1:-1]) * (1.0 / dy)
    fwd_y = (phi[2:, 1:-1] - pc) * (1.0 / dy)
    dphidx = jnp.where(uc > 0, bwd_x, fwd_x)
    dphidy = jnp.where(vc > 0, bwd_y, fwd_y)
    return _pad1(uc * dphidx + vc * dphidy)


def supg_tau(u, v, dx: float, dy: float, dt, nu_eff):
    """SUPG stabilization parameter τ.

    τ = h/(2|u|)·min(1, Pe/2) with Pe = |u|h/ν_eff; τ = dt/2 at stagnation
    points. Parity: reference ``compute_supg_stabilization_fast``
    v5.py:149-162 (boundary frame zeroed to match the reference's 1..n-1
    loop).
    """
    h = min(dx, dy)
    vel = jnp.sqrt(u * u + v * v)
    pe = vel * h / (nu_eff + 1e-10)
    tau_flow = h / (2.0 * jnp.maximum(vel, 1e-10)) * jnp.minimum(1.0, pe / 2.0)
    tau = jnp.where(vel > 1e-10, tau_flow, dt / 2.0)
    return _pad1(tau[1:-1, 1:-1])


def convection_supg(u, v, phi, dx: float, dy: float, tau, ref_parity: bool = False):
    """Central-difference convection minus the SUPG correction term:

        conv = u·∇φ − τ·(u ∂²φ/∂x² + v ∂²φ/∂y²);  zero on boundary frame.

    Capability parity: reference ``compute_convection_supg_fast``
    v5.py:127-147. The reference multiplies its central difference by
    ``0.5 * dx_inv`` where ``dx_inv = 0.5/dx`` — i.e. it *halves* the
    convection term (and quarters the SUPG second-derivative scale), an
    apparent bug it relies on for extra stabilization. The default here is
    the mathematically correct operator; pass ``ref_parity=True`` to
    reproduce the reference's halved scaling exactly.
    """
    uc = u[1:-1, 1:-1]
    vc = v[1:-1, 1:-1]
    pc = phi[1:-1, 1:-1]
    if ref_parity:
        d1x, d1y = 0.25 / dx, 0.25 / dy
        d2x, d2y = (0.5 / dx) ** 2, (0.5 / dy) ** 2
    else:
        d1x, d1y = 0.5 / dx, 0.5 / dy
        d2x, d2y = 1.0 / (dx * dx), 1.0 / (dy * dy)
    dphidx = (phi[1:-1, 2:] - phi[1:-1, :-2]) * d1x
    dphidy = (phi[2:, 1:-1] - phi[:-2, 1:-1]) * d1y
    conv_std = uc * dphidx + vc * dphidy
    lap_x = (phi[1:-1, 2:] - 2.0 * pc + phi[1:-1, :-2]) * d2x
    lap_y = (phi[2:, 1:-1] - 2.0 * pc + phi[:-2, 1:-1]) * d2y
    tc = tau[1:-1, 1:-1]
    supg = tc * (uc * lap_x + vc * lap_y)
    return _pad1(jnp.where(tc > 0, conv_std - supg, conv_std))


def convection_tvd(u, v, phi, dx: float, dy: float):
    """Second-order TVD convection: MUSCL face reconstruction with a van
    Leer limited slope, in flux form with a φ·∇·u correction so the
    operator reduces to the advective u·∇φ the rest of the solver expects.

    This is the TVD/central hybrid the first-order upwind scheme
    (``convection_upwind``, reference v5.py:112-125) is upgraded to for
    Strouhal-accurate cylinder shedding: at smooth extrema the limiter
    keeps full second-order accuracy (central-like), at sharp gradients it
    reduces to monotone upwind. Zero on the boundary frame like the other
    convection operators.
    """
    from cfdsim_tpu.ops.limiters import vanleer_slope

    pe = jnp.pad(phi, ((0, 0), (1, 1)), mode="edge")
    sx = vanleer_slope(phi - pe[:, :-2], pe[:, 2:] - phi)  # (ny, nx)
    pey = jnp.pad(phi, ((1, 1), (0, 0)), mode="edge")
    sy = vanleer_slope(phi - pey[:-2, :], pey[2:, :] - phi)

    uf = 0.5 * (u[:, :-1] + u[:, 1:])  # x-face velocities (ny, nx-1)
    phiL = phi[:, :-1] + 0.5 * sx[:, :-1]
    phiR = phi[:, 1:] - 0.5 * sx[:, 1:]
    Fx = uf * jnp.where(uf >= 0.0, phiL, phiR)

    vf = 0.5 * (v[:-1, :] + v[1:, :])  # y-face velocities (ny-1, nx)
    phiB = phi[:-1, :] + 0.5 * sy[:-1, :]
    phiT = phi[1:, :] - 0.5 * sy[1:, :]
    Fy = vf * jnp.where(vf >= 0.0, phiB, phiT)

    dF = (Fx[1:-1, 1:] - Fx[1:-1, :-1]) * (1.0 / dx)
    dG = (Fy[1:, 1:-1] - Fy[:-1, 1:-1]) * (1.0 / dy)
    # subtract φ·∇·u built from the SAME face velocities so the flux form
    # telescopes exactly to the advective form
    divu_f = (uf[1:-1, 1:] - uf[1:-1, :-1]) * (1.0 / dx) + (
        vf[1:, 1:-1] - vf[:-1, 1:-1]
    ) * (1.0 / dy)
    return _pad1(dF + dG - phi[1:-1, 1:-1] * divu_f)


def convection_central(u, v, phi, dx: float, dy: float):
    """Plain second-order central convection u·∇φ; zero on boundary frame."""
    uc = u[1:-1, 1:-1]
    vc = v[1:-1, 1:-1]
    dphidx = (phi[1:-1, 2:] - phi[1:-1, :-2]) * (0.5 / dx)
    dphidy = (phi[2:, 1:-1] - phi[:-2, 1:-1]) * (0.5 / dy)
    return _pad1(uc * dphidx + vc * dphidy)
