"""Core finite-difference stencil operators.

JAX replacements for the reference's Numba stencil kernels
(gradient/divergence/laplacian/vorticity, reference v5.py:164-200, 365-373).
Instead of explicit ``prange`` loops, each operator is expressed with shifted
slices on the interior; XLA fuses chains of these into single VPU passes over
HBM tiles. All operators write zeros on the one-point boundary frame, exactly
like the reference kernels (which only loop ``1..n-1``).

Convention: arrays are (ny, nx); axis 0 is y (rows), axis 1 is x (lanes).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _pad1(interior):
    """Pad an (ny-2, nx-2) interior result back to (ny, nx) with zeros."""
    return jnp.pad(interior, ((1, 1), (1, 1)))


def shift(a, di: int, dj: int):
    """a shifted so result[i,j] = a[i+di, j+dj] on the valid interior,
    implemented as a slice (no wraparound). Shapes shrink by |di|,|dj|."""
    ny, nx = a.shape
    i0, i1 = max(di, 0), ny + min(di, 0)
    j0, j1 = max(dj, 0), nx + min(dj, 0)
    return a[i0:i1, j0:j1]


def gradient(phi, dx: float, dy: float):
    """Central-difference gradient (∂φ/∂x, ∂φ/∂y); zero on boundary frame.

    Parity: reference ``compute_gradient_fast`` v5.py:189-200.
    """
    gx = (phi[1:-1, 2:] - phi[1:-1, :-2]) * (0.5 / dx)
    gy = (phi[2:, 1:-1] - phi[:-2, 1:-1]) * (0.5 / dy)
    return _pad1(gx), _pad1(gy)


def divergence(u, v, dx: float, dy: float):
    """Central divergence ∂u/∂x + ∂v/∂y; zero on boundary frame.

    Parity: reference ``compute_divergence_fast`` v5.py:178-187.
    """
    div = (u[1:-1, 2:] - u[1:-1, :-2]) * (0.5 / dx) + (
        v[2:, 1:-1] - v[:-2, 1:-1]
    ) * (0.5 / dy)
    return _pad1(div)


def laplacian(phi, dx: float, dy: float):
    """5-point Laplacian; zero on boundary frame."""
    lap = (phi[1:-1, 2:] - 2.0 * phi[1:-1, 1:-1] + phi[1:-1, :-2]) * (
        1.0 / (dx * dx)
    ) + (phi[2:, 1:-1] - 2.0 * phi[1:-1, 1:-1] + phi[:-2, 1:-1]) * (1.0 / (dy * dy))
    return _pad1(lap)


def laplacian_coeff(phi, dx: float, dy: float, nu_eff):
    """ν_eff-weighted 5-point Laplacian: ν_eff(i,j) * ∇²φ.

    Parity: reference ``compute_laplacian_fast`` v5.py:164-176 (the
    coefficient multiplies the whole Laplacian, not flux form).
    ``nu_eff`` may be a scalar or an (ny, nx) array.
    """
    lap = (phi[1:-1, 2:] - 2.0 * phi[1:-1, 1:-1] + phi[1:-1, :-2]) * (
        1.0 / (dx * dx)
    ) + (phi[2:, 1:-1] - 2.0 * phi[1:-1, 1:-1] + phi[:-2, 1:-1]) * (1.0 / (dy * dy))
    nu = nu_eff[1:-1, 1:-1] if jnp.ndim(nu_eff) == 2 else nu_eff
    return _pad1(nu * lap)


def curl(u, v, dx: float, dy: float):
    """z-vorticity ω = ∂v/∂x − ∂u/∂y; zero on boundary frame.

    Parity: reference ``compute_vorticity`` v5.py:365-373.
    """
    w = (v[1:-1, 2:] - v[1:-1, :-2]) * (0.5 / dx) - (
        u[2:, 1:-1] - u[:-2, 1:-1]
    ) * (0.5 / dy)
    return _pad1(w)


def interior_mask(shape, width: int = 1, dtype=jnp.float32):
    """1 on the interior, 0 on a ``width``-point boundary frame (constant)."""
    m = np.zeros(shape, dtype=np.float32)
    m[width:-width, width:-width] = 1.0
    return jnp.asarray(m, dtype=dtype)
