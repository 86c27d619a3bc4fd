"""Exact Dirichlet Helmholtz solver via discrete sine transforms.

The implicit (backward-Euler) viscous step solves

    (I − c ∇²) u* = b,   c = dt·ν,

with Dirichlet velocity BCs on the one-node boundary frame (the capability
of the reference's Julia FEM solver, v1.jl:130-167). The interior 5-point
operator with homogeneous Dirichlet walls is exactly diagonalized by the
2D DST-I; inhomogeneous boundary values move to the right-hand side. One
forward/inverse transform pair replaces the damped-Jacobi iteration
(models/incompressible.py) — machine-precision instead of
O((ρ_J)^iters) error, at FFT cost.

DST-I of length m is computed as the imaginary part of an FFT of the odd
extension (length 2(m+1)) — no scatter/gather.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def dst1(x, axis: int):
    """DST-I along ``axis``: S[k] = Σ_{j=1..m} x_j sin(πjk/(m+1)), k=1..m.

    Self-inverse up to the factor 2/(m+1): dst1(dst1(x)) = (m+1)/2 · x.
    """
    m = x.shape[axis]
    pad_shape = list(x.shape)
    pad_shape[axis] = 1
    zero = jnp.zeros(pad_shape, x.dtype)
    v = jnp.concatenate([zero, x, zero, -jnp.flip(x, axis)], axis=axis)
    V = jnp.fft.rfft(v, axis=axis)  # length m+2 along axis
    S = -0.5 * jnp.imag(jnp.take(V, jnp.arange(1, m + 1), axis=axis))
    return S.astype(x.dtype)


def idst1(X, axis: int):
    m = X.shape[axis]
    return dst1(X, axis) * (2.0 / (m + 1))


def solve_helmholtz_dirichlet(b, coeff, dx: float, dy: float):
    """Solve (I − coeff·∇²) u = b on the interior of a (ny, nx) array whose
    one-node boundary frame carries the Dirichlet values of u (they are
    preserved in the returned array). ``coeff`` = dt·ν must be a scalar
    (spatially varying ν needs the iterative path)."""
    ax = 1.0 / (dx * dx)
    ay = 1.0 / (dy * dy)
    # move the known boundary values to the RHS of the interior system
    rhs = b[1:-1, 1:-1]
    rhs = rhs.at[:, 0].add(coeff * ax * b[1:-1, 0])
    rhs = rhs.at[:, -1].add(coeff * ax * b[1:-1, -1])
    rhs = rhs.at[0, :].add(coeff * ay * b[0, 1:-1])
    rhs = rhs.at[-1, :].add(coeff * ay * b[-1, 1:-1])

    my, mx = rhs.shape
    ky = np.arange(1, my + 1)
    kx = np.arange(1, mx + 1)
    cy = 2.0 * np.cos(np.pi * ky / (my + 1))
    cx = 2.0 * np.cos(np.pi * kx / (mx + 1))
    denom = jnp.asarray(
        1.0 + coeff * (2.0 * (ax + ay) - ax * cx[None, :] - ay * cy[:, None]),
        rhs.dtype,
    )

    rhat = dst1(dst1(rhs, axis=0), axis=1)
    uhat = rhat / denom
    u_int = idst1(idst1(uhat, axis=1), axis=0)
    return b.at[1:-1, 1:-1].set(u_int.astype(b.dtype))


# ---------------------------------------------------------------------------
# MAC-component Helmholtz: mixed half-sample/integer bases
# ---------------------------------------------------------------------------

def dst2(x, axis: int):
    """DST-II along ``axis``: S_k = Σ_j x_j sin(π(j+½)(k+1)/m) — the
    eigenbasis of the 1D Laplacian with odd-half-sample (no-slip
    tangential ghost = −u) ends. Computed from the fast DCT-II by the
    sign-flip/index-reversal identity DST-II(x)_k = DCT-II((−1)^j x)_{m−1−k}."""
    from cfdsim_tpu.solvers.poisson import _dct_fwd

    m = x.shape[axis]
    j = jnp.arange(m)
    sgn_shape = [1] * x.ndim
    sgn_shape[axis] = m
    sgn = jnp.asarray((-1.0) ** j, x.dtype).reshape(sgn_shape)
    return jnp.flip(_dct_fwd(x * sgn, axis), axis)


def idst2(X, axis: int):
    """Inverse of ``dst2`` (DST-III up to the DCT-II normalization)."""
    from cfdsim_tpu.solvers.poisson import _dct_inv

    m = X.shape[axis]
    j = jnp.arange(m)
    sgn_shape = [1] * X.ndim
    sgn_shape[axis] = m
    sgn = jnp.asarray((-1.0) ** j, X.dtype).reshape(sgn_shape)
    return _dct_inv(jnp.flip(X, axis), axis) * sgn


def _axis_basis(kind: str, m: int, h: float):
    """(fwd, inv, eigenvalues/h²) for one axis of a MAC-component
    Helmholtz operator. Kinds:

    - "dst1": unknowns at integer interior faces, Dirichlet walls
      (normal velocity): λ_k = 2cos(πk/(m+1))−2, k=1..m
    - "dst2": unknowns at half-sample centers, odd mirror ghost = −u
      (no-slip tangential): λ_k = 2cos(π(k+1)/m)−2, k=0..m−1
    - "dct2": unknowns at half-sample centers, even mirror ghost = +u
      (free-slip tangential): λ_k = 2cos(πk/m)−2, k=0..m−1
    """
    if kind == "dst1":
        lam = 2.0 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1)) - 2.0
        return dst1, idst1, lam / (h * h)
    if kind == "dst2":
        lam = 2.0 * np.cos(np.pi * np.arange(1, m + 1) / m) - 2.0
        return dst2, idst2, lam / (h * h)
    if kind == "dct2":
        from cfdsim_tpu.solvers.poisson import _dct_fwd, _dct_inv

        lam = 2.0 * np.cos(np.pi * np.arange(m) / m) - 2.0
        return _dct_fwd, _dct_inv, lam / (h * h)
    raise ValueError(f"unknown Helmholtz axis kind {kind!r}")


def make_mac_helmholtz(shape, kinds, dx: float, dy: float):
    """Exact solver for (I − c·∇²) q = b on a MAC velocity component's
    interior unknowns, ``shape`` = (my, mx), ``kinds`` = (kind_y,
    kind_x) from ``_axis_basis``. ``c`` = dt·ν may be a traced scalar
    (the adaptive dt): the eigen-denominator is built in-graph.

    This is the implicit-viscous engine of the staggered tier: with
    homogeneous-form BCs folded into the 1D operators (inhomogeneous
    wall values enter as RHS corrections), one forward/inverse
    separable transform pair solves the Helmholtz problem to fp32
    roundoff — the viscous dt restriction disappears entirely."""
    my, mx = shape
    fy, iy_, lam_y = _axis_basis(kinds[0], my, dy)
    fx, ix_, lam_x = _axis_basis(kinds[1], mx, dx)
    lam = jnp.asarray(lam_y[:, None] + lam_x[None, :], jnp.float32)

    def solve(b, c):
        bh = fx(fy(b, 0), 1)
        qh = bh / (1.0 - c * lam)
        return ix_(iy_(qh, 0), 1).astype(b.dtype)

    return solve
