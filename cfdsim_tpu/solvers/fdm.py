"""Fast diagonalization method (FDM): exact direct Poisson solve on
stretched (nonuniform tensor-product) grids via dense eigenbasis matmuls.

The uniform-grid pressure operator is DCT-diagonalizable; a stretched
grid's separable operator L = Ly ⊕ Lx (cell-centered, Neumann) is not —
but each 1D operator is similar to a symmetric tridiagonal matrix, so

    L p = Ly @ p + p @ Lxᵀ = r    ⇒    p = Vy [ (Vy⁻¹ r Vx⁻ᵀ) ⊘ Λ ] Vxᵀ,

with Λ_{jk} = λy_j + λx_k. The four dense (n×n)·(n×m) transforms are
plain matmuls — the replacement for the FFT, and the only exact
direct method once the spacing is nonuniform. Eigendecompositions are
precomputed once in float64 NumPy at setup and closed over as constants.

This is the solver that unlocks boundary-layer clustering (tanh-stretched
walls, cylinder wakes) — the capability the reference's gmsh/FEM path
provided (v1.jl:24-97) — while keeping the structured MAC discretization.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp


def neumann_operator_1d(h: np.ndarray) -> np.ndarray:
    """Cell-centered 1D Poisson operator with zero-flux (Neumann) ends on
    cells of widths ``h``: (L p)_i = [(p_{i+1}−p_i)/d_{i+1/2} −
    (p_i−p_{i−1})/d_{i−1/2}]/h_i, with boundary fluxes dropped.
    ``d`` are center-to-center distances."""
    h = np.asarray(h, np.float64)
    n = len(h)
    d = 0.5 * (h[:-1] + h[1:])  # center-to-center gaps, length n-1
    L = np.zeros((n, n))
    for i in range(n):
        if i > 0:
            L[i, i - 1] += 1.0 / (d[i - 1] * h[i])
            L[i, i] -= 1.0 / (d[i - 1] * h[i])
        if i < n - 1:
            L[i, i + 1] += 1.0 / (d[i] * h[i])
            L[i, i] -= 1.0 / (d[i] * h[i])
    return L


def _eig_similar_symmetric(L: np.ndarray, h: np.ndarray):
    """Eigendecomposition of L = D_h⁻¹ T (T symmetric): L is similar to
    S = D^{-1/2} T D^{-1/2} = Q Λ Qᵀ, giving real eigenpairs
    V = D^{-1/2} Q, V⁻¹ = Qᵀ D^{1/2}."""
    h = np.asarray(h, np.float64)
    sq = np.sqrt(h)
    S = (L * h[:, None]) / sq[:, None] / sq[None, :]  # D^{1/2} L D^{-1/2}
    S = 0.5 * (S + S.T)  # symmetrize roundoff
    # S is tridiagonal by construction (nearest-neighbor stencil):
    # eigh_tridiagonal is O(n²) vs dense eigh's O(n³) — at n=4096 that
    # is ~9 s vs minutes on this host (round-3 autotune stall fix)
    try:
        from scipy.linalg import eigh_tridiagonal

        lam, Q = eigh_tridiagonal(np.diag(S).copy(), np.diag(S, 1).copy())
    except ImportError:  # pragma: no cover - scipy ships with jax
        lam, Q = np.linalg.eigh(S)
    V = Q / sq[:, None]
    Vinv = Q.T * sq[None, :]
    return lam, V, Vinv


def uniform_neumann_eigs(n: int, h: float):
    """Analytic eigendecomposition of the UNIFORM cell-centered Neumann
    operator: the DCT-II cosine basis v_k(i) = cos(πk(2i+1)/2n) with
    λ_k = (2cos(πk/n) − 2)/h² — no numerical eig needed (O(n²) build,
    the autotune matmul candidate at 4096² needs this)."""
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    V = np.cos(np.pi * k * (2 * i + 1) / (2 * n))
    w = np.full(n, 2.0 / n)
    w[0] = 1.0 / n
    Vinv = (V * w).T
    lam = (2.0 * np.cos(np.pi * np.arange(n) / n) - 2.0) / h**2
    return lam, V, Vinv


def make_fdm_solver(hx, hy, nullspace_tol: float = 1e-10, eigs=None):
    """Build an exact Neumann Poisson solver for a stretched cell-centered
    grid: ``solve(rhs) -> phi`` with ∇·(∇phi) = rhs in the FV sense and
    the constant nullspace mode projected out. All heavy work is 4 dense
    matmuls. ``eigs=((lx,Vx,Vxi),(ly,Vy,Vyi))`` skips the numeric
    eigendecomposition (uniform grids have an analytic basis)."""
    hx = np.asarray(hx, np.float64)
    hy = np.asarray(hy, np.float64)
    if eigs is not None:
        (lx, Vx, Vxi), (ly, Vy, Vyi) = eigs
    else:
        lx, Vx, Vxi = _eig_similar_symmetric(neumann_operator_1d(hx), hx)
        ly, Vy, Vyi = _eig_similar_symmetric(neumann_operator_1d(hy), hy)
    lam = ly[:, None] + lx[None, :]
    scale = max(np.abs(lam).max(), 1.0)
    with np.errstate(divide="ignore"):  # analytic basis: λ₀ exactly 0
        inv_lam = np.where(np.abs(lam) < nullspace_tol * scale, 0.0, 1.0 / lam)

    VxT_c = jnp.asarray(Vx.T, jnp.float32)
    VxiT_c = jnp.asarray(Vxi.T, jnp.float32)
    Vy_c = jnp.asarray(Vy, jnp.float32)
    Vyi_c = jnp.asarray(Vyi, jnp.float32)
    inv_lam_c = jnp.asarray(inv_lam, jnp.float32)

    def solve(rhs):
        # fp32 matmul precision: a reduced-precision default (bf16
        # passes, or TF32 on a GPU) turns this "exact" solve into one
        # with a large residual (bf16 left 35%); no-op on CPU
        with jax.default_matmul_precision("float32"):
            rhat = Vyi_c @ rhs @ VxiT_c
            qhat = rhat * inv_lam_c
            return (Vy_c @ qhat @ VxT_c).astype(rhs.dtype)

    return solve


def make_fdm_solver_3d(hx, hy, hz, nullspace_tol: float = 1e-10):
    """3D fast-diagonalization Neumann Poisson solver on a stretched
    cell-centered grid: L = Lz ⊕ Ly ⊕ Lx, solved by six dense eigenbasis
    matmuls + one elementwise spectral division — the 3D analog of
    ``make_fdm_solver`` and the stretched analog of the 3D DCT solve
    (solvers/poisson3d.py)."""
    hx = np.asarray(hx, np.float64)
    hy = np.asarray(hy, np.float64)
    hz = np.asarray(hz, np.float64)
    lx, Vx, Vxi = _eig_similar_symmetric(neumann_operator_1d(hx), hx)
    ly, Vy, Vyi = _eig_similar_symmetric(neumann_operator_1d(hy), hy)
    lz, Vz, Vzi = _eig_similar_symmetric(neumann_operator_1d(hz), hz)
    lam = lz[:, None, None] + ly[None, :, None] + lx[None, None, :]
    scale = max(np.abs(lam).max(), 1.0)
    inv_lam = np.where(np.abs(lam) < nullspace_tol * scale, 0.0, 1.0 / lam)

    VxT_c = jnp.asarray(Vx.T, jnp.float32)
    VxiT_c = jnp.asarray(Vxi.T, jnp.float32)
    Vy_c = jnp.asarray(Vy, jnp.float32)
    Vyi_c = jnp.asarray(Vyi, jnp.float32)
    Vz_c = jnp.asarray(Vz, jnp.float32)
    Vzi_c = jnp.asarray(Vzi, jnp.float32)
    inv_lam_c = jnp.asarray(inv_lam, jnp.float32)

    def solve(rhs):
        # fp32 matmul precision — see make_fdm_solver
        with jax.default_matmul_precision("float32"):
            t = rhs @ VxiT_c                               # x-transform
            t = jnp.einsum("ab,zbx->zax", Vyi_c, t)        # y-transform
            t = jnp.einsum("ab,byx->ayx", Vzi_c, t)        # z-transform
            t = t * inv_lam_c
            t = jnp.einsum("ab,byx->ayx", Vz_c, t)
            t = jnp.einsum("ab,zbx->zax", Vy_c, t)
            return (t @ VxT_c).astype(rhs.dtype)

    return solve
