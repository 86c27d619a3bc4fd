"""Distributed fast transforms for explicit shard_map solvers.

Pencil decomposition over the ("y", "x") device mesh, the classic
distributed-FFT layout: ``lax.all_to_all`` within one mesh axis converts a
(ny_l, nx_l) block into a pencil holding the *full* extent of one array
axis (rows-local-full-x or cols-local-full-y), the 1D transform runs
locally on the complete lines, and the inverse all_to_all restores the
block layout. On hardware the all_to_alls cross devices.

This gives the explicit-comm path the two exact direct solvers the GSPMD
path gets from XLA's sharded FFT:

- ``dct_poisson_local`` — the clamped-edge (Neumann) pressure Poisson
  solve (solvers/poisson.py:465-510 made multi-chip), used by the sharded
  MAC projection (parallel/mac_explicit.py) where exactness is the whole
  point of the staggered tier;
- ``dst_helmholtz_local`` — the Dirichlet implicit-viscous Helmholtz
  solve (solvers/helmholtz.py), closing the one make_step option the
  explicit NS step previously rejected (implicit_solver="dst").

Layout requirements (checked at trace time): ny_l divisible by px and
nx_l divisible by py, i.e. global ny divisible by py·px and nx by px·py —
satisfied by the usual power-of-two grids on power-of-two meshes.

All functions must be called INSIDE ``jax.shard_map`` over mesh axes
("y", "x").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from cfdsim_tpu.solvers.helmholtz import dst1
from cfdsim_tpu.solvers.poisson import _dct_fwd, _dct_inv


def _check_pencil(shape, py: int, px: int):
    ny_l, nx_l = shape
    if ny_l % max(px, 1) != 0 or nx_l % max(py, 1) != 0:
        raise ValueError(
            f"pencil decomposition needs local block {shape} with rows "
            f"divisible by px={px} and cols divisible by py={py}"
        )


def _a2a(t, name: str, split: int, concat: int, n: int):
    """tiled all_to_all along mesh axis ``name`` (identity when n == 1)."""
    if n == 1:
        return t
    return lax.all_to_all(t, name, split_axis=split, concat_axis=concat,
                          tiled=True)


def to_x_pencil(block, px: int):
    """Block (ny_l, nx_l) → x-pencil (ny_l/px, nx_g): each device in an
    x-group keeps a slice of its rows but gains the full global x extent."""
    if px == 1:
        return block
    return lax.all_to_all(block, "x", split_axis=0, concat_axis=1, tiled=True)


def from_x_pencil(pencil, px: int):
    if px == 1:
        return pencil
    return lax.all_to_all(pencil, "x", split_axis=1, concat_axis=0, tiled=True)


def to_y_pencil(block, py: int):
    """Block (ny_l, nx_l) → y-pencil (ny_g, nx_l/py)."""
    if py == 1:
        return block
    return lax.all_to_all(block, "y", split_axis=1, concat_axis=0, tiled=True)


def from_y_pencil(pencil, py: int):
    if py == 1:
        return pencil
    return lax.all_to_all(pencil, "y", split_axis=0, concat_axis=1, tiled=True)


def dct2_local(block, py: int, px: int):
    """Distributed 2D DCT-II of the global array, returned in block layout
    (entry (j, i) = spectral coefficient (gy0+j, gx0+i))."""
    _check_pencil(block.shape, py, px)
    t = to_x_pencil(block, px)
    t = _dct_fwd(t, axis=1)
    t = from_x_pencil(t, px)
    t = to_y_pencil(t, py)
    t = _dct_fwd(t, axis=0)
    return from_y_pencil(t, py)


def idct2_local(block, py: int, px: int):
    _check_pencil(block.shape, py, px)
    t = to_y_pencil(block, py)
    t = _dct_inv(t, axis=0)
    t = from_y_pencil(t, py)
    t = to_x_pencil(t, px)
    t = _dct_inv(t, axis=1)
    return from_x_pencil(t, px)


def dct_poisson_local(rhs_b, dx: float, dy: float, py: int, px: int):
    """Exact distributed solve of the clamped-edge (Neumann) FD Poisson
    problem ∇²φ = rhs (solvers/poisson.py solve_poisson_neumann_dct, the
    MAC projection's exact operator) on P("y","x") blocks.

    Six all_to_alls total: the eigenvalue division happens in the y-pencil
    layout between the forward and inverse y-transforms, saving one
    round-trip to block layout."""
    _check_pencil(rhs_b.shape, py, px)
    ny_l, nx_l = rhs_b.shape
    ny_g = ny_l * py
    nx_g = nx_l * px

    # forward x-transform
    t = to_x_pencil(rhs_b, px)
    t = _dct_fwd(t, axis=1)
    t = from_x_pencil(t, px)

    # forward y-transform → y-pencil (ny_g, nx_l/py)
    t = to_y_pencil(t, py)
    t = _dct_fwd(t, axis=0)

    # eigenvalue division at global spectral indices
    iy = lax.axis_index("y")
    ix = lax.axis_index("x")
    q = nx_l // max(py, 1)
    ky = lax.broadcasted_iota(jnp.int32, t.shape, 0)
    kx = ix * nx_l + iy * q + lax.broadcasted_iota(jnp.int32, t.shape, 1)
    # cancellation-safe −4sin²(πk/2n) form of 2cos(πk/n)−2 (fp32-accurate
    # low modes at large n — see poisson._inv_neumann_eigenvalues)
    sy = jnp.sin((np.pi / (2 * ny_g)) * ky.astype(jnp.float32))
    sx = jnp.sin((np.pi / (2 * nx_g)) * kx.astype(jnp.float32))
    lam = (-4.0 / (dy * dy)) * sy * sy + (-4.0 / (dx * dx)) * sx * sx
    zero_mode = (ky == 0) & (kx == 0)
    ilam = jnp.where(zero_mode, 0.0, 1.0 / jnp.where(zero_mode, 1.0, lam))
    t = t * ilam

    # inverse y-transform, back to blocks
    t = _dct_inv(t, axis=0)
    t = from_y_pencil(t, py)

    # inverse x-transform
    t = to_x_pencil(t, px)
    t = _dct_inv(t, axis=1)
    return from_x_pencil(t, px).astype(rhs_b.dtype)


def dct_poisson3d_local(rhs_b, dx: float, dy: float, dz: float,
                        py: int, px: int):
    """Exact distributed 3D clamped-edge (Neumann) Poisson solve on
    P(None, "y", "x") blocks (nz, ny_l, nx_l) — the z axis stays local
    (the cavity3d layout); x and y transforms ride the same pencil
    all_to_alls as the 2D solve (solvers/poisson3d.py method="dct" made
    multi-chip)."""
    nz, ny_l, nx_l = rhs_b.shape
    if ny_l % max(px, 1) != 0 or nx_l % max(py, 1) != 0:
        raise ValueError(
            f"3D pencil decomposition needs block {rhs_b.shape} with y "
            f"divisible by px={px} and x divisible by py={py}"
        )
    ny_g = ny_l * py
    nx_g = nx_l * px

    # z transform: fully local
    t = _dct_fwd(rhs_b, axis=0)
    # x transform: x-pencil (nz, ny_l/px, nx_g)
    t = _a2a(t, "x", 1, 2, px)
    t = _dct_fwd(t, axis=2)
    t = _a2a(t, "x", 2, 1, px)
    # y transform → y-pencil (nz, ny_g, nx_l/py)
    t = _a2a(t, "y", 2, 1, py)
    t = _dct_fwd(t, axis=1)

    iy = lax.axis_index("y")
    ix = lax.axis_index("x")
    q = nx_l // max(py, 1)
    kz = lax.broadcasted_iota(jnp.int32, t.shape, 0)
    ky = lax.broadcasted_iota(jnp.int32, t.shape, 1)
    kx = ix * nx_l + iy * q + lax.broadcasted_iota(jnp.int32, t.shape, 2)
    # cancellation-safe −4sin² form (see the 2D solve above)
    sz = jnp.sin((np.pi / (2 * nz)) * kz.astype(jnp.float32))
    sy = jnp.sin((np.pi / (2 * ny_g)) * ky.astype(jnp.float32))
    sx = jnp.sin((np.pi / (2 * nx_g)) * kx.astype(jnp.float32))
    lam = (
        (-4.0 / (dz * dz)) * sz * sz
        + (-4.0 / (dy * dy)) * sy * sy
        + (-4.0 / (dx * dx)) * sx * sx
    )
    zero_mode = (kz == 0) & (ky == 0) & (kx == 0)
    t = t * jnp.where(zero_mode, 0.0, 1.0 / jnp.where(zero_mode, 1.0, lam))

    t = _dct_inv(t, axis=1)
    t = _a2a(t, "y", 1, 2, py)
    t = _a2a(t, "x", 1, 2, px)
    t = _dct_inv(t, axis=2)
    t = _a2a(t, "x", 2, 1, px)
    return _dct_inv(t, axis=0).astype(rhs_b.dtype)


def make_fdm_poisson_local(hx, hy, py: int, px: int,
                           nullspace_tol: float = 1e-10):
    """Distributed fast-diagonalization Poisson solve for *stretched*
    grids (solvers/fdm.py made multi-chip): returns ``solve(rhs_b)`` for
    use inside shard_map over ("y","x"). The dense eigenbasis matmuls run
    on locally-complete pencil axes (matmul work), with the same six
    all_to_alls as ``dct_poisson_local``; the eigenvalue division happens
    in the y-pencil layout at global spectral indices."""
    import numpy as np

    from cfdsim_tpu.solvers.fdm import (
        _eig_similar_symmetric,
        neumann_operator_1d,
    )

    hx = np.asarray(hx, np.float64)
    hy = np.asarray(hy, np.float64)
    lx, Vx, Vxi = _eig_similar_symmetric(neumann_operator_1d(hx), hx)
    ly, Vy, Vyi = _eig_similar_symmetric(neumann_operator_1d(hy), hy)
    scale = max(np.abs(ly[:, None] + lx[None, :]).max(), 1.0)
    tol = nullspace_tol * scale

    VxT_c = jnp.asarray(Vx.T, jnp.float32)
    VxiT_c = jnp.asarray(Vxi.T, jnp.float32)
    Vy_c = jnp.asarray(Vy, jnp.float32)
    Vyi_c = jnp.asarray(Vyi, jnp.float32)
    lx_c = jnp.asarray(lx, jnp.float32)
    ly_c = jnp.asarray(ly, jnp.float32)

    def solve(rhs_b):
        # fp32 matmul precision: a reduced-precision default (bf16, or
        # TF32 on a GPU) breaks the exactness of the eigenbasis
        # transforms (solvers/fdm.py)
        with jax.default_matmul_precision("float32"):
            return _solve(rhs_b)

    def _solve(rhs_b):
        _check_pencil(rhs_b.shape, py, px)
        ny_l, nx_l = rhs_b.shape
        q = nx_l // max(py, 1)
        iy = lax.axis_index("y")
        ix = lax.axis_index("x")

        t = to_x_pencil(rhs_b, px)
        t = t @ VxiT_c
        t = from_x_pencil(t, px)
        t = to_y_pencil(t, py)
        t = Vyi_c @ t

        # spectral division: rows = all ky, cols = lx slice owned by this
        # pencil (global col offset ix·nx_l + iy·q)
        lx_loc = lax.dynamic_slice(lx_c, (ix * nx_l + iy * q,), (q,))
        lam = ly_c[:, None] + lx_loc[None, :]
        small = jnp.abs(lam) < tol
        t = t * jnp.where(small, 0.0, 1.0 / jnp.where(small, 1.0, lam))

        t = Vy_c @ t
        t = from_y_pencil(t, py)
        t = to_x_pencil(t, px)
        t = t @ VxT_c
        return from_x_pencil(t, px).astype(rhs_b.dtype)

    return solve


def make_fdm_poisson3d_local(hx, hy, hz, py: int, px: int,
                             nullspace_tol: float = 1e-10):
    """Distributed 3D fast-diagonalization Neumann Poisson solve for
    stretched grids on P(None, "y", "x") blocks (nz, ny_l, nx_l): the z
    eigenbasis matmul is fully local, x/y ride the pencil all_to_alls
    (solvers/fdm.py make_fdm_solver_3d made multi-chip)."""
    import numpy as np

    from cfdsim_tpu.solvers.fdm import (
        _eig_similar_symmetric,
        neumann_operator_1d,
    )

    hx = np.asarray(hx, np.float64)
    hy = np.asarray(hy, np.float64)
    hz = np.asarray(hz, np.float64)
    lx, Vx, Vxi = _eig_similar_symmetric(neumann_operator_1d(hx), hx)
    ly, Vy, Vyi = _eig_similar_symmetric(neumann_operator_1d(hy), hy)
    lz, Vz, Vzi = _eig_similar_symmetric(neumann_operator_1d(hz), hz)
    scale = max(
        np.abs(lz[:, None, None] + ly[None, :, None] + lx[None, None, :]).max(),
        1.0,
    )
    tol = nullspace_tol * scale

    VxT_c = jnp.asarray(Vx.T, jnp.float32)
    VxiT_c = jnp.asarray(Vxi.T, jnp.float32)
    Vy_c = jnp.asarray(Vy, jnp.float32)
    Vyi_c = jnp.asarray(Vyi, jnp.float32)
    Vz_c = jnp.asarray(Vz, jnp.float32)
    Vzi_c = jnp.asarray(Vzi, jnp.float32)
    lx_c = jnp.asarray(lx, jnp.float32)
    ly_c = jnp.asarray(ly, jnp.float32)
    lz_c = jnp.asarray(lz, jnp.float32)

    def solve(rhs_b):
        # fp32 matmul precision — see make_fdm_poisson_local
        with jax.default_matmul_precision("float32"):
            return _solve(rhs_b)

    def _solve(rhs_b):
        nz, ny_l, nx_l = rhs_b.shape
        if ny_l % max(px, 1) != 0 or nx_l % max(py, 1) != 0:
            raise ValueError(
                f"3D pencil decomposition needs block {rhs_b.shape} with y "
                f"divisible by px={px} and x divisible by py={py}"
            )
        q = nx_l // max(py, 1)
        iy = lax.axis_index("y")
        ix = lax.axis_index("x")

        t = jnp.einsum("ab,byx->ayx", Vzi_c, rhs_b)       # z (local)
        t = _a2a(t, "x", 1, 2, px)
        t = t @ VxiT_c                                     # x (pencil)
        t = _a2a(t, "x", 2, 1, px)
        t = _a2a(t, "y", 2, 1, py)
        t = jnp.einsum("ab,zbx->zax", Vyi_c, t)            # y (pencil)

        lx_loc = lax.dynamic_slice(lx_c, (ix * nx_l + iy * q,), (q,))
        lam = (
            lz_c[:, None, None] + ly_c[None, :, None] + lx_loc[None, None, :]
        )
        small = jnp.abs(lam) < tol
        t = t * jnp.where(small, 0.0, 1.0 / jnp.where(small, 1.0, lam))

        t = jnp.einsum("ab,zbx->zax", Vy_c, t)
        t = _a2a(t, "y", 1, 2, py)
        t = _a2a(t, "x", 1, 2, px)
        t = t @ VxT_c
        t = _a2a(t, "x", 2, 1, px)
        return jnp.einsum("ab,byx->ayx", Vz_c, t).astype(rhs_b.dtype)

    return solve


def dst_helmholtz_local(b_b, coeff, dx: float, dy: float, py: int, px: int):
    """Exact distributed solve of (I − coeff·∇²) u = b with the one-node
    Dirichlet boundary frame of ``b`` preserved (the distributed
    counterpart of solvers/helmholtz.py solve_helmholtz_dirichlet).

    The interior (ny−2, nx−2) system is DST-I-diagonal; interior lengths
    are odd so they cannot be pencil-split directly. Instead the full
    even-sized array rides the all_to_alls and each 1D DST-I runs on the
    locally-complete axis' 1:-1 interior, re-embedded in the full-size
    frame (frame lines zeroed) for the next transport leg.
    """
    _check_pencil(b_b.shape, py, px)
    ny_l, nx_l = b_b.shape
    ny_g = ny_l * py
    nx_g = nx_l * px
    axc = 1.0 / (dx * dx)
    ayc = 1.0 / (dy * dy)

    iy = lax.axis_index("y")
    ix = lax.axis_index("x")

    # --- fold the known Dirichlet boundary values into the RHS in block
    # layout, where a width-1 halo makes boundary-adjacent lines local
    from cfdsim_tpu.parallel.halo import halo_exchange

    p = halo_exchange(b_b, py, px, width=1)  # zero halos at global edges
    rows = iy * ny_l + lax.broadcasted_iota(jnp.int32, b_b.shape, 0)
    cols = ix * nx_l + lax.broadcasted_iota(jnp.int32, b_b.shape, 1)
    interior = (rows >= 1) & (rows < ny_g - 1) & (cols >= 1) & (cols < nx_g - 1)
    r = b_b
    # neighbor-in-the-frame contributions: coeff·a·(boundary value)
    r = r + coeff * axc * jnp.where(cols == 1, p[1:-1, :-2], 0.0)
    r = r + coeff * axc * jnp.where(cols == nx_g - 2, p[1:-1, 2:], 0.0)
    r = r + coeff * ayc * jnp.where(rows == 1, p[:-2, 1:-1], 0.0)
    r = r + coeff * ayc * jnp.where(rows == ny_g - 2, p[2:, 1:-1], 0.0)
    r = jnp.where(interior, r, 0.0)

    def dstx(t):
        inner = dst1(t[:, 1:-1], axis=1)
        return jnp.pad(inner, ((0, 0), (1, 1)))

    def dsty(t):
        inner = dst1(t[1:-1, :], axis=0)
        return jnp.pad(inner, ((1, 1), (0, 0)))

    # forward x-transform on complete rows
    t = to_x_pencil(r, px)
    t = dstx(t)
    t = from_x_pencil(t, px)

    # forward y-transform on complete columns → y-pencil
    t = to_y_pencil(t, py)
    t = dsty(t)

    # spectral division at global (ky, kx); embedded index = position − 1,
    # frame lines (position 0 / n−1) carry zeros and stay zero
    my, mx = ny_g - 2, nx_g - 2
    q = nx_l // max(py, 1)
    pos_y = lax.broadcasted_iota(jnp.int32, t.shape, 0)
    pos_x = ix * nx_l + iy * q + lax.broadcasted_iota(jnp.int32, t.shape, 1)
    ky = pos_y.astype(jnp.float32)  # spectral index = pos, k runs 1..m at pos 1..m
    kx = pos_x.astype(jnp.float32)
    denom = 1.0 + coeff * (
        2.0 * (axc + ayc)
        - axc * 2.0 * jnp.cos(jnp.pi * kx / (mx + 1))
        - ayc * 2.0 * jnp.cos(jnp.pi * ky / (my + 1))
    )
    # DST-I self-inverse scale: idst = dst · 2/(m+1) per axis
    scale = (2.0 / (my + 1)) * (2.0 / (mx + 1))
    t = t * (scale / denom)

    # inverse y-transform (dst1 again), back to blocks
    t = dsty(t)
    t = from_y_pencil(t, py)

    # inverse x-transform
    t = to_x_pencil(t, px)
    t = dstx(t)
    t = from_x_pencil(t, px)

    return jnp.where(interior, t.astype(b_b.dtype), b_b)
