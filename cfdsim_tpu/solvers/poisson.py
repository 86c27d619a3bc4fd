"""Pressure-Poisson solvers: Jacobi, red-black SOR, geometric multigrid,
and FFT/DCT direct solves.

JAX replacements for the reference's pressure tier:

- scipy sparse-direct + SOR fallback (reference v1.py:195-297) → FFT/DCT
  direct solves and red-black SOR;
- Numba red-black Gauss–Seidel with early exit
  (``solve_pressure_gauss_seidel_fast`` v5.py:202-226) → two masked
  half-sweeps per iteration inside a ``lax.fori_loop`` (fixed budget) or
  ``lax.while_loop`` on a device-reduced residual norm;
- plain Jacobi (reference v5.py:336-346 slow path) → vectorized Jacobi.

Geometric multigrid (V-cycles with red-black smoothing) is the upgrade path
the reference never had. All solvers share one convention:

    solve  ∇²φ = rhs   (for Chorin projection, rhs = div(u*) / dt)

φ is collocated with the velocity field, shape (ny, nx).

Boundary conditions:

- ``"neumann"`` (default, the standard pressure BC): every node is an
  unknown; zero normal gradient is imposed by clamped edge padding
  (ghost = edge value), i.e. the cell-centered mirror convention. This
  operator is exactly diagonalized by a 2D DCT-II, which the ``"dct"``
  direct method exploits, and it coarsens cleanly for multigrid.
- ``"dirichlet"``: the one-node boundary frame stays fixed at φ0's edge
  values (the reference's implicit φ=0 frame, v5.py:202-226) and only
  interior nodes are updated.

An optional boolean ``solid_mask`` freezes φ=0 inside embedded bodies
(reference v5.py:213).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from cfdsim_tpu.ops.stencil import laplacian


METHODS = ("jacobi", "rbsor", "mg", "fft", "dct", "hybrid")


@dataclasses.dataclass(frozen=True)
class PoissonConfig:
    """Static configuration for the pressure solve.

    method: "jacobi" | "rbsor" | "mg" | "fft" | "dct"
            | "hybrid" (exact DCT + masked rbsor repair around solids)
    iters: sweep budget (jacobi/rbsor/hybrid) or number of V-cycles (mg)
    tol: if > 0, stop early once max-residual < tol (while_loop mode,
         reproducing the reference's early exit v5.py:224-225)
    check_every: sweeps between residual checks in while_loop mode
    omega: SOR relaxation factor (1.0 = Gauss-Seidel)
    bc: "neumann" | "dirichlet" for the iterative methods and "dct"
        (which is Neumann-only); "periodic" is solved only by "fft" —
        iterative methods raise rather than silently solving the
        Dirichlet-frame problem
    mg_pre/mg_post: smoothing sweeps per level; mg_coarse: coarsest sweeps
    """

    method: str = "rbsor"
    iters: int = 100
    tol: float = 0.0
    check_every: int = 8
    omega: float = 1.7
    bc: str = "neumann"
    mg_pre: int = 2
    mg_post: int = 2
    mg_coarse: int = 40
    mg_min_size: int = 4
    # exact-DCT backend: "rfft" (per-axis FFTs), "rfft2" (single 2D FFT),
    # "rfft_split[4|8]" (half-length internal FFTs), "packed" (half-FFT
    # Makhoul packing), "matmul" (dense fast-diagonalization), or "auto"
    # — first call per (device kind, shape) times all variants on the
    # live hardware and caches the winner (solvers/autotune.py); every
    # variant is exact with the same nullspace convention ("rfft2" needs
    # even×even, else it falls back to the per-axis path)
    dct_variant: str = "rfft"

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(
                f"unknown poisson method {self.method!r}; expected one of "
                f"{METHODS}")


# ---------------------------------------------------------------------------
# operators for the two BC conventions
# ---------------------------------------------------------------------------

def _neighbor_sum_neumann(phi, ax: float, ay: float):
    """ax*(E+W) + ay*(N+S) with clamped edge padding (ghost = edge)."""
    p = jnp.pad(phi, 1, mode="edge")
    return ax * (p[1:-1, 2:] + p[1:-1, :-2]) + ay * (p[2:, 1:-1] + p[:-2, 1:-1])


def _neighbor_sum_dirichlet(phi, ax: float, ay: float):
    """Interior-valid neighbor sum, zero-padded back to full shape."""
    s = ax * (phi[1:-1, 2:] + phi[1:-1, :-2]) + ay * (
        phi[2:, 1:-1] + phi[:-2, 1:-1]
    )
    return jnp.pad(s, ((1, 1), (1, 1)))


def lap_neumann(phi, dx: float, dy: float):
    """5-point Laplacian with clamped edge padding, defined on all nodes."""
    ax = 1.0 / (dx * dx)
    ay = 1.0 / (dy * dy)
    return _neighbor_sum_neumann(phi, ax, ay) - 2.0 * (ax + ay) * phi


def _color_masks(shape, bc: str, solid_mask):
    """(red, black) boolean masks of updatable nodes (trace-time consts)."""
    ny, nx = shape
    ij = np.add.outer(np.arange(ny), np.arange(nx))
    if bc == "neumann":
        updatable = np.ones(shape, dtype=bool)
    else:  # dirichlet: frame is fixed
        updatable = np.zeros(shape, dtype=bool)
        updatable[1:-1, 1:-1] = True
    red = jnp.asarray(((ij % 2) == 0) & updatable)
    black = jnp.asarray(((ij % 2) == 1) & updatable)
    if solid_mask is not None:
        fluid = jnp.logical_not(jnp.asarray(solid_mask, dtype=bool))
        red = jnp.logical_and(red, fluid)
        black = jnp.logical_and(black, fluid)
    return red, black


def poisson_residual(phi, rhs, dx: float, dy: float, solid_mask=None, bc="neumann"):
    """Max-abs residual |∇²φ − rhs| over updatable nodes.

    This is the quantity the while_loop early exit reduces with a device-wide
    max — the multi-chip analog is a ``lax.pmax`` over the mesh.
    """
    if bc == "neumann":
        r = lap_neumann(phi, dx, dy) - rhs
        m = jnp.ones(phi.shape, dtype=bool)
    else:
        r = laplacian(phi, dx, dy) - rhs
        frame = np.zeros(phi.shape, dtype=bool)
        frame[1:-1, 1:-1] = True
        m = jnp.asarray(frame)
    if solid_mask is not None:
        m = jnp.logical_and(m, jnp.logical_not(jnp.asarray(solid_mask, bool)))
    return jnp.max(jnp.where(m, jnp.abs(r), 0.0))


# ---------------------------------------------------------------------------
# smoothers
# ---------------------------------------------------------------------------

def _sweep(phi, rhs, dx: float, dy: float, colors, omega: float, bc: str):
    """One smoothing sweep. ``colors`` is a tuple of update masks: one
    entry → Jacobi; (red, black) → red-black Gauss–Seidel/SOR where the
    black half reads freshly updated red values (preserving the sequential
    ordering of the reference kernel v5.py:211-223 without its loop)."""
    ax = 1.0 / (dx * dx)
    ay = 1.0 / (dy * dy)
    denom_inv = 1.0 / (2.0 * (ax + ay))
    nb = _neighbor_sum_neumann if bc == "neumann" else _neighbor_sum_dirichlet
    for color in colors:
        phi_star = (nb(phi, ax, ay) - rhs) * denom_inv
        upd = (1.0 - omega) * phi + omega * phi_star
        phi = jnp.where(color, upd, phi)
    return phi


def _iterate(sweep_fn, phi, rhs, cfg: PoissonConfig, dx, dy, solid_mask):
    """Run sweeps for a fixed budget, or until tol with periodic checks."""
    if cfg.tol <= 0.0:
        return jax.lax.fori_loop(0, cfg.iters, lambda _, p: sweep_fn(p), phi)

    check = max(1, cfg.check_every)
    n_chunks = max(1, cfg.iters // check)

    def cond(carry):
        p, res, i = carry
        return jnp.logical_and(res > cfg.tol, i < n_chunks)

    def body(carry):
        p, _, i = carry
        p = jax.lax.fori_loop(0, check, lambda _, q: sweep_fn(q), p)
        res = poisson_residual(p, rhs, dx, dy, solid_mask, cfg.bc)
        return p, res, i + 1

    phi, _, _ = jax.lax.while_loop(
        cond, body, (phi, jnp.asarray(jnp.inf, phi.dtype), 0)
    )
    return phi


# ---------------------------------------------------------------------------
# geometric multigrid (Neumann, cell-centered convention)
# ---------------------------------------------------------------------------

def _restrict(r):
    """Full-weighting restriction: 2x2 block average (halves both dims)."""
    ny, nx = r.shape
    return r.reshape(ny // 2, 2, nx // 2, 2).mean(axis=(1, 3))


def _prolong_axis(e, axis: int):
    """Bilinear cell-centered prolongation along one axis: fine value at 2i
    gets weights (3/4, 1/4) from coarse cells (i, i−1), at 2i+1 from
    (i, i+1), with clamped ends (consistent with the Neumann operator)."""
    n = e.shape[axis]
    first = jax.lax.slice_in_dim(e, 0, 1, axis=axis)
    last = jax.lax.slice_in_dim(e, n - 1, n, axis=axis)
    lo = jnp.concatenate([first, jax.lax.slice_in_dim(e, 0, n - 1, axis=axis)], axis=axis)
    hi = jnp.concatenate([jax.lax.slice_in_dim(e, 1, n, axis=axis), last], axis=axis)
    a = 0.75 * e + 0.25 * lo
    b = 0.75 * e + 0.25 * hi
    st = jnp.stack([a, b], axis=axis + 1)
    shape = list(e.shape)
    shape[axis] *= 2
    return st.reshape(shape)


def _prolong(e):
    """Bilinear prolongation (doubles both dims)."""
    return _prolong_axis(_prolong_axis(e, 0), 1)


def _mg_level_shapes(shape, min_size: int):
    shapes = [tuple(shape)]
    ny, nx = shape
    while ny % 2 == 0 and nx % 2 == 0 and min(ny, nx) // 2 >= min_size:
        ny, nx = ny // 2, nx // 2
        shapes.append((ny, nx))
    return shapes


def _mg_masks(shape, solid_mask, cfg: PoissonConfig):
    """Color/fluid masks for every multigrid level (trace-time constants)."""
    shapes = _mg_level_shapes(shape, cfg.mg_min_size)
    masks = [_color_masks(s, "neumann", None) for s in shapes]
    return masks, shapes


def _vcycle(phi, rhs, dx, dy, cfg: PoissonConfig, masks_by_level, level, n_levels):
    colors = masks_by_level[level]
    # plain red-black Gauss-Seidel (omega=1) is the right MG smoother;
    # over-relaxation hurts the smoothing factor

    def smooth(p, n_sweeps):
        if n_sweeps == 0:
            return p
        sweep = partial(
            _sweep, rhs=rhs, dx=dx, dy=dy, colors=colors, omega=1.0,
            bc="neumann",
        )
        return jax.lax.fori_loop(0, n_sweeps, lambda _, q: sweep(q), p)

    phi = smooth(phi, cfg.mg_pre)
    if level == n_levels - 1:
        return smooth(phi, cfg.mg_coarse)
    r = rhs - lap_neumann(phi, dx, dy)
    r = jnp.where(jnp.logical_or(*colors), r, 0.0)  # zero inside solids
    e_c = jnp.zeros_like(r[::2, ::2])
    e_c = _vcycle(
        e_c, _restrict(r), 2 * dx, 2 * dy, cfg, masks_by_level, level + 1, n_levels
    )
    fluid = jnp.logical_or(*colors)
    phi = phi + jnp.where(fluid, _prolong(e_c), 0.0)
    return smooth(phi, cfg.mg_post)


# ---------------------------------------------------------------------------
# FFT / DCT direct solves
# ---------------------------------------------------------------------------

def solve_poisson_periodic_fft(rhs, dx: float, dy: float):
    """Exact solve of the 5-point FD Poisson problem on a fully periodic
    grid, using the discrete symbol λ(k) = (2cos(2πk/n)−2)/h² so the result
    is consistent with the central-difference divergence/gradient operators
    (not the continuous spectral Laplacian)."""
    ny, nx = rhs.shape
    kx = jnp.fft.rfftfreq(nx)
    ky = jnp.fft.fftfreq(ny)
    lam = (2.0 * jnp.cos(2.0 * jnp.pi * kx)[None, :] - 2.0) / (dx * dx) + (
        2.0 * jnp.cos(2.0 * jnp.pi * ky)[:, None] - 2.0
    ) / (dy * dy)
    lam = lam.at[0, 0].set(1.0)
    rhs_hat = jnp.fft.rfft2(rhs)
    phi_hat = rhs_hat / lam
    phi_hat = phi_hat.at[0, 0].set(0.0)
    return jnp.fft.irfft2(phi_hat, s=(ny, nx)).astype(rhs.dtype)


def _dct2(x, axis: int):
    """(Unnormalized) DCT-II along ``axis`` via an even-extension FFT."""
    n = x.shape[axis]
    v = jnp.concatenate([x, jnp.flip(x, axis)], axis=axis)
    V = jnp.fft.fft(v, axis=axis)
    k = jnp.arange(n)
    shape = [1] * x.ndim
    shape[axis] = n
    shift = jnp.exp(-1j * jnp.pi * k / (2 * n))
    Vk = jax.lax.slice_in_dim(V, 0, n, axis=axis)
    return jnp.real(shift.reshape(shape) * Vk)


def _idct2(X, axis: int):
    """Exact inverse of ``_dct2``: rebuild the even-extension spectrum
    (V[k] = e^{iπk/2n}·X[k], V[n] = 0, V[2n−k] = conj(V[k])) and ifft."""
    n = X.shape[axis]
    k = jnp.arange(n)
    shape = [1] * X.ndim
    shape[axis] = n
    head = X.astype(jnp.complex64) * jnp.exp(1j * jnp.pi * k / (2 * n)).reshape(shape)
    zero = jnp.zeros_like(jax.lax.slice_in_dim(head, 0, 1, axis=axis))
    tail = jnp.conj(jnp.flip(jax.lax.slice_in_dim(head, 1, n, axis=axis), axis=axis))
    V = jnp.concatenate([head, zero, tail], axis=axis)
    v = jnp.fft.ifft(V, axis=axis)
    return jnp.real(jax.lax.slice_in_dim(v, 0, n, axis=axis))


def _dct2_fast(x, axis: int, split: int = 0):
    """Makhoul single-FFT DCT-II (same 2× scale as ``_dct2``): permute to
    v = [x_even, reversed(x_odd)], take one real FFT of length n (vs the
    even-extension's complex FFT of length 2n — ~4× less FFT work), and
    twiddle. Requires even n along ``axis``. ``split=k`` (k ≥ 1) computes
    the internal rfft via a half-length complex FFT (``_rfft_half``) with
    k−1 further radix-2 peels — the escape hatch from XLA's >2048 FFT
    superlinearity (internal FFT length n / 2^k)."""
    n = x.shape[axis]
    ev = jax.lax.slice_in_dim(x, 0, n, 2, axis=axis)
    od = jax.lax.slice_in_dim(x, 1, n, 2, axis=axis)
    v = jnp.concatenate([ev, jnp.flip(od, axis)], axis=axis)
    if split:
        W = _rfft_half(v, axis, depth=int(split) - 1)  # length n//2 + 1
    else:
        W = jnp.fft.rfft(v, axis=axis)  # length n//2 + 1
    # half-spectrum twiddle: with B = e^{-iπk/2n}·W[k] (k ≤ n/2),
    # X[k] = 2·Re(B[k]) and X[n−k] = −2·Im(B[k])
    k = jnp.arange(n // 2 + 1)
    shape = [1] * x.ndim
    shape[axis] = n // 2 + 1
    B = jnp.exp(-1j * jnp.pi * k / (2 * n)).reshape(shape) * W
    head = 2.0 * jnp.real(B)
    tail = -2.0 * jnp.flip(
        jnp.imag(jax.lax.slice_in_dim(B, 1, n // 2, axis=axis)), axis
    )
    return jnp.concatenate([head, tail], axis=axis)


def _idct2_fast(X, axis: int, scale_k=None, scale_nk=None,
                split: int = 0):
    """Exact inverse of ``_dct2_fast``: rebuild the permuted-sequence
    spectrum V[k] = e^{iπk/2n}·(X[k] − i·X[n−k])/2, one ifft, un-permute.

    ``scale_k``/``scale_nk`` optionally fold an elementwise spectral
    multiplier s into this pass (V built from s[k]·X[k] and s[n−k]·X[n−k])
    — the Poisson solve uses it to apply 1/λ without a separate
    full-array pass. ``split=k`` pairs with ``_dct2_fast(split=k)``
    (half-length complex ifft, k−1 extra radix-2 peels)."""
    n = X.shape[axis]
    # the permuted sequence v is real, so its spectrum is Hermitian: only
    # V[0..n/2] is needed and a real irfft recovers v at half the FFT work
    k = jnp.arange(n // 2 + 1)
    shape = [1] * X.ndim
    shape[axis] = n // 2 + 1
    Xk = jax.lax.slice_in_dim(X, 0, n // 2 + 1, axis=axis)
    rev = jnp.flip(jax.lax.slice_in_dim(X, n // 2 + 1, n, axis=axis), axis)
    zero = jnp.zeros_like(jax.lax.slice_in_dim(X, 0, 1, axis=axis))
    # X[n−k] for k = 0..n/2  (k=0 → 0 by convention, k=n/2 → X[n/2])
    Xnk = jnp.concatenate(
        [zero, rev, jax.lax.slice_in_dim(X, n // 2, n // 2 + 1, axis=axis)],
        axis=axis,
    )
    if scale_k is not None:
        Xk = Xk * scale_k
        Xnk = Xnk * scale_nk
    V = jnp.exp(1j * jnp.pi * k / (2 * n)).reshape(shape) * (
        0.5 * (Xk - 1j * Xnk)
    )
    if split:
        v = _irfft_half(V, n, axis, depth=int(split) - 1)
    else:
        v = jnp.fft.irfft(V, n=n, axis=axis)
    ev = jax.lax.slice_in_dim(v, 0, n // 2, axis=axis)
    od = jnp.flip(jax.lax.slice_in_dim(v, n // 2, n, axis=axis), axis)
    return jnp.stack([ev, od], axis=axis + 1).reshape(X.shape)


def _spectrum_reverse(F, axis: int):
    """F[(n−k) mod n]: index-reversal of a full FFT spectrum."""
    return jnp.roll(jnp.flip(F, axis), 1, axis)


def _fft_split(z, axis: int, depth: int):
    """Complex FFT with ``depth`` radix-2 decimation-in-time levels
    peeled off explicitly: fft_n = butterfly(fft_{n/2}(even),
    fft_{n/2}(odd)), the two half transforms batched in ONE call along
    a fresh leading axis (XLA FFT cost depends on LENGTH, not batch —
    the >2048 superlinearity motivates trading length for batch)."""
    if depth <= 0:
        return jnp.fft.fft(z, axis=axis)
    n = z.shape[axis]
    ze = jax.lax.slice_in_dim(z, 0, n, 2, axis=axis)
    zo = jax.lax.slice_in_dim(z, 1, n, 2, axis=axis)
    ZZ = _fft_split(jnp.stack([ze, zo]), axis + 1, depth - 1)
    E = ZZ[0]
    O = ZZ[1]
    k = jnp.arange(n // 2)
    shape = [1] * E.ndim
    shape[axis] = n // 2
    wO = jnp.exp(-2j * jnp.pi * k / n).reshape(shape) * O
    return jnp.concatenate([E + wO, E - wO], axis=axis)


def _ifft_split(Z, axis: int, depth: int):
    """Inverse of ``_fft_split`` (same radix-2 peel, conjugate
    twiddles, 1/2 per level)."""
    if depth <= 0:
        return jnp.fft.ifft(Z, axis=axis)
    n = Z.shape[axis]
    A = jax.lax.slice_in_dim(Z, 0, n // 2, axis=axis)
    B = jax.lax.slice_in_dim(Z, n // 2, n, axis=axis)
    k = jnp.arange(n // 2)
    shape = [1] * Z.ndim
    shape[axis] = n // 2
    wc = jnp.exp(2j * jnp.pi * k / n).reshape(shape)
    zz = _ifft_split(
        jnp.stack([0.5 * (A + B), 0.5 * wc * (A - B)]), axis + 1,
        depth - 1,
    )
    ze = zz[0]
    zo = zz[1]
    out_shape = list(Z.shape)
    return jnp.stack([ze, zo], axis=axis + 1).reshape(out_shape)


def _rfft_half(v, axis: int, depth: int = 0):
    """rfft of real even-length ``v`` via ONE half-length complex FFT
    (classic even/odd packing + Hermitian split).

    Where a backend's FFT grows superlinearly in length, halving the
    transform length keeps it in the fast regime at the cost of two
    elementwise spectral passes. Used by the autotuned
    ``dct_variant="rfft_split"`` candidate. ``depth`` peels further
    radix-2 levels off the internal complex FFT (``_fft_split``) —
    the 8192 path."""
    n = v.shape[axis]
    ve = jax.lax.slice_in_dim(v, 0, n, 2, axis=axis)
    vo = jax.lax.slice_in_dim(v, 1, n, 2, axis=axis)
    Z = _fft_split(ve + 1j * vo, axis, depth)  # length n/2
    Zr = jnp.conj(_spectrum_reverse(Z, axis))  # conj Z[(−k) mod n/2]
    E = 0.5 * (Z + Zr)
    O = -0.5j * (Z - Zr)
    k = jnp.arange(n // 2)
    shape = [1] * v.ndim
    shape[axis] = n // 2
    w = jnp.exp(-2j * jnp.pi * k / n).reshape(shape)
    head = E + w * O  # X[k], k = 0..n/2−1
    nyq = jax.lax.slice_in_dim(E - O, 0, 1, axis=axis)  # X[n/2] = E0 − O0
    return jnp.concatenate([head, nyq], axis=axis)


def _irfft_half(X, n: int, axis: int, depth: int = 0):
    """Exact inverse of ``_rfft_half``: rebuild the packed half-length
    spectrum from the Hermitian half-spectrum and take one complex
    ifft. ``X`` has length n/2+1 along ``axis``. ``depth`` mirrors
    ``_rfft_half`` (extra radix-2 peels via ``_ifft_split``)."""
    m = n // 2
    Xk = jax.lax.slice_in_dim(X, 0, m, axis=axis)  # k = 0..n/2−1
    # conj X[n/2−k] for k = 0..n/2−1
    Xc = jnp.conj(jnp.flip(jax.lax.slice_in_dim(X, 1, m + 1, axis=axis),
                           axis))
    k = jnp.arange(m)
    shape = [1] * X.ndim
    shape[axis] = m
    wc = jnp.exp(2j * jnp.pi * k / n).reshape(shape)  # conj(w)
    E = 0.5 * (Xk + Xc)
    O = 0.5 * wc * (Xk - Xc)
    z = _ifft_split(E + 1j * O, axis, depth)
    out_shape = list(X.shape)
    out_shape[axis] = n
    return jnp.stack(
        [jnp.real(z), jnp.imag(z)], axis=axis + 1
    ).reshape(out_shape)


def _cdct(z, axis: int):
    """Complexified Makhoul DCT-II along ``axis``: DCT(Re z) + i·DCT(Im z)
    in ONE full-length complex FFT, via

        X[k] = tw[k]·F[k] + conj(tw[k])·F[(n−k) mod n],  tw = e^{−iπk/2n},

    which reduces to 2·Re(tw·F) for real input (the ``_dct2_fast`` scale).
    Packing two real lines per complex line halves the FFT work, which
    pays where a backend's rfft costs nearly a full complex FFT (the
    autotuner decides). Requires even n."""
    n = z.shape[axis]
    ev = jax.lax.slice_in_dim(z, 0, n, 2, axis=axis)
    od = jax.lax.slice_in_dim(z, 1, n, 2, axis=axis)
    v = jnp.concatenate([ev, jnp.flip(od, axis)], axis=axis)
    F = jnp.fft.fft(v, axis=axis)
    k = jnp.arange(n)
    shape = [1] * z.ndim
    shape[axis] = n
    tw = jnp.exp(-1j * jnp.pi * k / (2 * n)).reshape(shape)
    return tw * F + jnp.conj(tw) * _spectrum_reverse(F, axis)


def _icdct(X, axis: int):
    """Exact inverse of ``_cdct`` (complexified, same C-linear map on
    packed pairs): F[k] = e^{iπk/2n}·(X[k] − i·X_rev[k])/2 with
    X_rev = [0, X[n−1], …, X[1]], one complex ifft, un-permute."""
    n = X.shape[axis]
    rev = jnp.flip(jax.lax.slice_in_dim(X, 1, n, axis=axis), axis)
    zero = jnp.zeros_like(jax.lax.slice_in_dim(X, 0, 1, axis=axis))
    Xrev = jnp.concatenate([zero, rev], axis=axis)
    k = jnp.arange(n)
    shape = [1] * X.ndim
    shape[axis] = n
    tw = jnp.exp(1j * jnp.pi * k / (2 * n)).reshape(shape)
    F = tw * (X - 1j * Xrev) * 0.5
    v = jnp.fft.ifft(F, axis=axis)
    ev = jax.lax.slice_in_dim(v, 0, n // 2, axis=axis)
    od = jnp.flip(jax.lax.slice_in_dim(v, n // 2, n, axis=axis), axis)
    return jnp.stack([ev, od], axis=axis + 1).reshape(X.shape)


def _pack(a, axis: int):
    """Pack adjacent line pairs along ``axis`` into complex: a0 + i·a1."""
    m = a.shape[axis]
    p = jax.lax.slice_in_dim(a, 0, m, 2, axis=axis)
    q = jax.lax.slice_in_dim(a, 1, m, 2, axis=axis)
    return p + 1j * q


def _unpack(z, axis: int, out_shape):
    """Interleave Re/Im back into adjacent real lines along ``axis``."""
    return jnp.stack([jnp.real(z), jnp.imag(z)], axis=axis + 1).reshape(out_shape)


def _dct2d_packed(x):
    """Full 2D DCT-II of a real even×even array with half-size complex
    FFTs: each axis transform packs line pairs along the *other* axis
    (two real transforms per complex FFT)."""
    shp = x.shape
    A = _unpack(_cdct(_pack(x, 0), 1), 0, shp)  # axis-1 DCT, rows packed
    return _unpack(_cdct(_pack(A, 1), 0), 1, shp)  # axis-0 DCT, cols packed


def _idct2d_packed(X):
    shp = X.shape
    A = _unpack(_icdct(_pack(X, 1), 0), 1, shp)
    return _unpack(_icdct(_pack(A, 0), 1), 0, shp)


def _dct2d_rfft2(x):
    """Full 2D DCT-II (same 2×-per-axis scale as ``_dct2_fast``) of a
    real even×even array via ONE ``rfft2``.

    Doing both axes in a single real 2D FFT and recombining quadrants
    with twiddles trades per-axis FFT passes for cheap elementwise
    ones; the autotuner measures whether that wins.  Identity (2D Makhoul): with v the per-axis permuted
    sequence v[m1,m2] = x[σ(m1),σ(m2)], V = DFT2(v), w_a(k)=e^{−iπk/2n_a},
    G = w₂·V, and G̃[k1,k2] = conj(G[(−k1) mod m, k2]):

        C[k1, k2]   = 2·Re{ w₁·(G + G̃) }          (k2 ≤ n/2)
        C[k1, n−k2] = 2·Re{ i·w₁·(G − G̃) }        (1 ≤ k2 ≤ n/2−1)

    which needs exactly the rfft2 half-spectrum (k2 ∈ [0, n/2])."""
    m, n = x.shape
    v = jnp.concatenate([x[::2], jnp.flip(x[1::2], 0)], 0)
    v = jnp.concatenate([v[:, ::2], jnp.flip(v[:, 1::2], 1)], 1)
    V = jnp.fft.rfft2(v)  # (m, n//2 + 1)
    k1 = jnp.arange(m)[:, None]
    k2 = jnp.arange(n // 2 + 1)[None, :]
    w1 = jnp.exp(-1j * jnp.pi * k1 / (2 * m))
    G = jnp.exp(-1j * jnp.pi * k2 / (2 * n)) * V
    Gf = jnp.conj(jnp.roll(jnp.flip(G, 0), 1, 0))  # conj G[(−k1)%m, k2]
    head = 2.0 * jnp.real(w1 * (G + Gf))
    tail = 2.0 * jnp.real(1j * w1 * (G - Gf))
    return jnp.concatenate([head, jnp.flip(tail[:, 1 : n // 2], 1)], 1)


def _idct2d_rfft2(X, scale=None):
    """Exact inverse of ``_dct2d_rfft2`` (even×even), one ``irfft2``.

    Reconstruction in two cheap spectral passes: along axis 1 the 1D
    rule S = ½·w₂*·(C[k2] − i·C[(n−k2) mod n]) (real C, zero-at-k2=0
    convention for the reversed term), then along axis 0 the SAME rule
    applied to the now-complex S — valid because the degenerate pair
    algebra (k1 ↔ m−k1) closes without conjugation:
    V = ½·w₁*·(S − i·S[(m−k1) mod m]).  ``scale`` optionally folds a
    real spectral multiplier (the Poisson 1/λ) into the first pass."""
    m, n = X.shape
    if scale is not None:
        X = X * scale
    k2 = jnp.arange(n // 2 + 1)[None, :]
    Xk = X[:, : n // 2 + 1]
    Xnk = jnp.concatenate(
        [jnp.zeros((m, 1), X.dtype), jnp.flip(X[:, n // 2 + 1 :], 1),
         X[:, n // 2 : n // 2 + 1]], 1)
    S = jnp.exp(1j * jnp.pi * k2 / (2 * n)) * (0.5 * (Xk - 1j * Xnk))
    k1 = jnp.arange(m)[:, None]
    Sf = jnp.concatenate(
        [jnp.zeros((1, S.shape[1]), S.dtype), jnp.flip(S[1:], 0)], 0)
    V = jnp.exp(1j * jnp.pi * k1 / (2 * m)) * (0.5 * (S - 1j * Sf))
    v = jnp.fft.irfft2(V, s=(m, n))
    v = jnp.stack([v[: m // 2], jnp.flip(v[m // 2 :], 0)], 1).reshape(
        m, v.shape[1])
    return jnp.stack([v[:, : n // 2], jnp.flip(v[:, n // 2 :], 1)],
                     2).reshape(m, n)


def _dct3d_rfftn(x):
    """Full 3D DCT-II (2×-per-axis scale) of a real even³ array via ONE
    ``rfftn`` — the 3D extension of ``_dct2d_rfft2``.

    With v the per-axis permuted sequence, V = DFT3(v) (rfftn: k2 half),
    Vf = V[(−k0)%n0, (−k1)%n1, k2], and the two k2-quadrant fields

        G1 = w₂·V + w₂*·conj(Vf)          (→ C[..., k2],    k2 ≤ n2/2)
        G2 = i·(w₂·V − w₂*·conj(Vf))      (→ C[..., n2−k2], 1 ≤ k2 < n2/2)

    each satisfies Gj[−k0,−k1] = conj(Gj), so the 4-term (±k0, ±k1)
    recombination collapses to the same 2-term form as in 2D:

        Cj[k0,k1,k2] = 2·Re{ w₀·( w₁·Gj + w₁*·Gj[k0, (−k1)%n1, k2] ) }."""
    n0, n1, n2 = x.shape
    v = jnp.concatenate([x[::2], jnp.flip(x[1::2], 0)], 0)
    v = jnp.concatenate([v[:, ::2], jnp.flip(v[:, 1::2], 1)], 1)
    v = jnp.concatenate([v[:, :, ::2], jnp.flip(v[:, :, 1::2], 2)], 2)
    # rfftn composed as a 2D real FFT over the trailing axes plus a
    # complex FFT along axis 0 (numerically identical; ROADMAP Design 4
    # lists the single rank-3 FFT as the simpler form)
    V = jnp.fft.fft(jnp.fft.rfft2(v, axes=(1, 2)), axis=0)
    w0 = jnp.exp(-1j * jnp.pi * jnp.arange(n0) / (2 * n0))[:, None, None]
    w1 = jnp.exp(-1j * jnp.pi * jnp.arange(n1) / (2 * n1))[None, :, None]
    w2 = jnp.exp(-1j * jnp.pi * jnp.arange(n2 // 2 + 1) / (2 * n2))[None, None, :]

    def flip_mod(a, axis):  # a[(−k) % n] along axis
        return jnp.roll(jnp.flip(a, axis), 1, axis)

    Vf = flip_mod(flip_mod(V, 0), 1)
    A, B = w2 * V, jnp.conj(w2) * jnp.conj(Vf)
    out = []
    for Gj in (A + B, 1j * (A - B)):
        Qj = flip_mod(Gj, 1)
        out.append(2.0 * jnp.real(w0 * (w1 * Gj + jnp.conj(w1) * Qj)))
    head, tail = out
    return jnp.concatenate([head, jnp.flip(tail[:, :, 1 : n2 // 2], 2)], 2)


def _spectral_unfold(X, wconj, axis: int):
    """One axis of the inverse-Makhoul reconstruction, valid for complex
    input: ½·wconj·(X − i·X[(n−k)%n]) with the zero-at-k=0 convention
    for the reversed term (``_idct2d_rfft2``'s rule, axis-generic);
    ``wconj`` is the conjugate twiddle e^{+iπk/2n}."""
    n = X.shape[axis]
    zero = jnp.zeros_like(jax.lax.slice_in_dim(X, 0, 1, axis=axis))
    rev = jnp.flip(jax.lax.slice_in_dim(X, 1, n, axis=axis), axis)
    Xr = jnp.concatenate([zero, rev], axis=axis)
    return wconj * (0.5 * (X.astype(Xr.dtype) - 1j * Xr))


def _idct3d_rfftn(X, scale=None):
    """Exact inverse of ``_dct3d_rfftn`` (even³), one ``irfftn``:
    the axis-2 real-input reconstruction to the k2 half-spectrum, then
    the complex-valid unfold along axes 1 and 0, then un-permute."""
    n0, n1, n2 = X.shape
    if scale is not None:
        X = X * scale
    w0 = jnp.exp(1j * jnp.pi * jnp.arange(n0) / (2 * n0))[:, None, None]
    w1 = jnp.exp(1j * jnp.pi * jnp.arange(n1) / (2 * n1))[None, :, None]
    w2 = jnp.exp(1j * jnp.pi * jnp.arange(n2 // 2 + 1) / (2 * n2))[None, None, :]
    Xk = X[:, :, : n2 // 2 + 1]
    Xnk = jnp.concatenate(
        [jnp.zeros((n0, n1, 1), X.dtype), jnp.flip(X[:, :, n2 // 2 + 1 :], 2),
         X[:, :, n2 // 2 : n2 // 2 + 1]], 2)
    S = w2 * (0.5 * (Xk - 1j * Xnk))
    S = _spectral_unfold(S, w1, 1)
    V = _spectral_unfold(S, w0, 0)
    # inverse of the composed rfftn: ifft along axis 0, then a 2D real
    # inverse
    v = jnp.fft.irfft2(jnp.fft.ifft(V, axis=0), s=(n1, n2), axes=(1, 2))
    v = jnp.stack([v[: n0 // 2], jnp.flip(v[n0 // 2 :], 0)], 1).reshape(
        n0, n1, v.shape[2])
    v = jnp.stack([v[:, : n1 // 2], jnp.flip(v[:, n1 // 2 :], 1)], 2).reshape(
        n0, n1, v.shape[2])
    return jnp.stack([v[:, :, : n2 // 2], jnp.flip(v[:, :, n2 // 2 :], 2)],
                     3).reshape(n0, n1, n2)


def _dct_fwd(x, axis: int):
    return _dct2_fast(x, axis) if x.shape[axis] % 2 == 0 else _dct2(x, axis)


def _dct_inv(X, axis: int):
    return _idct2_fast(X, axis) if X.shape[axis] % 2 == 0 else _idct2(X, axis)


# Above this many entries the 1/λ table is built IN-TRACE instead of
# being baked as a numpy constant, which keeps 8192²-class grids from
# embedding 2×134 MB fp32 constants in the compiled program. Below the
# threshold the baked constant is kept: the in-trace build is re-executed
# every solve inside a scan unless XLA hoists the trig+reciprocal passes
# as loop-invariant. Which side wins on the GPU is not measured
# (ROADMAP Design 4).
_ILAM_BAKE_LIMIT = (1 << 24) + 1


def _inv_neumann_eigenvalues(m: int, n: int, dx: float, dy: float):
    """1/λ table for the clamped-edge (DCT-II-diagonal) FD Laplacian.

    Uses the cancellation-safe identity 2cos(πk/n)−2 = −4sin²(πk/2n):
    fp32 cos near 1 loses ~80% of λ₁ at n=8192, fp32 sin near 0 loses
    nothing. Baked as an f64-derived numpy fp32 constant for small
    grids; built in-trace (iota + elementwise) past _ILAM_BAKE_LIMIT."""
    if m * n <= _ILAM_BAKE_LIMIT:
        sy = np.sin(np.pi * np.arange(m) / (2 * m))
        sx = np.sin(np.pi * np.arange(n) / (2 * n))
        lam = (-4.0 / (dy * dy)) * (sy * sy)[:, None] + (
            -4.0 / (dx * dx)
        ) * (sx * sx)[None, :]
        lam[0, 0] = 1.0
        ilam = (1.0 / lam).astype(np.float32)
        ilam[0, 0] = 0.0  # project out the constant nullspace mode
        return jnp.asarray(ilam)
    ky = jnp.arange(m, dtype=jnp.float32)
    kx = jnp.arange(n, dtype=jnp.float32)
    sy = jnp.sin((np.pi / (2 * m)) * ky)
    sx = jnp.sin((np.pi / (2 * n)) * kx)
    lam = (-4.0 / (dy * dy)) * (sy * sy)[:, None] + (
        -4.0 / (dx * dx)
    ) * (sx * sx)[None, :]
    lam = lam.at[0, 0].set(1.0)
    ilam = 1.0 / lam
    return ilam.at[0, 0].set(0.0)  # project out the constant nullspace


def solve_poisson_neumann_dct(rhs, dx: float, dy: float,
                              variant: str = "rfft"):
    """Exact solve of the clamped-edge (Neumann) FD Poisson problem.

    The mirror-about-half-sample symmetry of the clamped-edge operator makes
    it exactly diagonal in the 2D DCT-II basis with eigenvalues
    λ_k = (2cos(πk/n)−2)/h². The constant nullspace mode is projected out,
    matching the iterative solvers' mean-free convention."""
    m, n = rhs.shape
    # variant="packed": the half-FFT Makhoul packing (two real lines per
    # complex FFT): cheaper FFTs, extra complex elementwise passes
    # (Makhoul permute, spectrum reverse, twiddles). The autotuned
    # dispatch (solvers/autotune.py, dct_variant="auto") measures rather
    # than assumes which wins.
    packed = variant == "packed"
    ilam = _inv_neumann_eigenvalues(m, n, dx, dy)
    if packed:
        rhs_hat = _dct2d_packed(rhs)
        phi = _idct2d_packed(rhs_hat * ilam)
        return phi.astype(rhs.dtype)
    if variant == "rfft2" and m % 2 == 0 and n % 2 == 0:
        # single-2D-FFT Makhoul path: one rfft2 + one irfft2 total
        rhs_hat = _dct2d_rfft2(rhs)
        phi = _idct2d_rfft2(rhs_hat, scale=ilam)
        return phi.astype(rhs.dtype)
    if variant.startswith("rfft_split") and m % 2 == 0 and n % 2 == 0:
        # per-axis Makhoul with the internal rffts computed via
        # HALF-LENGTH complex FFTs (_rfft_half): n-point real transform
        # → n/2-point complex FFT + two spectral passes, for backends
        # whose FFT grows superlinearly in length; the autotuner
        # measures whether the extra passes pay.
        # "rfft_split4"/"rfft_split8" peel further radix-2 levels
        # (_fft_split): internal FFT length n/4, n/8 — the suffix is
        # the total length-division factor.
        factor = int(variant[len("rfft_split"):] or "2")
        depth = max(factor.bit_length() - 1, 1)  # split level: 2→1, 4→2, 8→3
        # Makhoul permute needs even n; the split peels need n/2
        # divisible by 2^(depth−1) → n divisible by 2^(depth+1).
        if min(m, n) % (1 << (depth + 1)):
            raise ValueError(
                f"{variant} needs sizes divisible by {1 << (depth + 1)}")
        rhs_hat = _dct2_fast(_dct2_fast(rhs, 0, split=depth), 1,
                             split=depth)
        ilam_k = ilam[:, : n // 2 + 1]
        ilam_nk = jnp.concatenate(
            [ilam[:, :1], ilam[:, : n // 2 : -1],
             ilam[:, n // 2 : n // 2 + 1]],
            axis=1,
        )
        phi = _idct2_fast(
            _idct2_fast(rhs_hat, 1, scale_k=ilam_k, scale_nk=ilam_nk,
                        split=depth),
            0, split=depth,
        )
        return phi.astype(rhs.dtype)
    rhs_hat = _dct_fwd(_dct_fwd(rhs, axis=0), axis=1)
    if n % 2 == 0:
        # fold 1/λ into the first inverse's spectrum-build pass: the
        # multiplier for the X[n−k] branch is 1/λ at the reversed kx index
        ilam_k = ilam[:, : n // 2 + 1]
        ilam_nk = jnp.concatenate(
            [ilam[:, :1], ilam[:, : n // 2 : -1],
             ilam[:, n // 2 : n // 2 + 1]],
            axis=1,
        )
        phi = _dct_inv(
            _idct2_fast(rhs_hat, axis=1, scale_k=ilam_k, scale_nk=ilam_nk),
            axis=0,
        )
    else:
        phi_hat = rhs_hat * ilam
        phi = _dct_inv(_dct_inv(phi_hat, axis=1), axis=0)
    return phi.astype(rhs.dtype)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def solve_poisson(
    phi0,
    rhs,
    dx: float,
    dy: float,
    cfg: PoissonConfig = PoissonConfig(),
    solid_mask=None,
):
    """Solve ∇²φ = rhs with the configured backend.

    ``phi0`` warm-starts the iterative backends (the reference always cold
    starts from zero, v5.py:330; warm starting is the cheap win).
    """
    if cfg.method == "fft":
        return solve_poisson_periodic_fft(rhs, dx, dy)

    if cfg.method == "dct":
        variant = getattr(cfg, "dct_variant", "rfft")
        if variant == "auto":
            from cfdsim_tpu.solvers.autotune import best_dct_variant

            variant = best_dct_variant(rhs.shape, dx, dy)
        if variant == "matmul":
            from cfdsim_tpu.solvers.autotune import matmul_dct_solver

            m, n = rhs.shape
            return matmul_dct_solver(m, n, dx, dy)(rhs)
        return solve_poisson_neumann_dct(rhs, dx, dy, variant=variant)

    if cfg.method == "hybrid":
        # Fast hybrid pressure-correction (cf. PAPERS.md: "A Fast Hybrid
        # Pressure-Correction Algorithm", arXiv:2304.14690): an exact
        # unmasked DCT solve supplies the global field, then a few masked
        # red-black SOR sweeps repair the solution around embedded solids.
        phi = solve_poisson_neumann_dct(rhs, dx, dy)
        if solid_mask is not None:
            sm = jnp.asarray(solid_mask, bool)
            phi = jnp.where(sm, 0.0, phi)
            red, black = _color_masks(phi.shape, "neumann", sm)
            sweep = partial(
                _sweep, rhs=rhs, dx=dx, dy=dy, colors=(red, black),
                omega=cfg.omega, bc="neumann",
            )
            phi = jax.lax.fori_loop(0, cfg.iters, lambda _, p: sweep(p), phi)
        return phi

    if cfg.method == "mg":
        # Multigrid solves the unmasked Neumann problem. Embedded bodies are
        # handled upstream by IBM velocity penalization (the pressure field
        # inside the body is harmless and velocity there is forced to zero
        # each step); a masked coarse/fine operator pair is inconsistent at
        # the solid boundary and diverges. Use "rbsor" for the reference's
        # masked-Poisson behavior (v5.py:213).
        assert cfg.bc == "neumann", "multigrid supports the neumann convention"
        assert solid_mask is None, "multigrid is unmasked; use rbsor for masks"
        masks_by_level, _ = _mg_masks(phi0.shape, None, cfg)

        def cycle(_, p):
            return _vcycle(
                p, rhs, dx, dy, cfg, masks_by_level, 0, len(masks_by_level)
            )

        return jax.lax.fori_loop(0, cfg.iters, cycle, phi0)

    if cfg.bc == "periodic":
        raise ValueError(
            "bc='periodic' is solved only by method='fft'; the iterative "
            "sweeps implement the neumann/dirichlet conventions"
        )
    sm = None if solid_mask is None else jnp.asarray(solid_mask, bool)
    red, black = _color_masks(phi0.shape, cfg.bc, sm)

    if cfg.method == "jacobi":
        colors = (jnp.logical_or(red, black),)
    else:  # rbsor
        colors = (red, black)

    omega = 1.0 if cfg.method == "jacobi" else cfg.omega
    sweep = partial(
        _sweep, rhs=rhs, dx=dx, dy=dy, colors=colors, omega=omega, bc=cfg.bc
    )
    return _iterate(sweep, phi0, rhs, cfg, dx, dy, sm)
