"""Shell-averaged kinetic-energy spectra E(k) for box flows.

The standard quantitative diagnostic for the LES tiers (TGV transition,
Kolmogorov turbulence): bin |û|²/2 into integer-|k| shells so the
inertial range and the subgrid model's dissipation at the grid cutoff
are visible against k^(-5/3).

The reference's spectral family (plot.jl) evolves in Fourier space but
never reports spectra; this utility closes that diagnostic gap for all
tiers (any cell-centered velocity field works).

Accelerator notes: one rfftn + elementwise binning via a precomputed shell-id
matrix and a segment-sum — everything static-shaped; jit-safe. The
free-slip TGV box is handled by even mirror extension (the [0,π]³
symmetry-reduced box extends to the full 2π-periodic TGV, so a
periodic FFT is exact for it).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _mirror(f, parities):
    """Symmetry extension along the three axes, [0,L] → [0,2L)
    periodic: parity +1 = even (tangential velocity at a free-slip
    wall), −1 = odd (wall-normal velocity — it vanishes at the wall
    and flips sign across it). For the symmetry-reduced TGV box this
    reconstructs the full-period field exactly."""
    for ax, s in enumerate(parities):
        r = jnp.flip(f, axis=ax)
        f = jnp.concatenate([f, s * r], axis=ax)
    return f


def energy_spectrum_3d(uc, vc, wc, mirror: bool = False):
    """Shell-averaged 3D energy spectrum from cell-centered velocities.

    Returns (k, E) as numpy arrays with k = 0, 1, 2, … in units of the
    box fundamental (2π/L of the periodic box actually transformed);
    Σ E(k) equals the volume-mean kinetic energy ⟨|u|²⟩/2 (Parseval,
    tested).  Set ``mirror=True`` for fields on a symmetry-reduced
    free-slip box (e.g. the [0,π]³ TGV octant) — each component is
    extended with its free-slip parity (odd across the wall it is
    normal to, even otherwise) to make the field periodic before the
    FFT.

    Assumes an isotropic box: shells bin per-axis integer mode indices
    (fftfreq·n), so all axes must share the same physical box length
    per mode (cubic domain, or equal L/n aspect) for |k| shells to
    collect equal physical wavenumbers.  For anisotropic boxes scale
    each axis by 2π/L_axis before binning (not needed by any current
    caller — TGV box and the square Kolmogorov domain are isotropic).
    """
    if mirror:
        # axes are (z, y, x): u normal to x-walls, v to y, w to z
        uc = _mirror(uc, (+1, +1, -1))
        vc = _mirror(vc, (+1, -1, +1))
        wc = _mirror(wc, (-1, +1, +1))
    nz, ny, nx = uc.shape

    def ps(f):
        fh = jnp.fft.rfftn(f) / (nx * ny * nz)
        p = jnp.abs(fh) ** 2
        # undo rfft's folded conjugate half: every kx plane except the
        # kx=0 (and Nyquist for even nx) appears once but represents two
        w = jnp.ones(p.shape[2]).at[1:].set(2.0)
        if nx % 2 == 0:
            w = w.at[-1].set(1.0)
        return p * w[None, None, :]

    e_density = 0.5 * (ps(uc) + ps(vc) + ps(wc))

    kz = np.fft.fftfreq(nz) * nz
    ky = np.fft.fftfreq(ny) * ny
    kx = np.arange(nx // 2 + 1)
    kmag = np.sqrt(
        kz[:, None, None] ** 2 + ky[None, :, None] ** 2
        + kx[None, None, :] ** 2
    )
    shell = jnp.asarray(np.rint(kmag).astype(np.int32))
    n_shells = int(np.rint(kmag).max()) + 1
    e_k = jnp.zeros(n_shells).at[shell].add(e_density)
    return np.arange(n_shells), np.asarray(e_k)


def energy_spectrum_2d(u, v):
    """Ring-averaged 2D energy spectrum from a periodic velocity field
    (ny, nx) — the diagnostic for the Kolmogorov/spectral tier
    (models/spectral.py evolves plot.jl's flow but the reference never
    reports spectra).  Σ E(k) = ⟨|u|²⟩/2 (Parseval).  Same isotropic-
    box assumption as :func:`energy_spectrum_3d` (square domain)."""
    ny, nx = u.shape

    def ps(f):
        fh = jnp.fft.rfft2(f) / (nx * ny)
        p = jnp.abs(fh) ** 2
        w = jnp.ones(p.shape[1]).at[1:].set(2.0)
        if nx % 2 == 0:
            w = w.at[-1].set(1.0)
        return p * w[None, :]

    e_density = 0.5 * (ps(u) + ps(v))
    ky = np.fft.fftfreq(ny) * ny
    kx = np.arange(nx // 2 + 1)
    kmag = np.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)
    shell = jnp.asarray(np.rint(kmag).astype(np.int32))
    n_shells = int(np.rint(kmag).max()) + 1
    e_k = jnp.zeros(n_shells).at[shell].add(e_density)
    return np.arange(n_shells), np.asarray(e_k)
