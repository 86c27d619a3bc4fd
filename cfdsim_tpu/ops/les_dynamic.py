"""Dynamic Smagorinsky (Germano–Lilly) subgrid model, 3D.

Upgrade over the reference's static-coefficient Smagorinsky
(v5.py:96-110): the model coefficient ``c = (C_s Δ)²`` is computed
from the resolved field itself via the Germano identity instead of
being prescribed.  A test filter Ĝ at width 2Δ is applied to the
resolved velocity; the resolved stress between the two filter levels

    L_ij = (ū_i ū_j)^ − û_i û_j                (Leonard tensor)

must be carried by the modelled stress difference

    M_ij = 2 Δ² [ (|S̄| S̄_ij)^ − α² |Ŝ| Ŝ_ij ],   α = Δ̂/Δ = 2,

and Lilly's least-squares solution with volume averaging gives

    c = ⟨L_ij M_ij⟩ / ⟨M_ij M_ij⟩,   clipped to [0, c_max],

one scalar per evaluation (Lilly 1992; the pointwise quotient is
famously ill-conditioned — ⟨M M⟩ → 0 patches produce clipped noise
that biases a "local" c high even on fully resolved fields, which we
measured here: local filter-averaged c gave C_s ≈ 0.5 on a resolved
TGV mode where the volume average gives 1e-8.  Lagrangian averaging
(Meneveau et al. 1996) is the established local upgrade if a future
case needs spatial variation).

In smooth, well-resolved flow ⟨L_ij M_ij⟩ → 0 so c → 0 — the dynamic
model self-switches off where the static model over-damps (laminar
regions, transition), which is exactly the failure mode of
prescribed-C_s LES.  α² uses the test filter's actual second moment:
the trapezoid [1/4,1/2,1/4] filter has variance h²/2, i.e. an
equivalent box width of √6·h, so α² = 6 (Lund 1997).

Accelerator notes: everything here is elementwise + separable 3-point
convolutions (trapezoidal 2Δ box filter), so XLA fuses the whole
coefficient computation into a handful of HBM passes; there are no
gathers and no data-dependent shapes. The integrand at a cell reads
center velocities within ±2 cells (one filter + one gradient each
way), so the sharded 3D MAC tier evaluates ``lilly_integrand_3d`` on
±2-center halo windows and psum-reduces the volume average
(parallel/mac3d_explicit.py).

All tensors live at cell centers on the (nz, ny, nx) layout; gradients
use central differences of edge-clamped padded fields (one-sided at
walls, consistent with the staggered strain used for ν_t transport in
``models.mac3d.strain_magnitude_mac3d``).
"""

from __future__ import annotations

import jax.numpy as jnp


def box_filter_3d(f):
    """Separable trapezoidal test filter at width 2Δ: weights
    [1/4, 1/2, 1/4] per axis (Simpson box), edge-clamped at walls so
    the filter is a convex average everywhere (preserves constants)."""
    g = jnp.pad(f, 1, mode="edge")
    g = 0.25 * g[:-2] + 0.5 * g[1:-1] + 0.25 * g[2:]
    g = 0.25 * g[:, :-2] + 0.5 * g[:, 1:-1] + 0.25 * g[:, 2:]
    g = 0.25 * g[:, :, :-2] + 0.5 * g[:, :, 1:-1] + 0.25 * g[:, :, 2:]
    return g


def _center_gradients(uc, vc, wc, inv_g2x, inv_g2y, inv_g2z):
    """∂u_i/∂x_j at centers from edge-clamped central differences.
    ``inv_g2*`` are 1/(two-center gaps): scalars 0.5/h on uniform
    grids, or broadcastable per-axis vectors built from the (edge-
    clamp-padded) center coordinates on stretched grids."""
    def grad(f):
        g = jnp.pad(f, 1, mode="edge")
        fx = (g[1:-1, 1:-1, 2:] - g[1:-1, 1:-1, :-2]) * inv_g2x
        fy = (g[1:-1, 2:, 1:-1] - g[1:-1, :-2, 1:-1]) * inv_g2y
        fz = (g[2:, 1:-1, 1:-1] - g[:-2, 1:-1, 1:-1]) * inv_g2z
        return fx, fy, fz

    ux, uy, uz = grad(uc)
    vx, vy, vz = grad(vc)
    wx, wy, wz = grad(wc)
    return (ux, uy, uz), (vx, vy, vz), (wx, wy, wz)


def _strain(uc, vc, wc, inv_g2x, inv_g2y, inv_g2z):
    """(S_11, S_22, S_33, S_12, S_13, S_23, |S|) at cell centers."""
    (ux, uy, uz), (vx, vy, vz), (wx, wy, wz) = _center_gradients(
        uc, vc, wc, inv_g2x, inv_g2y, inv_g2z
    )
    s11, s22, s33 = ux, vy, wz
    s12 = 0.5 * (uy + vx)
    s13 = 0.5 * (uz + wx)
    s23 = 0.5 * (vz + wy)
    mag = jnp.sqrt(
        2.0 * (s11 * s11 + s22 * s22 + s33 * s33)
        + 4.0 * (s12 * s12 + s13 * s13 + s23 * s23)
    )
    return (s11, s22, s33, s12, s13, s23), mag


def dynamic_coefficient_3d(
    uc,
    vc,
    wc,
    dx: float,
    dy: float,
    dz: float,
    c_max_cs: float = 0.3,
    alpha_sq: float = 6.0,
    boundary_skip: int = 3,
    eps: float = 1e-20,
):
    """Germano–Lilly dynamic coefficient c = (C_s Δ)² (volume-averaged
    Lilly quotient, one scalar) from center velocities (uc, vc, wc).

    Returns a scalar with units of length² (multiply by a strain
    magnitude to get ν_t).  Negative values (net backscatter) clip to
    0 — the standard Lilly clip; the upper clip at (c_max_cs·Δ)²
    bounds the viscous dt restriction.  ``alpha_sq`` is the
    test-to-grid filter-width ratio squared (6 for the trapezoid
    filter's true second moment; 4 for the nominal 2Δ box).
    """
    delta = (dx * dy * dz) ** (1.0 / 3.0)
    delta_sq = delta * delta
    cs2 = dynamic_cs2_3d(
        uc, vc, wc, 0.5 / dx, 0.5 / dy, 0.5 / dz, delta_sq,
        c_max_cs=c_max_cs, alpha_sq=alpha_sq,
        boundary_skip=boundary_skip, eps=eps,
    )
    return cs2 * delta_sq


def dynamic_cs2_3d(
    uc,
    vc,
    wc,
    inv_g2x,
    inv_g2y,
    inv_g2z,
    delta_sq,
    mask=None,
    c_max_cs: float = 0.3,
    alpha_sq: float = 6.0,
    boundary_skip: int = 3,
    eps: float = 1e-20,
):
    """Dimensionless Germano–Lilly C_s² (volume-averaged Lilly
    quotient, one scalar) — the grid-general core behind
    ``dynamic_coefficient_3d``.

    ``inv_g2*``: 1/(two-center gaps) for the center gradients — 0.5/h
    scalars on uniform grids, broadcastable per-axis vectors on
    stretched grids. ``delta_sq``: the local filter width squared
    Δ² = (hx·hy·hz)^{2/3} (scalar or cell-center field); it rides
    inside both M terms so the stretched-grid ν_t = C_s²·Δ²(x)·|S| is
    consistent with the identity. ``mask``: optional fluid indicator
    (0 = solid/IBM body) excluding masked cells from the contraction.
    The test filter acts in index space — exact on uniform grids,
    second-order on smoothly stretched ones.
    """
    lm, mm = lilly_integrand_3d(
        uc, vc, wc, inv_g2x, inv_g2y, inv_g2z, delta_sq,
        alpha_sq=alpha_sq,
    )

    if mask is not None:
        # mask stays BOOL end-to-end (an f32 mask const-folds a second
        # full-size copy into the compiled program)
        lm = jnp.where(mask, lm, 0.0)
        mm = jnp.where(mask, mm, 0.0)

    # exclude the wall frame from the contraction: the edge-clamped
    # padding makes the test filter and gradients one-sided there, and
    # the resulting spurious Leonard stress is pure discretization (it
    # dominated a free-slip TGV box at 24³ — measured 2.8× the static
    # model's dissipation before this mask)
    k = boundary_skip
    if k > 0:
        if any(d <= 2 * k for d in lm.shape):
            raise ValueError(
                f"grid {lm.shape} too small for the dynamic model's "
                f"boundary_skip={k} (needs > {2 * k} cells per axis); "
                "the contraction would be empty and c silently 0"
            )
        lm = lm[k:-k, k:-k, k:-k]
        mm = mm[k:-k, k:-k, k:-k]

    c = jnp.sum(lm) / (jnp.sum(mm) + eps)
    return jnp.clip(c, 0.0, c_max_cs**2)


def lilly_integrand_3d(
    uc,
    vc,
    wc,
    inv_g2x,
    inv_g2y,
    inv_g2z,
    delta_sq,
    alpha_sq: float = 6.0,
):
    """Pointwise Lilly contraction fields (L_ij M_ij, M_ij M_ij) at
    cell centers — the grid-shape-agnostic core of ``dynamic_cs2_3d``,
    exposed so the sharded tiers can evaluate it on halo windows and
    reduce with ``psum`` (the value at a cell depends on center
    velocities within ±2 cells only: one test filter + one gradient
    each way — so a width-2 center halo reproduces the single-device
    integrand exactly at owned cells)."""
    s, s_mag = _strain(uc, vc, wc, inv_g2x, inv_g2y, inv_g2z)

    # test-filtered velocities and their strain
    uf, vf, wf = box_filter_3d(uc), box_filter_3d(vc), box_filter_3d(wc)
    sf, sf_mag = _strain(uf, vf, wf, inv_g2x, inv_g2y, inv_g2z)

    # L_ij = (u_i u_j)^ − û_i û_j ;  M_ij = 2[(Δ²|S|S_ij)^ − α²Δ²|Ŝ|Ŝ_ij]
    # Pair the 6 independent components with weights (1,1,1,2,2,2) in
    # the contractions. The trace part of L is annihilated against the
    # traceless M for divergence-free fields; discretely we subtract it
    # explicitly (deviatoric L) so it cannot pollute the quotient.
    vel = (uc, vc, wc)
    velf = (uf, vf, wf)
    pairs = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
    weights = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0)

    l_comp = [
        box_filter_3d(vel[i] * vel[j]) - velf[i] * velf[j]
        for (i, j) in pairs
    ]
    tr_l = (l_comp[0] + l_comp[1] + l_comp[2]) / 3.0
    for k in range(3):
        l_comp[k] = l_comp[k] - tr_l

    m_comp = [
        2.0
        * (box_filter_3d(delta_sq * s_mag * s[k])
           - alpha_sq * delta_sq * sf_mag * sf[k])
        for k in range(6)
    ]

    lm = sum(wgt * l_ * m_ for wgt, l_, m_ in zip(weights, l_comp, m_comp))
    mm = sum(wgt * m_ * m_ for wgt, m_ in zip(weights, m_comp))
    return lm, mm


def ibm_fluid_mask_centers(ibm_mask_u=None, ibm_mask_v=None,
                           ibm_mask_w=None, ibm_ghost=None):
    """BOOL cell-center fluid indicator (True = fluid) from either the
    face-sampled penalization masks or a GhostIBM3D — the shared mask
    construction for the dynamic-LES contraction on both 3D tiers.
    Returns None when no static body is present (then the contraction
    runs unmasked). Kept boolean so the closed-over constant is
    1 byte/cell."""
    if ibm_mask_u is not None:
        solid = jnp.maximum(
            jnp.maximum(
                jnp.maximum(ibm_mask_u[:, :, 1:], ibm_mask_u[:, :, :-1]),
                jnp.maximum(ibm_mask_v[:, 1:, :], ibm_mask_v[:, :-1, :]),
            ),
            jnp.maximum(ibm_mask_w[1:], ibm_mask_w[:-1]),
        )
        return solid < 0.5
    if ibm_ghost is not None:
        solid_c = (
            (ibm_ghost.u.solid[:, :, 1:] | ibm_ghost.u.solid[:, :, :-1])
            | (ibm_ghost.v.solid[:, 1:, :] | ibm_ghost.v.solid[:, :-1, :])
            | (ibm_ghost.w.solid[1:] | ibm_ghost.w.solid[:-1])
        )
        return ~solid_c
    return None
