"""Vectorized FEM assembly: batched einsum contractions over ALL elements.

Where Gridap walks elements applying weak-form lambdas (v2.jl:176-226),
this module evaluates the same bilinear forms as a handful of dense
einsum contractions batched over the whole element set — gather element
DOFs, contract against precomputed basis/gradient tables at quadrature
points (batched small matmuls), scatter with ``segment_sum``.
Static shapes throughout; every operator here is jit/vmap/grad-safe and
is consumed matrix-free by GMRES (no sparse matrix is ever formed).

Weak form implemented (semi-implicit backward Euler, v2.jl:202-215 /
v1.jl:134-150):

    (u - u_prev)·v/dt + ν ∇u:∇v + (ū·∇u)·v − p ∇·v + q ∇·u
        + τ ∇p·∇q   =   0

with ū = u_prev (linearized convection), τ the pressure-gradient
stabilization (v2.jl:170; 0 for Taylor-Hood). Quadrature: 7-point
degree-5 Dunavant rule — exact for every P2-P1 term.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from cfdsim_tpu.fem.spaces import FESpaces


def _dunavant7():
    """Degree-5 7-point rule on the reference triangle; weights sum to
    1/2 (the reference area)."""
    s15 = np.sqrt(15.0)
    b1 = (6.0 + s15) / 21.0
    b2 = (6.0 - s15) / 21.0
    pts = [(1 / 3, 1 / 3)]
    wts = [9.0 / 40.0]
    for b in (b1,):
        w = (155.0 + s15) / 1200.0
        a = 1.0 - 2.0 * b
        pts += [(a, b), (b, a), (b, b)]
        wts += [w, w, w]
    for b in (b2,):
        w = (155.0 - s15) / 1200.0
        a = 1.0 - 2.0 * b
        pts += [(a, b), (b, a), (b, b)]
        wts += [w, w, w]
    pts = np.asarray(pts, dtype=np.float64)  # (7, 2) = (ξ, η)
    wts = 0.5 * np.asarray(wts, dtype=np.float64)
    return pts, wts


def _basis_tables(kind: str, qp: np.ndarray):
    """Shape-function values and reference gradients at quad points.

    Returns (N (nq, nloc), dN (nq, nloc, 2)). Barycentric
    λ = (1-ξ-η, ξ, η); P2 midside ordering m_k opposite vertex k."""
    xi, eta = qp[:, 0], qp[:, 1]
    lam = np.stack([1.0 - xi - eta, xi, eta], axis=1)  # (nq, 3)
    dlam = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])  # (3, 2)
    if kind == "p1":
        N = lam
        dN = np.broadcast_to(dlam, (len(qp), 3, 2)).copy()
        return N, dN
    # P2
    nq = len(qp)
    N = np.zeros((nq, 6))
    dN = np.zeros((nq, 6, 2))
    for i in range(3):
        N[:, i] = lam[:, i] * (2.0 * lam[:, i] - 1.0)
        dN[:, i] = (4.0 * lam[:, i] - 1.0)[:, None] * dlam[i]
    pairs = [(1, 2), (2, 0), (0, 1)]  # m0, m1, m2
    for k, (a, b) in enumerate(pairs):
        N[:, 3 + k] = 4.0 * lam[:, a] * lam[:, b]
        dN[:, 3 + k] = 4.0 * (
            lam[:, a][:, None] * dlam[b] + lam[:, b][:, None] * dlam[a]
        )
    return N, dN


@dataclasses.dataclass(frozen=True, eq=False)
class ElementOps:
    """Device-resident assembly tables (closed over by jitted steps).

    Nu/Np : (nq, nloc) basis values; Gu/Gp : (nt, nq, nloc, 2) physical
    gradients; wq : (nt, nq) quadrature weights ×|J|; xq : (nt, nq, 2)
    quad-point coordinates; h_e : (nt,) element size √(2A) feeding the
    τ stabilization; elem_u/elem_p : DOF maps; dir_mask : (n_u,) bool.
    """

    kind: str
    n_u: int
    n_p: int
    elem_u: jax.Array
    elem_p: jax.Array
    Nu: jax.Array
    Np: jax.Array
    Gu: jax.Array
    Gp: jax.Array
    wq: jax.Array
    xq: jax.Array
    h_e: jax.Array
    dir_mask: jax.Array


def build_element_ops(spaces: FESpaces, dtype=jnp.float32) -> ElementOps:
    """Precompute all per-element geometry/basis tables (runs once)."""
    mesh = spaces.mesh
    qp, qw = _dunavant7()
    Nu, dNu = _basis_tables("p1" if spaces.kind == "p1p1" else "p2", qp)
    Np, dNp = _basis_tables("p1", qp)

    tri_pts = mesh.points[mesh.tris]  # (nt, 3, 2)
    J = np.stack(
        [tri_pts[:, 1] - tri_pts[:, 0], tri_pts[:, 2] - tri_pts[:, 0]],
        axis=2,
    )  # (nt, 2, 2): columns are edge vectors
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    inv = np.empty_like(J)
    inv[:, 0, 0] = J[:, 1, 1]
    inv[:, 0, 1] = -J[:, 0, 1]
    inv[:, 1, 0] = -J[:, 1, 0]
    inv[:, 1, 1] = J[:, 0, 0]
    inv /= detJ[:, None, None]
    # physical gradient: dN_phys[c] = dN_ref[k] * inv[k, c]
    Gu = np.einsum("qlk,ekc->eqlc", dNu, inv)
    Gp = np.einsum("qlk,ekc->eqlc", dNp, inv)
    wq = np.abs(detJ)[:, None] * qw[None, :]
    xq = tri_pts[:, None, 0, :] + np.einsum("qk,eck->eqc", qp, J)
    h_e = np.sqrt(np.abs(detJ))  # √(2A): characteristic element size

    return ElementOps(
        kind=spaces.kind,
        n_u=spaces.n_u,
        n_p=spaces.n_p,
        elem_u=jnp.asarray(spaces.elem_u),
        elem_p=jnp.asarray(spaces.elem_p),
        Nu=jnp.asarray(Nu, dtype=dtype),
        Np=jnp.asarray(Np, dtype=dtype),
        Gu=jnp.asarray(Gu, dtype=dtype),
        Gp=jnp.asarray(Gp, dtype=dtype),
        wq=jnp.asarray(wq, dtype=dtype),
        xq=jnp.asarray(xq, dtype=dtype),
        h_e=jnp.asarray(h_e, dtype=dtype),
        dir_mask=jnp.asarray(spaces.dirichlet_mask),
    )


def apply_ns(ops: ElementOps, u, p, nu, inv_dt, adv_u, tau):
    """y = A(u, p): one application of the coupled NS block operator.

    u : (n_u, 2), p : (n_p,); ``adv_u`` is the frozen advecting field
    (None → Stokes); ``inv_dt`` 0.0 drops the mass term (steady);
    ``tau`` (nt,) is the per-element stabilization (0 → none).
    Returns (yu (n_u, 2), yp (n_p,)).
    """
    ue = u[ops.elem_u]  # (nt, nlu, 2)
    pe = p[ops.elem_p]  # (nt, 3)
    gu = jnp.einsum("eqlc,eld->eqdc", ops.Gu, ue)  # ∇u at quads
    pq = jnp.einsum("ql,el->eq", ops.Np, pe)
    divu = gu[..., 0, 0] + gu[..., 1, 1]

    # momentum: ν ∇u:∇v
    ru = nu * jnp.einsum("eq,eqlc,eqdc->eld", ops.wq, ops.Gu, gu)
    if inv_dt is not None:
        uq = jnp.einsum("ql,eld->eqd", ops.Nu, ue)
        ru = ru + inv_dt * jnp.einsum("eq,ql,eqd->eld", ops.wq, ops.Nu, uq)
    if adv_u is not None:
        aq = jnp.einsum("ql,eld->eqd", ops.Nu, adv_u[ops.elem_u])
        conv = jnp.einsum("eqc,eqdc->eqd", aq, gu)
        ru = ru + jnp.einsum("eq,ql,eqd->eld", ops.wq, ops.Nu, conv)
    # − p ∇·v
    ru = ru - jnp.einsum("eq,eqld,eq->eld", ops.wq, ops.Gu, pq)

    # continuity: q ∇·u (+ τ ∇p·∇q)
    rp = jnp.einsum("eq,ql,eq->el", ops.wq, ops.Np, divu)
    if tau is not None:
        gp = jnp.einsum("eqlc,el->eqc", ops.Gp, pe)
        rp = rp + jnp.einsum(
            "e,eq,eqlc,eqc->el", tau, ops.wq, ops.Gp, gp
        )

    yu = jax.ops.segment_sum(
        ru.reshape(-1, 2), ops.elem_u.reshape(-1), num_segments=ops.n_u
    )
    yp = jax.ops.segment_sum(
        rp.reshape(-1), ops.elem_p.reshape(-1), num_segments=ops.n_p
    )
    return yu, yp


def apply_pspg(
    ops: ElementOps, tau_e, u=None, p=None, inv_dt=None, adv_u=None, fq=None
):
    """Consistent PSPG continuity-row stabilization:
    y_l = Σ_e τ_e ∫ ∇N_l · r, with r the elementwise momentum-residual
    pieces selected by the caller — r = inv_dt·u + (adv_u·∇)u + ∇p + fq
    (each term only when its argument is given; the P1 viscous term
    vanishes elementwise). Unlike the reference's non-consistent
    τ∇p·∇q (v2.jl:170 Brezzi–Pitkäranta form, `apply_ns`'s ``tau``),
    the full-residual form vanishes on the true solution, so it injects
    no near-body pressure diffusion — the τ-stabilization Cd/St bias of
    the monolithic scheme (BENCHNOTES "Refinement read") disappears.

    The θ-scheme operator row passes (u, p, inv_dt, θ·ū); the matching
    rhs row passes (u_prev, inv_dt, −(1−θ)·ū, f_q). Returns (n_p,).
    """
    r = None

    def acc(r, term):
        return term if r is None else r + term

    if u is not None:
        ue = u[ops.elem_u]
        if inv_dt is not None:
            uq = jnp.einsum("ql,eld->eqd", ops.Nu, ue)
            r = acc(r, inv_dt * uq)
        if adv_u is not None:
            gu = jnp.einsum("eqlc,eld->eqdc", ops.Gu, ue)
            aq = jnp.einsum("ql,eld->eqd", ops.Nu, adv_u[ops.elem_u])
            r = acc(r, jnp.einsum("eqc,eqdc->eqd", aq, gu))
    if p is not None:
        gp = jnp.einsum("eqlc,el->eqc", ops.Gp, p[ops.elem_p])
        r = acc(r, gp)
    if fq is not None:
        r = acc(r, fq)
    if r is None:
        return jnp.zeros((ops.n_p,), dtype=ops.wq.dtype)
    rp = jnp.einsum("e,eq,eqlc,eqc->el", tau_e, ops.wq, ops.Gp, r)
    return jax.ops.segment_sum(
        rp.reshape(-1), ops.elem_p.reshape(-1), num_segments=ops.n_p
    )


def apply_mass_u(ops: ElementOps, u):
    """y = M u (velocity mass matrix) — the backward-Euler rhs carrier
    (u_prev·v/dt, v2.jl:208)."""
    ue = u[ops.elem_u]
    uq = jnp.einsum("ql,eld->eqd", ops.Nu, ue)
    ru = jnp.einsum("eq,ql,eqd->eld", ops.wq, ops.Nu, uq)
    return jax.ops.segment_sum(
        ru.reshape(-1, 2), ops.elem_u.reshape(-1), num_segments=ops.n_u
    )


def operator_diag(ops: ElementOps, nu, inv_dt, tau):
    """Diagonal of the (convection-free) block operator, for Jacobi
    preconditioning: momentum diag = Σ w (ν|∇N|² + N²/dt); pressure
    diag is a Schur-complement proxy in the Cahouet-Chabard spirit —
    (1/ν)·mass for the viscous-dominated limit plus dt·|∇N|² for the
    mass-dominated transient limit (S = B(M/dt)⁻¹Bᵀ ≈ dt·L_p; without
    this term the Taylor-Hood transient solve, whose (2,2) block is
    exactly zero, stalls) — plus the τ stabilization block when on."""
    du_e = nu * jnp.einsum("eq,eqlc,eqlc->el", ops.wq, ops.Gu, ops.Gu)
    if inv_dt is not None:
        du_e = du_e + inv_dt * jnp.einsum(
            "eq,ql,ql->el", ops.wq, ops.Nu, ops.Nu
        )
    dp_e = (1.0 / nu) * jnp.einsum("eq,ql,ql->el", ops.wq, ops.Np, ops.Np)
    kp_scale = tau
    if inv_dt is not None:
        dt_bcast = (1.0 / inv_dt) * jnp.ones_like(ops.h_e)
        kp_scale = dt_bcast if tau is None else tau + dt_bcast
    if kp_scale is not None:
        dp_e = dp_e + jnp.einsum(
            "e,eq,eqlc,eqlc->el", kp_scale, ops.wq, ops.Gp, ops.Gp
        )
    du = jax.ops.segment_sum(
        du_e.reshape(-1), ops.elem_u.reshape(-1), num_segments=ops.n_u
    )
    dp = jax.ops.segment_sum(
        dp_e.reshape(-1), ops.elem_p.reshape(-1), num_segments=ops.n_p
    )
    return du, dp


def apply_momentum_block(ops: ElementOps, u, nu, inv_dt):
    """y = (M/dt + νK) u — the symmetric part of the momentum block
    (no convection, no pressure coupling). Used by the block
    preconditioner's inner Jacobi sweeps."""
    ue = u[ops.elem_u]
    gu = jnp.einsum("eqlc,eld->eqdc", ops.Gu, ue)
    ru = nu * jnp.einsum("eq,eqlc,eqdc->eld", ops.wq, ops.Gu, gu)
    if inv_dt is not None:
        uq = jnp.einsum("ql,eld->eqd", ops.Nu, ue)
        ru = ru + inv_dt * jnp.einsum("eq,ql,eqd->eld", ops.wq, ops.Nu, uq)
    return jax.ops.segment_sum(
        ru.reshape(-1, 2), ops.elem_u.reshape(-1), num_segments=ops.n_u
    )


def apply_pressure_schur(ops: ElementOps, q, nu, kp_scale):
    """y = (1/ν)·M_p q + kp_scale·K_p q — the Cahouet-Chabard Schur
    proxy as an operator (kp_scale (nt,) = τ + dt; see operator_diag)."""
    qe = q[ops.elem_p]
    qq = jnp.einsum("ql,el->eq", ops.Np, qe)
    rp = (1.0 / nu) * jnp.einsum("eq,ql,eq->el", ops.wq, ops.Np, qq)
    if kp_scale is not None:
        gq = jnp.einsum("eqlc,el->eqc", ops.Gp, qe)
        rp = rp + jnp.einsum(
            "e,eq,eqlc,eqc->el", kp_scale, ops.wq, ops.Gp, gq
        )
    return jax.ops.segment_sum(
        rp.reshape(-1), ops.elem_p.reshape(-1), num_segments=ops.n_p
    )


def apply_momentum_conv(ops: ElementOps, u, nu, inv_dt, adv_u):
    """y = (M/dt + νK + C(adv_u)) u — the full (nonsymmetric) momentum
    block without pressure coupling. The projection scheme's predictor
    operator; ``adv_u`` None drops convection, ``inv_dt`` None drops
    the mass term."""
    ue = u[ops.elem_u]
    gu = jnp.einsum("eqlc,eld->eqdc", ops.Gu, ue)
    ru = nu * jnp.einsum("eq,eqlc,eqdc->eld", ops.wq, ops.Gu, gu)
    if inv_dt is not None:
        uq = jnp.einsum("ql,eld->eqd", ops.Nu, ue)
        ru = ru + inv_dt * jnp.einsum("eq,ql,eqd->eld", ops.wq, ops.Nu, uq)
    if adv_u is not None:
        aq = jnp.einsum("ql,eld->eqd", ops.Nu, adv_u[ops.elem_u])
        conv = jnp.einsum("eqc,eqdc->eqd", aq, gu)
        ru = ru + jnp.einsum("eq,ql,eqd->eld", ops.wq, ops.Nu, conv)
    return jax.ops.segment_sum(
        ru.reshape(-1, 2), ops.elem_u.reshape(-1), num_segments=ops.n_u
    )


def su_tau(ops: ElementOps, adv_u, nu, inv_dt):
    """Per-element streamline-upwind time scale (Shakib form):
    τ_e = ((2/dt)² + (2|ā|/h)² + (12ν/h²)²)^(-1/2), with ā the
    element-mean advecting speed. Vanishes (≈dt/2) in the resolved
    limit; ~h/(2|ā|) at high cell-Péclet where it is needed."""
    aq = jnp.einsum("ql,eld->eqd", ops.Nu, adv_u[ops.elem_u])
    a_mag = jnp.sqrt(jnp.sum(jnp.mean(aq, axis=1) ** 2, axis=-1) + 1e-30)
    h = ops.h_e
    t1 = (2.0 * inv_dt) ** 2 if inv_dt is not None else 0.0
    t2 = (2.0 * a_mag / h) ** 2
    t3 = (12.0 * nu / (h * h)) ** 2
    return 1.0 / jnp.sqrt(t1 + t2 + t3)


def apply_su(ops: ElementOps, u, adv_u, tau_e):
    """Streamline-upwind stabilization term
    y_l = Σ_e τ_e ∫_e (ā·∇N_l)(ā·∇u) — anisotropic diffusion along
    streamlines only; the standard cure for unstabilized Galerkin
    convection at high cell-Péclet (the P2 momentum block's failure
    mode — BENCHNOTES "Taylor-Hood projection"). Quadratic in the
    advecting field ``adv_u``, so θ-scheme callers must weight it
    explicitly (the C(θū) = θC(ū) linearity trick does NOT apply)."""
    ue = u[ops.elem_u]
    gu = jnp.einsum("eqlc,eld->eqdc", ops.Gu, ue)
    aq = jnp.einsum("ql,eld->eqd", ops.Nu, adv_u[ops.elem_u])
    conv = jnp.einsum("eqc,eqdc->eqd", aq, gu)  # ā·∇u
    wl = jnp.einsum("eqc,eqlc->eql", aq, ops.Gu)  # ā·∇N_l
    ru = jnp.einsum("e,eq,eql,eqd->eld", tau_e, ops.wq, wl, conv)
    return jax.ops.segment_sum(
        ru.reshape(-1, 2), ops.elem_u.reshape(-1), num_segments=ops.n_u
    )


def apply_grad_p(ops: ElementOps, p):
    """y = G p: the momentum-equation pressure term −∫ p ∇·v (exactly
    the coupling block inside apply_ns, exposed standalone so the
    projection scheme can keep pᵃ explicit on the predictor rhs)."""
    pe = p[ops.elem_p]
    pq = jnp.einsum("ql,el->eq", ops.Np, pe)
    ru = -jnp.einsum("eq,eqld,eq->eld", ops.wq, ops.Gu, pq)
    return jax.ops.segment_sum(
        ru.reshape(-1, 2), ops.elem_u.reshape(-1), num_segments=ops.n_u
    )


def apply_div_u(ops: ElementOps, u):
    """y = B u: the weak divergence ∫ q ∇·u (n_p,) — the pressure-
    Poisson rhs carrier of the projection scheme."""
    ue = u[ops.elem_u]
    gu = jnp.einsum("eqlc,eld->eqdc", ops.Gu, ue)
    divu = gu[..., 0, 0] + gu[..., 1, 1]
    rp = jnp.einsum("eq,ql,eq->el", ops.wq, ops.Np, divu)
    return jax.ops.segment_sum(
        rp.reshape(-1), ops.elem_p.reshape(-1), num_segments=ops.n_p
    )


def apply_stiffness_p(ops: ElementOps, q):
    """y = K_p q: the pressure Laplacian ∫ ∇q·∇φ (SPD up to the
    natural-Neumann null space — the projection Poisson operator)."""
    qe = q[ops.elem_p]
    gq = jnp.einsum("eqlc,el->eqc", ops.Gp, qe)
    rp = jnp.einsum("eq,eqlc,eqc->el", ops.wq, ops.Gp, gq)
    return jax.ops.segment_sum(
        rp.reshape(-1), ops.elem_p.reshape(-1), num_segments=ops.n_p
    )


def stiffness_p_diag(ops: ElementOps):
    """diag(K_p) — Jacobi preconditioner for the projection Poisson."""
    dp_e = jnp.einsum("eq,eqlc,eqlc->el", ops.wq, ops.Gp, ops.Gp)
    return jax.ops.segment_sum(
        dp_e.reshape(-1), ops.elem_p.reshape(-1), num_segments=ops.n_p
    )


def lumped_mass_u(ops: ElementOps):
    """HRZ (diagonal-scaling) lumped velocity mass vector (n_u,):
    per element m_l = A_e·∫N_l² / Σ_k ∫N_k², then assembled.

    Row-sum lumping is exact for P1 (and HRZ reduces to it) but yields
    ZERO vertex masses for P2 on triangles (∫λ(2λ−1) = 0), so the HRZ
    scaling — strictly positive and element-mass-preserving for both
    spaces — is used; the projection update u ← u* − dt·m⁻¹Gφ stays
    well posed on Taylor-Hood."""
    me = jnp.einsum("eq,ql,ql->el", ops.wq, ops.Nu, ops.Nu)
    area = jnp.sum(ops.wq, axis=1)
    ml_e = me * (area / jnp.sum(me, axis=1))[:, None]
    return jax.ops.segment_sum(
        ml_e.reshape(-1), ops.elem_u.reshape(-1), num_segments=ops.n_u
    )


def mass_p_diag(ops: ElementOps):
    """Row-sum lumped pressure mass (n_p,) — the rotational-form
    divergence lift D(u*) = M_p⁻¹ B u* uses its inverse."""
    ml_e = jnp.einsum("eq,ql->el", ops.wq, ops.Np)
    return jax.ops.segment_sum(
        ml_e.reshape(-1), ops.elem_p.reshape(-1), num_segments=ops.n_p
    )


def interpolate_u(ops: ElementOps, u):
    """Velocity (and its gradient) at all quadrature points:
    returns uq (nt, nq, 2), gu (nt, nq, 2, 2). Used by error norms,
    diagnostics, and the force evaluation."""
    ue = u[ops.elem_u]
    uq = jnp.einsum("ql,eld->eqd", ops.Nu, ue)
    gu = jnp.einsum("eqlc,eld->eqdc", ops.Gu, ue)
    return uq, gu


def l2_norm(ops: ElementOps, fq):
    """√∫ |f|² over the mesh for a quad-point field fq (nt, nq, ...)."""
    sq = jnp.sum(fq * fq, axis=tuple(range(2, fq.ndim)))
    return jnp.sqrt(jnp.sum(ops.wq * sq))
