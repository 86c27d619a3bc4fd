"""Unstructured FEM incompressible NS — the reference's Julia/Gridap
family (julia/flow_over_cylinder_fischer/) as a jitted matrix-free
GMRES solver.

Scheme (reference parity): semi-implicit backward Euler with linearized
convection — one coupled linear solve per step (v2.jl:202-226 "fast NS",
v1.jl:130-167), initialized from a steady Stokes solve (v1.jl:170-200,
v2.jl:176-199). Spaces: P1-P1 + τ∇p·∇q stabilization (v2.jl:137-173) or
Taylor-Hood P2-P1 (v1.jl:103-127). Failure handling mirrors
v2.jl:223-225: a step whose linear solve comes back non-finite or
unconverged keeps the previous solution.

Differences from the reference: no per-element loops and no
sparse-matrix factorization — the operator is applied as batched einsum
contractions (fem/assembly.py) inside jax's pytree GMRES, with a Jacobi
(block-diagonal) preconditioner; the whole step is one jitted function
``step(state, cfl_scale) -> (state, metrics)`` matching every other
solver tier. Hydrodynamic forces come from the consistent reaction
(boundary-flux) method rather than pointwise stress sampling.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cfdsim_tpu.fem.assembly import (
    ElementOps,
    apply_div_u,
    apply_grad_p,
    apply_mass_u,
    apply_momentum_conv,
    apply_ns,
    apply_pspg,
    apply_stiffness_p,
    apply_su,
    interpolate_u,
    l2_norm,
    lumped_mass_u,
    mass_p_diag,
    operator_diag,
    stiffness_p_diag,
    su_tau,
)
from cfdsim_tpu.models.incompressible import StepMetrics


class FEMState(NamedTuple):
    """u: (n_u, 2) nodal velocity; p: (n_p,) nodal pressure.

    ``phi`` ((n_p,), projection scheme only, else None): previous
    pressure increment — warm-starts the next step's CG solve (the
    increment oscillates smoothly over a shedding cycle, so the
    previous one is an excellent initial guess)."""

    u: jax.Array
    p: jax.Array
    t: jax.Array
    step: jax.Array
    phi: Optional[jax.Array] = None


@dataclasses.dataclass(frozen=True)
class FEMConfig:
    """Static solver configuration (closed over by jit).

    ``tau_h``: None → per-element τ = h_e²/(4ν+2V∞h_e) (the reference
    formula v2.jl:170 with the local element size instead of the global
    H_NEAR constant; set ``tau_h`` to a float for exact parity).
    Taylor-Hood ("p2p1") runs unstabilized unless ``force_tau``.
    """

    nu: float = 0.01
    dt: float = 0.05
    space: str = "p1p1"
    v_inf: float = 1.0
    tau_h: Optional[float] = None
    force_tau: bool = False
    # pressure stabilization form (monolithic P1-P1): "bp" = the
    # reference's non-consistent τ∇p·∇q (v2.jl:170, Brezzi-Pitkäranta)
    # — keeps exact parity but biases Cd +2.6-3% and damps the wake
    # (St 0.25 plateau, BENCHNOTES "Refinement read"); "pspg" = the
    # consistent residual form τ∫∇q·(u/dt + θ(ū·∇)u + ∇p − rhs), which
    # vanishes on the resolved solution and removes that bias. Same τ,
    # same preconditioner. Ignored for Taylor-Hood (no stabilization)
    # and for the projection scheme (stable without either).
    stab: str = "bp"
    # time discretization: 1.0 = backward Euler (reference parity,
    # v2.jl:208), 0.5 = Crank-Nicolson on the viscous+convective terms
    # (pressure/continuity stay fully implicit) — halves the numerical
    # damping of vortex shedding at the same dt
    theta: float = 1.0
    gmres_tol: float = 1e-5
    gmres_restart: int = 40
    gmres_maxiter: int = 8  # outer restarts (warm-started transient
    # solves need ~100-300 matvecs at 1e-5; the cold Stokes init instead
    # wants restart≈200 — see cases.cylinder_fem)
    accept_relres: float = 1e-2  # keep-previous threshold (v2.jl:223-225)
    # block preconditioner: pc_sweeps damped-Jacobi inner iterations on
    # the (M/dt + θνK) momentum block and the Cahouet-Chabard Schur
    # operator (1/ν)M_p + (τ+dt)K_p. Default 0 = diagonal scaling with
    # the Cahouet-Chabard dt·K_p Schur term in the diag (operator_diag)
    # — measured as the best cost/benefit at every size tried; inner
    # sweeps doubled step cost without moving the convergence plateau.
    pc_sweeps: int = 0
    # damping 0.4: damped Jacobi is stable iff ω·λmax(D⁻¹A) < 2, and on
    # unstructured meshes with obtuse triangles the stiffness rows can
    # push λmax(D⁻¹A) past 2/0.7 — ω=0.7 diverged (NaN solves) on some
    # mesh realizations; 0.4 covers λmax ≤ 5
    pc_omega: float = 0.4
    # "incremental" (modified Gram-Schmidt) is the robust default: the
    # "batched" classical-Gram-Schmidt path has no fp32 breakdown guard
    # and produced preconditioner-sensitive NaN solves on some meshes;
    # "batched" suits a mesh known to be good where its parallel
    # orthogonalization pays
    gmres_method: str = "incremental"
    # projection-scheme (make_projection_step) knobs: CG budget for the
    # SPD pressure-increment Poisson, and the rotational form switch
    # (p += φ − χ·ν·div u*, Timmermans et al. — consistent pressure BCs,
    # sharper boundary layers; χ=0 is the standard incremental scheme)
    pp_tol: float = 1e-6
    pp_maxiter: int = 400
    rotational: float = 0.0
    # pressure-Poisson preconditioner: "2level" (additive aggregation
    # two-level, fem/multilevel.py — measured 308 → 18 CG iterations at
    # 10.7k tris), "2level_v" (symmetric V(1,1), fewest iterations but
    # 2 extra matvecs per apply), or "jacobi" (plain diagonal)
    pp_pc: str = "2level"
    pp_max_coarse: int = 4096
    # streamline-upwind momentum stabilization scale (projection path):
    # 0 = off (P1-P1 production default — never needed there), 1.0 =
    # standard Shakib τ. Required for Taylor-Hood transients at cell-
    # Péclet ≳ 10, where unstabilized P2 Galerkin convection blows up
    # with fully converged solves (BENCHNOTES)
    supg: float = 0.0


def _tau(ops: ElementOps, cfg: FEMConfig):
    if cfg.space == "p2p1" and not cfg.force_tau:
        return None
    h = ops.h_e if cfg.tau_h is None else jnp.full_like(ops.h_e, cfg.tau_h)
    return h * h / (4.0 * cfg.nu + 2.0 * cfg.v_inf * h)


def _masked_operator(ops, cfg, inv_dt, adv_u, tau):
    """A with identity rows at Dirichlet velocity DOFs (matrix-free
    row replacement; columns stay, which GMRES tolerates)."""
    dm = ops.dir_mask[:, None]

    def A(x):
        u, p = x
        yu, yp = apply_ns(ops, u, p, cfg.nu, inv_dt, adv_u, tau)
        return (jnp.where(dm, u, yu), yp)

    return A


def _kp_scale(ops, inv_dt, tau):
    """K_p weight of the Schur proxy: τ (stabilization) + dt (transient
    Schur term S = B(M/dt)⁻¹Bᵀ ≈ dt·L_p)."""
    if inv_dt is None:
        return tau
    dtv = (1.0 / inv_dt) * jnp.ones_like(ops.h_e)
    return dtv if tau is None else tau + dtv


def build_schur_coarse(ops, cfg, steady: bool = False):
    """Two-level hierarchy for the monolithic block preconditioner's
    Cahouet-Chabard Schur proxy (1/ν_eff)M_p + (τ+dt)K_p (fem/
    multilevel.py; built once per step function with the nominal dt —
    preconditioners tolerate the cfl_scale mismatch). The coarse
    correction is what breaks the one-level pc's ~1e-4 saddle plateau
    at ≳10k triangles (BENCHNOTES "Solver-scaling boundary").

    Steady solves return None: their Schur proxy is mass-dominated
    ((1/ν)M_p with at most a small τK_p term), which Jacobi already
    handles in a few iterations — and the coarse term's scale shift
    measurably degrades the fp32 Stokes init on Taylor-Hood (the
    correction belongs to the transient dt·K_p physics only)."""
    if cfg.pp_pc == "jacobi" or steady:
        return None
    from cfdsim_tpu.fem.multilevel import build_coarse, schur_proxy_elements

    inv_dt = 1.0 / cfg.dt
    tau = _tau(ops, cfg)
    nu_eff = cfg.nu * float(cfg.theta)
    kp = _kp_scale(ops, inv_dt, tau)
    kp_np = np.asarray(kp)
    return build_coarse(
        np.asarray(ops.elem_p),
        schur_proxy_elements(ops, nu_eff, kp_np),
        ops.n_p,
        excluded_nodes=(),
        max_coarse=cfg.pp_max_coarse,
        dtype=ops.wq.dtype,
    )


def _preconditioner(ops, cfg, inv_dt, tau, level=None):
    """Block preconditioner: ``pc_sweeps`` damped-Jacobi iterations on
    the symmetric momentum block and on the Cahouet-Chabard Schur
    operator (pc_sweeps=0 → plain diagonal scaling); ``level`` adds the
    additive two-level coarse correction (build_schur_coarse) to the
    pressure block."""
    from cfdsim_tpu.fem.assembly import (
        apply_momentum_block,
        apply_pressure_schur,
    )
    from cfdsim_tpu.fem.multilevel import coarse_correct

    nu_eff = cfg.nu * (float(cfg.theta) if inv_dt is not None else 1.0)
    du, dp = operator_diag(ops, nu_eff, inv_dt, tau)
    du = jnp.where(ops.dir_mask, 1.0, du)
    inv_du = (1.0 / du)[:, None]
    inv_dp = 1.0 / dp
    k = int(cfg.pc_sweeps)

    def zp_base(p):
        zp = inv_dp * p
        if level is not None:
            zp = zp + coarse_correct(level, p)
        return zp

    if k <= 0:

        def M(x):
            u, p = x
            return (u * inv_du, zp_base(p))

        return M

    om = cfg.pc_omega
    dm = ops.dir_mask[:, None]
    kp = _kp_scale(ops, inv_dt, tau)

    def Au(z):
        y = apply_momentum_block(ops, z, nu_eff, inv_dt)
        return jnp.where(dm, z, y)

    def M(x):
        u, p = x
        zu = inv_du * u
        for _ in range(k):
            zu = zu + om * inv_du * (u - Au(zu))
        zp = zp_base(p)
        for _ in range(k):
            zp = zp + om * inv_dp * (
                p - apply_pressure_schur(ops, zp, nu_eff, kp)
            )
        return (zu, zp)

    return M


def _gmres_raw(A, b, x0, M, cfg):
    x, _ = jax.scipy.sparse.linalg.gmres(
        A,
        b,
        x0=x0,
        M=M,
        tol=cfg.gmres_tol,
        atol=0.0,
        restart=cfg.gmres_restart,
        maxiter=cfg.gmres_maxiter,
        solve_method=cfg.gmres_method,
    )
    return x


def _gmres(A, b, x0, M, cfg):
    return _gmres_raw(A, b, x0, M, cfg)


def _make_implicit_solver(ops, cfg, g, bf, fq=None):
    """The per-step linear solve as an exactly-differentiable primitive.

    jax 0.9's ``custom_linear_solve`` transpose rule cannot handle an
    operator whose closure is itself differentiated (internal
    undefined-primal assertion), so the implicit adjoint is spelled out
    with ``custom_vjp``: forward = preconditioned GMRES on
    A(u_prev) x = b(u_prev); backward solves Aᵀ λ = x̄ (GMRES on the
    ``jax.linear_transpose`` of the operator) and pulls parameter
    gradients through the residual r(θ) = b(θ) − A(θ)·x at fixed x —
    the textbook adjoint of the semi-implicit step, including the
    convection-coefficient sensitivity."""
    tau = _tau(ops, cfg)
    pspg = cfg.stab == "pspg" and tau is not None
    tau_ns = None if pspg else tau
    dm = ops.dir_mask[:, None]
    th = float(cfg.theta)
    level = build_schur_coarse(ops, cfg)

    def opA(u_prev, inv_dt, x):
        # θ-weighting uses linearity: θ(νK + C(ū))u = (θν)Ku + C(θū)u,
        # so the θ-scheme reuses the plain assembly with scaled inputs
        u, p = x
        yu, yp = apply_ns(
            ops, u, p, th * cfg.nu, inv_dt, th * u_prev, tau_ns
        )
        if pspg:
            # consistent stabilization, operator part: the unknowns'
            # share of the θ-scheme momentum residual (see apply_pspg)
            yp = yp + apply_pspg(
                ops, tau, u=u, p=p, inv_dt=inv_dt, adv_u=th * u_prev
            )
        return (jnp.where(dm, u, yu), yp)

    def rhs(u_prev, p_prev, inv_dt):
        rhs_u = inv_dt * apply_mass_u(ops, u_prev)
        if th != 1.0:
            # explicit part: −(1−θ)(νK + C(ū))·u_prev (p=0 drops the
            # pressure coupling; the continuity output is discarded)
            yu_e, _ = apply_ns(
                ops, u_prev, jnp.zeros((ops.n_p,), dtype=u_prev.dtype),
                (1.0 - th) * cfg.nu, None, (1.0 - th) * u_prev, None,
            )
            rhs_u = rhs_u - yu_e
        if bf is not None:
            rhs_u = rhs_u + bf
        bu = jnp.where(dm, g, rhs_u)
        bp = 0.0 * p_prev
        if pspg:
            # matching rhs share of the momentum residual:
            # τ∫∇q·(u_prev/dt − (1−θ)(ū·∇)u_prev + f)
            bp = bp + apply_pspg(
                ops, tau, u=u_prev, inv_dt=inv_dt,
                adv_u=None if th == 1.0 else -(1.0 - th) * u_prev,
                fq=fq,
            )
        return (bu, bp), rhs_u

    @jax.custom_vjp
    def solve(u_prev, p_prev, inv_dt):
        b, _ = rhs(u_prev, p_prev, inv_dt)
        A = lambda x: opA(u_prev, inv_dt, x)
        M = _preconditioner(ops, cfg, inv_dt, tau, level)
        return _gmres_raw(A, b, (u_prev, p_prev), M, cfg)

    def fwd(u_prev, p_prev, inv_dt):
        x = solve(u_prev, p_prev, inv_dt)
        return x, (u_prev, p_prev, inv_dt, x)

    def bwd(res, xbar):
        u_prev, p_prev, inv_dt, x = res
        A = lambda y: opA(u_prev, inv_dt, y)
        At = jax.linear_transpose(A, x)
        M = _preconditioner(ops, cfg, inv_dt, tau, level)
        zero = jax.tree.map(jnp.zeros_like, x)
        lam = _gmres_raw(lambda v: At(v)[0], xbar, zero, M, cfg)

        def residual(u_prev_, p_prev_, inv_dt_):
            b, _ = rhs(u_prev_, p_prev_, inv_dt_)
            ax = opA(u_prev_, inv_dt_, x)  # x held fixed
            return jax.tree.map(jnp.subtract, b, ax)

        _, vjp = jax.vjp(residual, u_prev, p_prev, inv_dt)
        return vjp(lam)

    def unmasked_momentum(u_prev, inv_dt, x):
        """θ-weighted momentum rows without the Dirichlet replacement
        (for the reaction-force readout)."""
        u, p = x
        yu, _ = apply_ns(ops, u, p, th * cfg.nu, inv_dt, th * u_prev, tau)
        return yu

    solve.defvjp(fwd, bwd)
    return solve, rhs, opA, unmasked_momentum


def _relres(A, x, b):
    r = jax.tree.map(jnp.subtract, A(x), b)
    num = jnp.sqrt(sum(jnp.vdot(l, l).real for l in jax.tree.leaves(r)))
    den = jnp.sqrt(sum(jnp.vdot(l, l).real for l in jax.tree.leaves(b)))
    return num / jnp.maximum(den, 1e-30)


def solve_stokes(
    ops: ElementOps,
    cfg: FEMConfig,
    g,
    body_force: Optional[Callable] = None,
) -> FEMState:
    """Steady Stokes initialization (v1.jl:170-200, v2.jl:176-199):
    ν∇u:∇v − p∇·v + q∇·u (+ τ∇p·∇q) = (f, v), Dirichlet lift g.

    ``stab="pspg"``: at steady Stokes the consistent residual form is
    the same operator (no mass/convection terms survive, P1 viscous
    vanishes elementwise) plus the τ∫∇q·f continuity rhs."""
    g = jnp.asarray(g, dtype=ops.Nu.dtype)
    tau = _tau(ops, cfg)
    A = _masked_operator(ops, cfg, None, None, tau)
    bu = jnp.zeros((ops.n_u, 2), dtype=ops.Nu.dtype)
    bp = jnp.zeros((ops.n_p,), dtype=ops.Nu.dtype)
    if body_force is not None:
        bu = bu + _body_force_rhs(ops, body_force)
        if cfg.stab == "pspg" and tau is not None:
            bp = bp + apply_pspg(
                ops, tau, fq=_body_force_quad(ops, body_force)
            )
    bu = jnp.where(ops.dir_mask[:, None], g, bu)
    b = (bu, bp)
    x0 = (g, jnp.zeros((ops.n_p,), dtype=ops.Nu.dtype))
    M = _preconditioner(
        ops, cfg, None, tau, build_schur_coarse(ops, cfg, steady=True)
    )
    with jax.default_matmul_precision("float32"):  # see step wrappers
        u, p = _gmres(A, b, x0, M, cfg)
    return FEMState(
        u=u, p=p, t=jnp.float32(0.0), step=jnp.int32(0)
    )


def _body_force_rhs(ops: ElementOps, f: Callable):
    """∫ f·v for a vectorized f(x, y) -> (fx, fy) evaluated at quad
    points (manufactured-solution tests)."""
    ru = jnp.einsum("eq,ql,eqd->eld", ops.wq, ops.Nu, _body_force_quad(ops, f))
    return jax.ops.segment_sum(
        ru.reshape(-1, 2), ops.elem_u.reshape(-1), num_segments=ops.n_u
    )


def _body_force_quad(ops: ElementOps, f: Callable):
    """Body force sampled at quadrature points, (nt, nq, 2) — the PSPG
    rhs needs the pointwise values, not the assembled ∫f·v."""
    fx, fy = f(ops.xq[..., 0], ops.xq[..., 1])
    return jnp.stack([fx, fy], axis=-1)


def make_projection_step(
    ops: ElementOps,
    cfg: FEMConfig,
    g,
    p_out_nodes,
    force_nodes=None,
    body_force: Optional[Callable] = None,
):
    """Incremental pressure-correction (projection) NS step — the
    segregated alternative to the monolithic saddle-point solve of
    ``make_step``, for meshes where block-Jacobi GMRES on the coupled
    system plateaus (≳10k triangles; see BENCHNOTES "Solver-scaling
    boundary"). Same physics/linearization as the reference's coupled
    scheme (v2.jl:202-226), split Chorin-Temam style:

    1. predictor — (M/dt + θνK + C(θūⁿ)) u* = (M/dt)uⁿ
       − (1−θ)(νK + C(ūⁿ))uⁿ − G pⁿ + f, Dirichlet rows = g
       (nonsymmetric; Jacobi-preconditioned GMRES, converges in tens of
       matvecs because M/dt dominates — no saddle point to fight);
    2. pressure increment — K_p φ = −(1/dt) B u*, φ = 0 on the outflow
       nodes (SPD; Jacobi-CG). Using the assembled Laplacian K_p in
       place of the consistent B M⁻¹ Bᵀ is the standard non-consistent
       projection — the O(dt) commutation defect doubles as
       Brezzi-Pitkäranta-style pressure stabilization, which is what
       makes equal-order P1-P1 stable here without the τ term;
    3. update — p ← p + φ (− χ·ν·M_p⁻¹ B u* in rotational form),
       u ← u* + dt·m_l⁻¹ Bᵀ φ (HRZ-lumped mass; Dirichlet rows kept).

    Splitting error is O(dt) in pressure / O(dt²) in velocity per step
    — at the benchmark dt the fields track the monolithic solver to
    ~1e-3 (tests/test_fem_projection.py) at a fraction of the cost.
    Forces use the same reaction method as ``make_step``, evaluated on
    the scheme's own momentum residual so the discrete momentum balance
    (not the splitting) defines them.
    """
    g = jnp.asarray(g)
    if len(p_out_nodes) == 0:
        raise ValueError(
            "projection scheme needs pressure-Dirichlet (outflow) nodes"
        )
    fmask = None
    if force_nodes is not None and len(force_nodes) > 0:
        fmask = jnp.zeros((ops.n_u,)).at[jnp.asarray(force_nodes)].set(1.0)
    bf = _body_force_rhs(ops, body_force) if body_force is not None else None
    th = float(cfg.theta)
    dm = ops.dir_mask[:, None]
    pm = jnp.zeros((ops.n_p,), dtype=bool).at[jnp.asarray(p_out_nodes)].set(
        True
    )
    inv_ml = 1.0 / lumped_mass_u(ops)
    inv_mp = 1.0 / mass_p_diag(ops)
    dp_k = jnp.where(pm, 1.0, stiffness_p_diag(ops))
    inv_dp_k = 1.0 / dp_k

    def corr_of(q):
        """Velocity correction direction M_L⁻¹ G q, zeroed on Dirichlet
        velocity rows (the update never touches those)."""
        c = inv_ml[:, None] * apply_grad_p(ops, q)
        return jnp.where(dm, 0.0, c)

    # Poisson operator choice. P1-P1: the ASSEMBLED Laplacian K_p — its
    # O(dt) defect vs the true Schur complement doubles as the
    # Brezzi-Pitkäranta stabilization that keeps the equal-order pair
    # stable (BENCHNOTES "Projection (segregated) solver"). Taylor-Hood
    # needs no stabilization and the K_p proxy is POOR for a P2
    # velocity space (measured: the correction leaves the divergence
    # untouched and the run drifts unstable) — use the exact lumped
    # Schur operator S = B P M_L⁻¹ Bᵀ matrix-free instead (P masks the
    # Dirichlet rows, matching the update), which drives the weak
    # continuity residual of u^{n+1} to CG tolerance identically.
    exact_schur = ops.kind != "p1p1"
    if exact_schur:

        def Ap(q):
            q0 = jnp.where(pm, 0.0, q)
            y = -apply_div_u(ops, corr_of(q0))
            return jnp.where(pm, q, y)

    else:

        def Ap(q):
            # P K_p P + (I−P) — symmetric Dirichlet embedding (P zeroes
            # the outflow rows), so CG sees an SPD operator
            y = apply_stiffness_p(ops, jnp.where(pm, 0.0, q))
            return jnp.where(pm, q, y)

    # pressure pc: the aggregation two-level hierarchy (one-time host
    # setup) — the K_p coarse space also preconditions the Taylor-Hood
    # exact Schur operator (spectrally equivalent)
    from cfdsim_tpu.fem.multilevel import build_pressure_coarse, make_pressure_pc

    level = (
        build_pressure_coarse(ops, p_out_nodes, cfg.pp_max_coarse)
        if cfg.pp_pc != "jacobi"
        else None
    )
    Mp = make_pressure_pc(level, inv_dp_k, Ap=Ap, kind=cfg.pp_pc)

    def _step_impl(state: FEMState, cfl_scale=1.0):
        dt = cfg.dt * cfl_scale
        inv_dt = 1.0 / dt
        u_prev, p_prev = state.u, state.p

        # --- 1. momentum predictor ---
        # SU stabilization is quadratic in ū so the θ weights are
        # explicit: θ·S(ū)u implicit, (1−θ)·S(ū)u_prev explicit
        tau_su = (
            cfg.supg * su_tau(ops, u_prev, cfg.nu, inv_dt)
            if cfg.supg
            else None
        )
        rhs_base = inv_dt * apply_mass_u(ops, u_prev)
        if th != 1.0:
            rhs_base = rhs_base - apply_momentum_conv(
                ops, u_prev, (1.0 - th) * cfg.nu, None, (1.0 - th) * u_prev
            )
            if tau_su is not None:
                rhs_base = rhs_base - (1.0 - th) * apply_su(
                    ops, u_prev, u_prev, tau_su
                )
        if bf is not None:
            rhs_base = rhs_base + bf
        rhs_u = rhs_base - apply_grad_p(ops, p_prev)
        b = jnp.where(dm, g, rhs_u)

        def Am(v):
            y = apply_momentum_conv(ops, v, th * cfg.nu, inv_dt, th * u_prev)
            if tau_su is not None:
                y = y + th * apply_su(ops, v, u_prev, tau_su)
            return jnp.where(dm, v, y)

        du, _ = operator_diag(ops, th * cfg.nu, inv_dt, None)
        inv_du = (1.0 / jnp.where(ops.dir_mask, 1.0, du))[:, None]
        u_star, _ = jax.scipy.sparse.linalg.gmres(
            Am,
            b,
            x0=u_prev,
            M=lambda v: inv_du * v,
            tol=cfg.gmres_tol,
            atol=0.0,
            restart=cfg.gmres_restart,
            maxiter=cfg.gmres_maxiter,
            solve_method=cfg.gmres_method,
        )

        # --- 2. pressure-increment Poisson ---
        div_star = apply_div_u(ops, u_star)
        bp = jnp.where(pm, 0.0, -inv_dt * div_star)
        phi0 = (
            jnp.zeros_like(bp)
            if state.phi is None
            else jnp.where(pm, 0.0, state.phi)
        )
        phi, _ = jax.scipy.sparse.linalg.cg(
            Ap,
            bp,
            x0=phi0,
            M=Mp,
            tol=cfg.pp_tol,
            atol=0.0,
            maxiter=cfg.pp_maxiter,
        )

        # --- 3. correction ---
        u_new = u_star - dt * corr_of(phi)
        p_new = p_prev + phi
        if cfg.rotational:
            p_new = p_new - cfg.rotational * cfg.nu * inv_mp * div_star

        # v2.jl:223-225 — unconverged/non-finite solve keeps previous
        r = Am(u_star) - b
        relres = jnp.sqrt(jnp.sum(r * r)) / jnp.maximum(
            jnp.sqrt(jnp.sum(b * b)), 1e-30
        )
        finite = jnp.isfinite(jnp.sum(u_new)) & jnp.isfinite(jnp.sum(p_new))
        ok = finite & (relres < cfg.accept_relres)
        u_new = jnp.where(ok, u_new, u_prev)
        p_new = jnp.where(ok, p_new, p_prev)

        # diagnostics
        _, gu_s = interpolate_u(ops, u_star)
        div_pre = l2_norm(ops, gu_s[..., 0, 0] + gu_s[..., 1, 1])
        uq, gu = interpolate_u(ops, u_new)
        div_post = l2_norm(ops, gu[..., 0, 0] + gu[..., 1, 1])
        vort = gu[..., 1, 0] - gu[..., 0, 1]
        area = jnp.sum(ops.wq)
        energy = 0.5 * jnp.sum(ops.wq * jnp.sum(uq * uq, axis=-1)) / area
        max_vel = jnp.sqrt(jnp.max(jnp.sum(uq * uq, axis=-1)))

        fx = jnp.float32(0.0)
        fy = jnp.float32(0.0)
        if fmask is not None:
            # reaction force from the scheme's own discrete momentum
            # balance at (u_new, p_new); see make_step for the sign
            yu = apply_momentum_conv(
                ops, u_new, th * cfg.nu, inv_dt, th * u_prev
            )
            if tau_su is not None:
                yu = yu + th * apply_su(ops, u_new, u_prev, tau_su)
            res_u = yu + apply_grad_p(ops, p_new) - rhs_base
            fx = -jnp.sum(fmask * res_u[:, 0])
            fy = -jnp.sum(fmask * res_u[:, 1])

        # carry the increment for the next step's warm start iff the
        # incoming state carried one (pytree structure must be stable
        # across scan iterations)
        new_phi = (
            None if state.phi is None else jnp.where(ok, phi, state.phi)
        )
        new = FEMState(
            u=u_new, p=p_new, t=state.t + dt, step=state.step + 1,
            phi=new_phi,
        )
        metrics = StepMetrics(
            dt=dt,
            div_pre=div_pre,
            div_post=div_post,
            max_vel=max_vel,
            energy=energy,
            vort_max=jnp.max(jnp.abs(vort)),
            poisson_res=relres,
            fx=fx,
            fy=fy,
        )
        return new, metrics

    def step(state: FEMState, cfl_scale=1.0):
        # fp32 matmul precision for every assembly einsum: a reduced-
        # precision default (bf16 passes, TF32 on a GPU) stalls GMRES
        # near 1e-3. No-op on CPU.
        with jax.default_matmul_precision("float32"):
            return _step_impl(state, cfl_scale)

    return step


def make_step(
    ops: ElementOps,
    cfg: FEMConfig,
    g,
    force_nodes=None,
    body_force: Optional[Callable] = None,
):
    """Build the jitted semi-implicit NS step.

    ``g``: (n_u, 2) Dirichlet lift; ``force_nodes``: velocity-DOF index
    array on which to report the reaction force (e.g. the cylinder tag)
    — fills StepMetrics.fx/fy with the hydrodynamic force per unit
    density (drag/lift; Cd = 2 fx / (V∞² D)).
    """
    g = jnp.asarray(g)
    fmask = None
    if force_nodes is not None and len(force_nodes) > 0:
        fmask = jnp.zeros((ops.n_u,)).at[jnp.asarray(force_nodes)].set(1.0)
    tau = _tau(ops, cfg)
    bf = _body_force_rhs(ops, body_force) if body_force is not None else None
    fq = _body_force_quad(ops, body_force) if body_force is not None else None
    solve, rhs_fn, opA, unmasked_momentum = _make_implicit_solver(
        ops, cfg, g, bf, fq
    )

    def _step_impl(state: FEMState, cfl_scale=1.0):
        dt = cfg.dt * cfl_scale
        inv_dt = 1.0 / dt
        u_prev, p_prev = state.u, state.p

        u, p = solve(u_prev, p_prev, inv_dt)

        # v2.jl:223-225 — unconverged/non-finite solve keeps previous
        A = lambda x: opA(u_prev, inv_dt, x)
        b, rhs_u = rhs_fn(u_prev, p_prev, inv_dt)
        relres = _relres(A, (u, p), b)
        finite = jnp.isfinite(jnp.sum(u)) & jnp.isfinite(jnp.sum(p))
        ok = finite & (relres < cfg.accept_relres)
        u = jnp.where(ok, u, u_prev)
        p = jnp.where(ok, p, p_prev)

        # diagnostics at quadrature points
        uq, gu = interpolate_u(ops, u)
        div_l2 = l2_norm(ops, gu[..., 0, 0] + gu[..., 1, 1])
        vort = gu[..., 1, 0] - gu[..., 0, 1]
        area = jnp.sum(ops.wq)
        energy = 0.5 * jnp.sum(ops.wq * jnp.sum(uq * uq, axis=-1)) / area
        max_vel = jnp.sqrt(jnp.max(jnp.sum(uq * uq, axis=-1)))

        fx = jnp.float32(0.0)
        fy = jnp.float32(0.0)
        if fmask is not None:
            # consistent reaction force: the momentum residual (without
            # Dirichlet row replacement) tested against the indicator of
            # the body nodes equals ∫_Γ (ν∇u−pI)·n_fluid·φ dΓ; on the
            # body n_fluid points INTO it, so the force ON the body is
            # the negative of the summed residual
            yu = unmasked_momentum(u_prev, inv_dt, (u, p))
            res_u = yu - rhs_u
            fx = -jnp.sum(fmask * res_u[:, 0])
            fy = -jnp.sum(fmask * res_u[:, 1])

        new = FEMState(
            u=u, p=p, t=state.t + dt, step=state.step + 1
        )
        metrics = StepMetrics(
            dt=dt,
            div_pre=div_l2,
            div_post=div_l2,
            max_vel=max_vel,
            energy=energy,
            vort_max=jnp.max(jnp.abs(vort)),
            poisson_res=relres,
            fx=fx,
            fy=fy,
        )
        return new, metrics

    def step(state: FEMState, cfl_scale=1.0):
        # fp32 matmul precision for every assembly einsum: a reduced-
        # precision default (bf16 passes, TF32 on a GPU) stalls GMRES
        # near 1e-3. No-op on CPU.
        with jax.default_matmul_precision("float32"):
            return _step_impl(state, cfl_scale)

    return step
