"""Multi-chip unstructured FEM: element-partitioned assembly.

The natural SPMD decomposition for matrix-free FEM on a device mesh is
element data-parallelism: each chip owns a contiguous slice of the
element tables (DOF maps, gradients, quadrature weights), computes its
partial gather→einsum→``segment_sum`` assembly into a full-length DOF
vector, and one ``psum`` over the mesh axis produces the replicated
global result — the unstructured analog of the halo-exchange stencil
steps in ``parallel/mac_explicit.py``. DOF vectors stay replicated
(they are ~1000× smaller than the element tables), so GMRES runs
bit-identically on every device with one collective per operator
application.

Implementation notes for this backend (CLAUDE.md "second backend bug"):
the element tables are passed as shard_map *arguments*, never closed
over — gathers on closed-over constants inside shard_map miscompile on
the pinned XLA CPU build. Element counts are padded to a multiple of
the mesh size with zero-weight elements (wq=0 ⇒ zero contribution).

Parity: distributes the same weak form as models/fem.py (reference
v2.jl:202-215); the reference family itself has no distributed solve —
its only parallelism is pmap'd viz sampling (v2.jl:22-24, :286).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from cfdsim_tpu.fem.assembly import ElementOps
from cfdsim_tpu.models.fem import (
    FEMConfig,
    FEMState,
    _gmres,
    _relres,
    _tau,
    apply_mass_u,
)
from cfdsim_tpu.models.incompressible import StepMetrics


class ShardedTables(NamedTuple):
    """Element tables padded to a multiple of the mesh size (leading
    axis is sharded; everything is a shard_map argument)."""

    elem_u: jax.Array
    elem_p: jax.Array
    Gu: jax.Array
    Gp: jax.Array
    wq: jax.Array
    tau: jax.Array  # per-element stabilization, 0 where off/padded
    h_e: jax.Array  # element size (the SU τ formula; padded with 1)


def _pad_tables(ops: ElementOps, tau, n_dev: int) -> ShardedTables:
    nt = ops.elem_u.shape[0]
    pad = (-nt) % n_dev
    if tau is None:
        tau = jnp.zeros((nt,), dtype=ops.wq.dtype)

    def padded(a, fill=0):
        if pad == 0:
            return a
        width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, width, constant_values=fill)

    return ShardedTables(
        elem_u=padded(ops.elem_u),
        elem_p=padded(ops.elem_p),
        Gu=padded(ops.Gu),
        Gp=padded(ops.Gp),
        wq=padded(ops.wq),  # zero weights ⇒ padded elements contribute 0
        tau=padded(tau),
        h_e=padded(ops.h_e, fill=1),  # nonzero: SU τ divides by h
    )


def _local_apply(ops, tab, u, p, nu, inv_dt, adv_u, axis, pspg=False):
    """Per-device block application on the local element slice, psum'd
    to the replicated global residual (runs inside shard_map).

    ``pspg``: consistent residual-based continuity stabilization
    (models/fem.py ``stab="pspg"``) instead of the τ∇p·∇q form — only
    differs on the transient path (mass + convection present)."""
    ue = u[tab.elem_u]
    pe = p[tab.elem_p]
    gu = jnp.einsum("eqlc,eld->eqdc", tab.Gu, ue)
    pq = jnp.einsum("ql,el->eq", ops.Np, pe)
    divu = gu[..., 0, 0] + gu[..., 1, 1]

    ru = nu * jnp.einsum("eq,eqlc,eqdc->eld", tab.wq, tab.Gu, gu)
    uq = conv = None
    if inv_dt is not None:
        uq = jnp.einsum("ql,eld->eqd", ops.Nu, ue)
        ru = ru + inv_dt * jnp.einsum("eq,ql,eqd->eld", tab.wq, ops.Nu, uq)
    if adv_u is not None:
        aq = jnp.einsum("ql,eld->eqd", ops.Nu, adv_u[tab.elem_u])
        conv = jnp.einsum("eqc,eqdc->eqd", aq, gu)
        ru = ru + jnp.einsum("eq,ql,eqd->eld", tab.wq, ops.Nu, conv)
    ru = ru - jnp.einsum("eq,eqld,eq->eld", tab.wq, tab.Gu, pq)

    rp = jnp.einsum("eq,ql,eq->el", tab.wq, ops.Np, divu)
    gp = jnp.einsum("eqlc,el->eqc", tab.Gp, pe)
    r_stab = gp
    if pspg and uq is not None and conv is not None:
        r_stab = inv_dt * uq + conv + gp
    rp = rp + jnp.einsum(
        "e,eq,eqlc,eqc->el", tab.tau, tab.wq, tab.Gp, r_stab
    )

    yu = jax.ops.segment_sum(
        ru.reshape(-1, 2), tab.elem_u.reshape(-1), num_segments=ops.n_u
    )
    yp = jax.ops.segment_sum(
        rp.reshape(-1), tab.elem_p.reshape(-1), num_segments=ops.n_p
    )
    return jax.lax.psum(yu, axis), jax.lax.psum(yp, axis)


def _local_pspg_rhs(ops, tab, u, adv_u, inv_dt, axis):
    """rhs share of the consistent PSPG continuity row on the local
    element slice: τ∫∇q·(inv_dt·u + (adv_u·∇)u), psum'd (the sharded
    counterpart of models/fem.py's rhs under ``stab="pspg"``; the
    caller passes adv_u = −(1−θ)·ū, zeros for backward Euler)."""
    ue = u[tab.elem_u]
    uq = jnp.einsum("ql,eld->eqd", ops.Nu, ue)
    gu = jnp.einsum("eqlc,eld->eqdc", tab.Gu, ue)
    aq = jnp.einsum("ql,eld->eqd", ops.Nu, adv_u[tab.elem_u])
    conv = jnp.einsum("eqc,eqdc->eqd", aq, gu)
    r = inv_dt * uq + conv
    rp = jnp.einsum("e,eq,eqlc,eqc->el", tab.tau, tab.wq, tab.Gp, r)
    yp = jax.ops.segment_sum(
        rp.reshape(-1), tab.elem_p.reshape(-1), num_segments=ops.n_p
    )
    return jax.lax.psum(yp, axis)


def make_sharded_ns_apply(
    ops: ElementOps,
    mesh: Mesh,
    cfg: FEMConfig,
    axis: str = "x",
):
    """Build ``apply(u, p, inv_dt, adv_u) -> (yu, yp)`` with element-
    sharded assembly over ``mesh`` (replicated in/out DOF vectors)."""
    n_dev = mesh.shape[axis]
    tab = _pad_tables(ops, _tau(ops, cfg), n_dev)
    sharded = P(axis)
    rep = P()
    tab_specs = ShardedTables(*(sharded for _ in tab))
    pspg = cfg.stab == "pspg"

    smapped_t = shard_map(  # transient: mass + convection present
        lambda tb, u, p, nu, idt, au: _local_apply(
            ops, tb, u, p, nu, idt, au, axis, pspg=pspg
        ),
        mesh=mesh,
        in_specs=(tab_specs, rep, rep, rep, rep, rep),
        out_specs=(rep, rep),
        check_vma=False,
    )
    smapped_s = shard_map(  # steady Stokes: no mass, no convection
        lambda tb, u, p, nu: _local_apply(
            ops, tb, u, p, nu, None, None, axis
        ),
        mesh=mesh,
        in_specs=(tab_specs, rep, rep, rep),
        out_specs=(rep, rep),
        check_vma=False,
    )

    def apply(u, p, inv_dt=None, adv_u=None, nu=None):
        # ``nu`` override supports the θ-scheme's scaled calls
        # (models/fem.py: θ(νK+C(ū))u = (θν)Ku + C(θū)u)
        nu = jnp.asarray(cfg.nu if nu is None else nu, dtype=ops.Nu.dtype)
        if adv_u is None and inv_dt is None:
            return smapped_s(tab, u, p, nu)
        return smapped_t(tab, u, p, nu, jnp.asarray(inv_dt), adv_u)

    return apply


def make_step(
    ops: ElementOps,
    cfg: FEMConfig,
    g,
    mesh: Mesh,
    axis: str = "x",
    force_nodes=None,
):
    """Sharded-assembly counterpart of models.fem.make_step — identical
    math (exact-equality-tested), one psum per operator application."""
    from cfdsim_tpu.models.fem import _preconditioner, build_schur_coarse

    g = jnp.asarray(g)
    apply_sharded = make_sharded_ns_apply(ops, mesh, cfg, axis)
    tau = _tau(ops, cfg)
    level = build_schur_coarse(ops, cfg)
    dm = ops.dir_mask[:, None]
    fmask = None
    if force_nodes is not None and len(force_nodes) > 0:
        fmask = jnp.zeros((ops.n_u,)).at[jnp.asarray(force_nodes)].set(1.0)

    th = float(cfg.theta)
    pspg = cfg.stab == "pspg" and tau is not None
    smapped_pspg_rhs = None
    if pspg:
        n_dev = mesh.shape[axis]
        tab = _pad_tables(ops, tau, n_dev)
        tab_specs = ShardedTables(*(P(axis) for _ in tab))
        smapped_pspg_rhs = shard_map(
            lambda tb, u, au, idt: _local_pspg_rhs(ops, tb, u, au, idt, axis),
            mesh=mesh,
            in_specs=(tab_specs, P(), P(), P()),
            out_specs=P(),
            check_vma=False,
        )

        def pspg_rhs(u_prev, inv_dt):
            adv = (0.0 if th == 1.0 else -(1.0 - th)) * u_prev
            return smapped_pspg_rhs(
                tab, u_prev, adv, jnp.asarray(inv_dt, ops.Nu.dtype)
            )

    def _step_impl(state: FEMState, cfl_scale=1.0):
        dt = cfg.dt * cfl_scale
        inv_dt = 1.0 / dt
        u_prev, p_prev = state.u, state.p

        def A(x):
            # θ-weighted implicit operator (see models/fem.py)
            u, p = x
            yu, yp = apply_sharded(
                u, p, inv_dt, th * u_prev, nu=th * cfg.nu
            )
            return (jnp.where(dm, u, yu), yp)

        rhs_u = inv_dt * apply_mass_u(ops, u_prev)
        if th != 1.0:
            yu_e, _ = apply_sharded(
                u_prev, jnp.zeros((ops.n_p,), dtype=u_prev.dtype),
                inv_dt=0.0, adv_u=(1.0 - th) * u_prev,
                nu=(1.0 - th) * cfg.nu,
            )
            rhs_u = rhs_u - yu_e
        bu = jnp.where(dm, g, rhs_u)
        bp = jnp.zeros((ops.n_p,), dtype=bu.dtype)
        if pspg:
            bp = bp + pspg_rhs(u_prev, inv_dt)
        b = (bu, bp)
        M = _preconditioner(ops, cfg, inv_dt, tau, level)
        u, p = _gmres(A, b, (u_prev, p_prev), M, cfg)

        relres = _relres(A, (u, p), b)
        finite = jnp.isfinite(jnp.sum(u)) & jnp.isfinite(jnp.sum(p))
        ok = finite & (relres < cfg.accept_relres)
        u = jnp.where(ok, u, u_prev)
        p = jnp.where(ok, p, p_prev)

        from cfdsim_tpu.fem.assembly import interpolate_u, l2_norm

        uq, gu = interpolate_u(ops, u)
        div_l2 = l2_norm(ops, gu[..., 0, 0] + gu[..., 1, 1])
        vort = gu[..., 1, 0] - gu[..., 0, 1]
        area = jnp.sum(ops.wq)
        energy = 0.5 * jnp.sum(ops.wq * jnp.sum(uq * uq, axis=-1)) / area
        max_vel = jnp.sqrt(jnp.max(jnp.sum(uq * uq, axis=-1)))

        fx = jnp.float32(0.0)
        fy = jnp.float32(0.0)
        if fmask is not None:
            yu, _ = apply_sharded(
                u, p, inv_dt, th * u_prev, nu=th * cfg.nu
            )
            res_u = yu - rhs_u
            fx = -jnp.sum(fmask * res_u[:, 0])
            fy = -jnp.sum(fmask * res_u[:, 1])

        new = FEMState(u=u, p=p, t=state.t + dt, step=state.step + 1)
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


def _local_momentum(ops, tab, v, adv, su_adv, nu, inv_dt, tau_su, use_su,
                    axis):
    """Momentum block (M/dt + νK + C(adv) [+ θ-weighted SU]) on the
    local element slice, psum'd (no pressure coupling — the projection
    predictor). ``adv`` carries the θ-scaled convection field; SU uses
    the unscaled ``su_adv`` with the precomputed (sharded) per-element
    ``tau_su`` — exactly models/fem.py's split of the two weightings."""
    ue = v[tab.elem_u]
    gu = jnp.einsum("eqlc,eld->eqdc", tab.Gu, ue)
    ru = nu * jnp.einsum("eq,eqlc,eqdc->eld", tab.wq, tab.Gu, gu)
    uq = jnp.einsum("ql,eld->eqd", ops.Nu, ue)
    ru = ru + inv_dt * jnp.einsum("eq,ql,eqd->eld", tab.wq, ops.Nu, uq)
    aq = jnp.einsum("ql,eld->eqd", ops.Nu, adv[tab.elem_u])
    conv = jnp.einsum("eqc,eqdc->eqd", aq, gu)
    ru = ru + jnp.einsum("eq,ql,eqd->eld", tab.wq, ops.Nu, conv)
    if use_su:
        sq = jnp.einsum("ql,eld->eqd", ops.Nu, su_adv[tab.elem_u])
        conv_s = jnp.einsum("eqc,eqdc->eqd", sq, gu)
        wl = jnp.einsum("eqc,eqlc->eql", sq, tab.Gu)
        ru = ru + jnp.einsum(
            "e,eq,eql,eqd->eld", tau_su, tab.wq, wl, conv_s
        )
    yu = jax.ops.segment_sum(
        ru.reshape(-1, 2), tab.elem_u.reshape(-1), num_segments=ops.n_u
    )
    return jax.lax.psum(yu, axis)


def _local_grad(ops, tab, p, axis):
    """G p = −∫ p ∇·v on the local slice, psum'd."""
    pq = jnp.einsum("ql,el->eq", ops.Np, p[tab.elem_p])
    ru = -jnp.einsum("eq,eqld,eq->eld", tab.wq, tab.Gu, pq)
    yu = jax.ops.segment_sum(
        ru.reshape(-1, 2), tab.elem_u.reshape(-1), num_segments=ops.n_u
    )
    return jax.lax.psum(yu, axis)


def _local_div(ops, tab, u, axis):
    """B u = ∫ q ∇·u on the local slice, psum'd."""
    gu = jnp.einsum("eqlc,eld->eqdc", tab.Gu, u[tab.elem_u])
    divu = gu[..., 0, 0] + gu[..., 1, 1]
    rp = jnp.einsum("eq,ql,eq->el", tab.wq, ops.Np, divu)
    yp = jax.ops.segment_sum(
        rp.reshape(-1), tab.elem_p.reshape(-1), num_segments=ops.n_p
    )
    return jax.lax.psum(yp, axis)


def _local_kp(ops, tab, q, axis):
    """K_p q = ∫ ∇q·∇φ on the local slice, psum'd."""
    gq = jnp.einsum("eqlc,el->eqc", tab.Gp, q[tab.elem_p])
    rp = jnp.einsum("eq,eqlc,eqc->el", tab.wq, tab.Gp, gq)
    yp = jax.ops.segment_sum(
        rp.reshape(-1), tab.elem_p.reshape(-1), num_segments=ops.n_p
    )
    return jax.lax.psum(yp, axis)


def make_projection_step(
    ops: ElementOps,
    cfg: FEMConfig,
    g,
    p_out_nodes,
    mesh: Mesh,
    axis: str = "x",
    force_nodes=None,
):
    """Element-sharded counterpart of models.fem.make_projection_step —
    the segregated production FEM scheme on a device mesh. Same math
    (equality-tested in tests/test_fem_explicit.py): element-sharded
    partial assembly + one psum per operator application; the GMRES/CG
    iterations run replicated on the DOF vectors. Per predictor matvec:
    one psum; per pressure-CG matvec: one psum (P1-P1 K_p) or two
    (Taylor-Hood exact Schur, grad then div)."""
    from cfdsim_tpu.fem.assembly import (
        interpolate_u,
        l2_norm,
        lumped_mass_u,
        mass_p_diag,
        operator_diag,
        stiffness_p_diag,
    )

    g = jnp.asarray(g)
    if len(p_out_nodes) == 0:
        raise ValueError(
            "projection scheme needs pressure-Dirichlet (outflow) nodes"
        )
    n_dev = mesh.shape[axis]
    tab = _pad_tables(ops, None, n_dev)
    sharded = P(axis)
    rep = P()
    tab_specs = ShardedTables(*(sharded for _ in tab))
    use_su = bool(cfg.supg)

    def _smap(fn, n_in):
        return shard_map(
            fn,
            mesh=mesh,
            in_specs=(tab_specs,) + (rep,) * n_in,
            out_specs=rep,
            check_vma=False,
        )

    smapped_mom = shard_map(
        lambda tb, v, adv, su_adv, nu, idt, tau_su: _local_momentum(
            ops, tb, v, adv, su_adv, nu, idt, tau_su, use_su, axis
        ),
        mesh=mesh,
        in_specs=(tab_specs, rep, rep, rep, rep, rep, sharded),
        out_specs=rep,
        check_vma=False,
    )
    smapped_grad = _smap(lambda tb, p: _local_grad(ops, tb, p, axis), 1)
    smapped_div = _smap(lambda tb, u: _local_div(ops, tb, u, axis), 1)
    smapped_kp = _smap(lambda tb, q: _local_kp(ops, tb, q, axis), 1)
    nt_pad = (-ops.elem_u.shape[0]) % n_dev

    fmask = None
    if force_nodes is not None and len(force_nodes) > 0:
        fmask = jnp.zeros((ops.n_u,)).at[jnp.asarray(force_nodes)].set(1.0)
    th = float(cfg.theta)
    dm = ops.dir_mask[:, None]
    pm = jnp.zeros((ops.n_p,), dtype=bool).at[jnp.asarray(p_out_nodes)].set(
        True
    )
    inv_ml = 1.0 / lumped_mass_u(ops)
    inv_mp = 1.0 / mass_p_diag(ops)
    inv_dp_k = 1.0 / jnp.where(pm, 1.0, stiffness_p_diag(ops))
    from cfdsim_tpu.fem.multilevel import (
        build_pressure_coarse,
        make_pressure_pc,
    )

    def mom(v, adv, su_adv, nu, inv_dt, tau_su):
        return smapped_mom(
            tab, v, adv, su_adv,
            jnp.asarray(nu, ops.Nu.dtype),
            jnp.asarray(inv_dt, ops.Nu.dtype),
            jnp.pad(tau_su, (0, nt_pad)),
        )

    def corr_of(q):
        c = inv_ml[:, None] * smapped_grad(tab, q)
        return jnp.where(dm, 0.0, c)

    exact_schur = ops.kind != "p1p1"
    if exact_schur:

        def Ap(q):
            q0 = jnp.where(pm, 0.0, q)
            y = -smapped_div(tab, corr_of(q0))
            return jnp.where(pm, q, y)

    else:

        def Ap(q):
            y = smapped_kp(tab, jnp.where(pm, 0.0, q))
            return jnp.where(pm, q, y)

    # identical host-built hierarchy as the single-device step (the
    # build is deterministic in ops, so the equality tests hold); the
    # pc's segment_sum/matmul/gather run in the replicated Krylov
    # region, outside any shard_map body (CLAUDE.md gather caveat)
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

        # --- 1. momentum predictor (models/fem.py layout: convection
        # carries the θ scale via its adv argument, SU uses the
        # unscaled ū with τ(ū, ν, dt) precomputed here — replicated
        # math outside shard_map, sharded (nt,) argument inside) ---
        from cfdsim_tpu.fem.assembly import su_tau

        zero_tau = jnp.zeros((ops.h_e.shape[0],), dtype=ops.wq.dtype)
        tau_su = (
            cfg.supg * su_tau(ops, u_prev, cfg.nu, inv_dt)
            if use_su
            else zero_tau
        )
        rhs_base = inv_dt * apply_mass_u(ops, u_prev)
        if th != 1.0:
            rhs_base = rhs_base - mom(
                u_prev, (1.0 - th) * u_prev, u_prev,
                (1.0 - th) * cfg.nu, 0.0, (1.0 - th) * tau_su,
            )
        rhs_u = rhs_base - smapped_grad(tab, p_prev)
        b = jnp.where(dm, g, rhs_u)

        def Am(v):
            y = mom(
                v, th * u_prev, u_prev, th * cfg.nu, inv_dt, th * tau_su
            )
            return jnp.where(dm, v, y)

        du, _ = operator_diag(ops, th * cfg.nu, inv_dt, None)
        inv_du = (1.0 / jnp.where(ops.dir_mask, 1.0, du))[:, None]
        u_star, _ = jax.scipy.sparse.linalg.gmres(
            Am, b, x0=u_prev, M=lambda v: inv_du * v,
            tol=cfg.gmres_tol, atol=0.0, restart=cfg.gmres_restart,
            maxiter=cfg.gmres_maxiter, solve_method=cfg.gmres_method,
        )

        # --- 2. pressure-increment Poisson ---
        div_star = smapped_div(tab, u_star)
        bp = jnp.where(pm, 0.0, -inv_dt * div_star)
        phi0 = (
            jnp.zeros_like(bp)
            if state.phi is None
            else jnp.where(pm, 0.0, state.phi)
        )
        phi, _ = jax.scipy.sparse.linalg.cg(
            Ap, bp, x0=phi0, M=Mp,
            tol=cfg.pp_tol, atol=0.0, maxiter=cfg.pp_maxiter,
        )

        # --- 3. correction ---
        u_new = u_star - dt * corr_of(phi)
        p_new = p_prev + phi
        if cfg.rotational:
            p_new = p_new - cfg.rotational * cfg.nu * inv_mp * div_star

        r = Am(u_star) - b
        relres = jnp.sqrt(jnp.sum(r * r)) / jnp.maximum(
            jnp.sqrt(jnp.sum(b * b)), 1e-30
        )
        finite = jnp.isfinite(jnp.sum(u_new)) & jnp.isfinite(jnp.sum(p_new))
        ok = finite & (relres < cfg.accept_relres)
        u_new = jnp.where(ok, u_new, u_prev)
        p_new = jnp.where(ok, p_new, p_prev)

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
            yu = mom(
                u_new, th * u_prev, u_prev, th * cfg.nu, inv_dt,
                th * tau_su,
            )
            res_u = yu + smapped_grad(tab, p_new) - rhs_base
            fx = -jnp.sum(fmask * res_u[:, 0])
            fy = -jnp.sum(fmask * res_u[:, 1])

        new_phi = (
            None if state.phi is None else jnp.where(ok, phi, state.phi)
        )
        new = FEMState(
            u=u_new, p=p_new, t=state.t + dt, step=state.step + 1,
            phi=new_phi,
        )
        metrics = StepMetrics(
            dt=dt, div_pre=div_pre, div_post=div_post, max_vel=max_vel,
            energy=energy, vort_max=jnp.max(jnp.abs(vort)),
            poisson_res=relres, fx=fx, fy=fy,
        )
        return new, metrics

    def step(state: FEMState, cfl_scale=1.0):
        # fp32 matmul precision for every assembly einsum: a reduced-
        # precision default (bf16 passes, TF32 on a GPU) stalls GMRES
        # near 1e-3. No-op on CPU.
        with jax.default_matmul_precision("float32"):
            return _step_impl(state, cfl_scale)

    return step


def solve_stokes_sharded(
    ops: ElementOps, cfg: FEMConfig, g, mesh: Mesh, axis: str = "x"
) -> FEMState:
    """Sharded-assembly steady Stokes init (models.fem.solve_stokes)."""
    from cfdsim_tpu.models.fem import _preconditioner, build_schur_coarse

    g = jnp.asarray(g, dtype=ops.Nu.dtype)
    apply_sharded = make_sharded_ns_apply(ops, mesh, cfg, axis)
    dm = ops.dir_mask[:, None]

    def A(x):
        u, p = x
        yu, yp = apply_sharded(u, p)
        return (jnp.where(dm, u, yu), yp)

    bu = jnp.where(dm, g, jnp.zeros((ops.n_u, 2), dtype=ops.Nu.dtype))
    b = (bu, jnp.zeros((ops.n_p,), dtype=ops.Nu.dtype))
    M = _preconditioner(
        ops, cfg, None, _tau(ops, cfg),
        build_schur_coarse(ops, cfg, steady=True),
    )
    u, p = _gmres(A, b, (g, jnp.zeros((ops.n_p,), dtype=ops.Nu.dtype)), M, cfg)
    return FEMState(u=u, p=p, t=jnp.float32(0.0), step=jnp.int32(0))
