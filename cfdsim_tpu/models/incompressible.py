"""Incompressible Navier–Stokes: Chorin fractional-step projection.

The JAX rebuild of the reference's flagship solver family
(``OptimizedTurbulentSolver.time_step`` v5.py:375-441 and ancestors
v1-v4): one pure jitted function advances the whole state one step —
adaptive dt → LES → SUPG → predictor → BCs → IBM → Poisson projection →
corrector → divergence cleanup → clipping — with every stencil fused by
XLA instead of crossing a Python↔Numba boundary per kernel. N steps run
as a single ``lax.scan``; the host only sees per-step metric scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from cfdsim_tpu.grid import Grid
from cfdsim_tpu.ibm import apply_ibm, ibm_ramp
from cfdsim_tpu.ops.convection import (
    convection_central,
    convection_supg,
    convection_tvd,
    convection_upwind,
    supg_tau,
)
from cfdsim_tpu.ops.les import smagorinsky_viscosity
from cfdsim_tpu.ops.stencil import (
    curl,
    divergence,
    gradient,
    interior_mask,
    laplacian_coeff,
)
from cfdsim_tpu.solvers.poisson import (
    PoissonConfig,
    poisson_residual,
    solve_poisson,
)


class IncompressibleState(NamedTuple):
    """Pytree state for the projection solver (the reference's u/v/p field
    set, v5.py:285-297, plus step/time bookkeeping on device)."""

    u: jax.Array  # (ny, nx) x-velocity
    v: jax.Array  # (ny, nx) y-velocity
    p: jax.Array  # (ny, nx) pressure (projection potential, warm-starts next solve)
    t: jax.Array  # scalar f32 simulated time
    step: jax.Array  # scalar i32


class StepMetrics(NamedTuple):
    """Per-step diagnostics (the reference's log lines v5.py:410-435 as
    device scalars, reduced on the device). ``fx``/``fy`` are the hydrodynamic
    force components on the immersed body (the momentum the penalization
    removes from the fluid, per unit density) — 0 when no IBM body is
    present; drag/lift coefficients = 2·f/(v∞²·D)."""

    dt: jax.Array
    div_pre: jax.Array  # max |div u*| before projection
    div_post: jax.Array  # max |div u| after projection
    max_vel: jax.Array
    energy: jax.Array  # mean kinetic energy
    vort_max: jax.Array
    poisson_res: jax.Array
    fx: jax.Array = jnp.float32(0.0)  # body drag force (per unit density)
    fy: jax.Array = jnp.float32(0.0)  # body lift force
    fz: jax.Array = jnp.float32(0.0)  # body lateral force (3D IBM bodies)


@dataclasses.dataclass(frozen=True)
class IncompressibleConfig:
    """Static solver configuration (the reference's dataclass configs,
    v5.py:41-94, minus I/O concerns which live in the runner)."""

    grid: Grid
    nu: float
    scheme: str = "central"  # central | upwind | tvd | supg | supg_refparity
    # diffusion treatment: "explicit" (forward Euler, dt limited by the
    # 2D bound h²/4ν) or "implicit" (backward Euler on the viscous term —
    # the capability of the reference's Julia FEM solver, v1.jl:130-167 —
    # solved matrix-free by damped Jacobi; drops the viscous dt limit)
    diffusion: str = "explicit"
    implicit_iters: int = 12
    # implicit viscous backend: "dst" = exact Dirichlet Helmholtz in one
    # DST-I transform pair (solvers/helmholtz.py, requires scalar ν so it
    # is incompatible with LES); "jacobi" = damped Jacobi iteration
    # (implicit_iters sweeps, works with spatially varying ν_eff);
    # "auto" = dst when possible, else jacobi
    implicit_solver: str = "auto"
    use_les: bool = False
    smagorinsky_constant: float = 0.17
    artificial_viscosity: float = 0.0
    poisson: PoissonConfig = PoissonConfig(method="rbsor", iters=100, omega=1.7)
    # adaptive time stepping (reference adaptive_time_step v5.py:316-326)
    adaptive_dt: bool = True
    cfl_target: float = 0.5
    dt_base: float = 1e-3
    dt_min: float = 1e-7
    dt_max: float = 1.0
    warmup_steps: int = 0
    warmup_dt: float = 0.0
    # stabilization / parity knobs
    max_velocity: float = 1e3  # clip bound (v5.py:437-438)
    cleanup_iters: int = 0  # extra divergence-cleanup sweeps (v5.py:239-257)
    ibm_ramp_steps: int = 0  # IBM force ramp (v5.py:406)
    masked_poisson: bool = False  # φ frozen inside solids (v5.py:213)
    compute_metrics: bool = True
    # inter-step u/v storage precision (see models/mac.MACConfig.storage:
    # "bf16" halves state HBM bytes, fp32 compute, ~4e-3 per-step
    # rounding — a bandwidth experiment, not an accuracy-neutral default)
    storage: str = "fp32"  # fp32 | bf16


def init_state(cfg: IncompressibleConfig, u0=None, v0=None, p0=None):
    g = cfg.grid
    vdt = jnp.bfloat16 if cfg.storage == "bf16" else jnp.float32
    # distinct buffers so the state pytree is safely donatable
    return IncompressibleState(
        u=g.zeros(vdt) if u0 is None else jnp.asarray(u0, vdt),
        v=g.zeros(vdt) if v0 is None else jnp.asarray(v0, vdt),
        p=g.zeros() if p0 is None else jnp.asarray(p0, jnp.float32),
        t=jnp.float32(0.0),
        step=jnp.int32(0),
    )


def _adaptive_dt(cfg: IncompressibleConfig, u, v, nu_t, step, cfl_scale):
    """CFL + viscous dt with clipping and fixed-dt warmup.

    Parity: reference ``adaptive_time_step`` v5.py:316-326. ``cfl_scale``
    is the host-controlled back-off factor (cavity_flow_v1.py:481-488).
    """
    if not cfg.adaptive_dt:
        return jnp.float32(cfg.dt_base)
    h = min(cfg.grid.dx, cfg.grid.dy)
    vel_max = jnp.maximum(
        jnp.maximum(jnp.max(jnp.abs(u)), jnp.max(jnp.abs(v))), 1e-10
    )
    dt_cfl = cfg.cfl_target * cfl_scale * h / vel_max
    if cfg.diffusion == "implicit":
        dt = jnp.clip(dt_cfl, cfg.dt_min, cfg.dt_max)
    else:
        nu_total = cfg.nu + jnp.mean(nu_t) + cfg.artificial_viscosity
        # 2D explicit diffusion requires dt <= h²/(4ν); the reference's 0.4
        # factor (v5.py:324) exceeds it and relies on its dt_max clamp.
        # Use a safe 0.2.
        dt_visc = 0.2 * h * h / nu_total
        dt = jnp.clip(jnp.minimum(dt_cfl, dt_visc), cfg.dt_min, cfg.dt_max)
    if cfg.warmup_steps > 0:
        dt = jnp.where(step < cfg.warmup_steps, jnp.float32(cfg.warmup_dt), dt)
    return dt.astype(jnp.float32)


def _cleanup_divergence(u, v, dx, dy, iters: int):
    """Extra projection sweeps after the corrector (parity: reference
    ``clean_divergence_fast`` v5.py:239-257 — φ persists across sweeps,
    each sweep does one Jacobi update then subtracts ∇φ)."""
    ax, ay = 1.0 / (dx * dx), 1.0 / (dy * dy)
    denom_inv = 1.0 / (2.0 * (ax + ay))
    phi = jnp.zeros_like(u)
    for _ in range(iters):
        div = divergence(u, v, dx, dy)
        s = ax * (phi[1:-1, 2:] + phi[1:-1, :-2]) + ay * (
            phi[2:, 1:-1] + phi[:-2, 1:-1]
        )
        phi = phi.at[1:-1, 1:-1].set((s - div[1:-1, 1:-1]) * denom_inv)
        gx, gy = gradient(phi, dx, dy)
        u = u - gx
        v = v - gy
    return u, v


def make_step(
    cfg: IncompressibleConfig,
    bc_fn: Callable,
    solid_mask: Optional[jax.Array] = None,
    ibm_mask: Optional[jax.Array] = None,
    forcing: Optional[tuple] = None,
) -> Callable:
    """Build the jitted single-step function for a given case.

    ``bc_fn(u, v, step, t) -> (u, v)`` applies the case's velocity BCs as
    edge writes; ``ibm_mask`` enables penalization forcing inside embedded
    bodies; ``forcing`` is an optional (fx, fy) body-force pair.

    Returns ``step(state, cfl_scale) -> (state, StepMetrics)``.
    """
    g = cfg.grid
    dx, dy = g.dx, g.dy
    if cfg.poisson.dct_variant == "auto":
        # pin the autotuned DCT variant NOW (eager): tuning launches its
        # own jitted chains, which cannot run from inside the traced step
        import dataclasses as _dc

        from cfdsim_tpu.solvers.autotune import resolve_poisson_config

        cfg = _dc.replace(cfg, poisson=resolve_poisson_config(
            cfg.poisson, (g.ny, g.nx), dx, dy))
    if cfg.storage not in ("fp32", "bf16"):
        raise ValueError(f"unknown storage {cfg.storage!r}")
    pois_mask = solid_mask if (cfg.masked_poisson and solid_mask is not None) else None

    def step(state: IncompressibleState, cfl_scale) -> tuple:
        u, v, p = state.u, state.v, state.p
        if cfg.storage == "bf16":
            # bandwidth experiment (VERDICT r4 #3): velocities live in
            # bf16 between steps; upcast once, compute fp32 throughout
            u = u.astype(jnp.float32)
            v = v.astype(jnp.float32)

        # --- LES eddy viscosity (v5.py:385-391)
        if cfg.use_les:
            nu_t = smagorinsky_viscosity(u, v, dx, dy, cfg.smagorinsky_constant)
        else:
            nu_t = jnp.zeros_like(u)
        nu_eff = cfg.nu + nu_t + cfg.artificial_viscosity

        dt = _adaptive_dt(cfg, u, v, nu_t, state.step, cfl_scale)

        # --- convection (v5.py:392-399)
        # (convection and the explicit update share the "predictor" scope,
        # so a profiler trace attributes their fusions to one stage)
        with jax.named_scope("predictor"):
            if cfg.scheme in ("supg", "supg_refparity"):
                tau = supg_tau(u, v, dx, dy, dt, nu_eff)
                parity = cfg.scheme == "supg_refparity"
                conv_u = convection_supg(u, v, u, dx, dy, tau, ref_parity=parity)
                conv_v = convection_supg(u, v, v, dx, dy, tau, ref_parity=parity)
            elif cfg.scheme == "upwind":
                conv_u = convection_upwind(u, v, u, dx, dy)
                conv_v = convection_upwind(u, v, v, dx, dy)
            elif cfg.scheme == "tvd":
                conv_u = convection_tvd(u, v, u, dx, dy)
                conv_v = convection_tvd(u, v, v, dx, dy)
            elif cfg.scheme == "central":
                conv_u = convection_central(u, v, u, dx, dy)
                conv_v = convection_central(u, v, v, dx, dy)
            else:
                raise ValueError(f"unknown scheme {cfg.scheme!r}")

        # --- diffusion + predictor (v5.py:400-403)
        if cfg.diffusion == "implicit":
            # backward-Euler viscous step (the reference's Julia FEM
            # capability, v1.jl:130-167): (I − dt ν_eff ∇²) u* = u − dt·conv.
            bu = u - dt * conv_u
            bv = v - dt * conv_v
            if forcing is not None:
                bu = bu + dt * forcing[0]
                bv = bv + dt * forcing[1]
            use_dst = cfg.implicit_solver == "dst" or (
                cfg.implicit_solver == "auto" and not cfg.use_les
            )
            if use_dst:
                # exact solve: the Dirichlet-frame Helmholtz operator is
                # diagonal in the 2D DST-I basis (solvers/helmholtz.py) —
                # no iteration error, unlike the Jacobi path below
                from cfdsim_tpu.solvers.helmholtz import solve_helmholtz_dirichlet

                if cfg.use_les:
                    raise ValueError(
                        "implicit_solver='dst' needs scalar viscosity; "
                        "use 'jacobi' with LES"
                    )
                coeff = dt * (cfg.nu + cfg.artificial_viscosity)
                bu, bv = bc_fn(bu, bv, state.step, state.t)
                u_star = solve_helmholtz_dirichlet(bu, coeff, dx, dy)
                v_star = solve_helmholtz_dirichlet(bv, coeff, dx, dy)
                u_star, v_star = bc_fn(u_star, v_star, state.step, state.t)
            else:
                # damped Jacobi, matrix-free, BCs re-imposed each iteration
                # (diagonally dominant: converges in ~10 sweeps)
                ax = 1.0 / (dx * dx)
                ay = 1.0 / (dy * dy)
                coeff = dt * nu_eff
                denom_inv = 1.0 / (1.0 + 2.0 * (ax + ay) * coeff)

                def nb(q):
                    s = ax * (q[1:-1, 2:] + q[1:-1, :-2]) + ay * (
                        q[2:, 1:-1] + q[:-2, 1:-1]
                    )
                    return jnp.pad(s, ((1, 1), (1, 1)))

                def helmholtz_iter(_, uv):
                    us, vs = uv
                    us = (bu + coeff * nb(us)) * denom_inv
                    vs = (bv + coeff * nb(vs)) * denom_inv
                    return bc_fn(us, vs, state.step, state.t)

                u_star, v_star = jax.lax.fori_loop(
                    0, cfg.implicit_iters, helmholtz_iter,
                    bc_fn(bu, bv, state.step, state.t),
                )
        else:
            with jax.named_scope("predictor"):
                lap_u = laplacian_coeff(u, dx, dy, nu_eff)
                lap_v = laplacian_coeff(v, dx, dy, nu_eff)
                u_star = u + dt * (lap_u - conv_u)
                v_star = v + dt * (lap_v - conv_v)
                if forcing is not None:
                    u_star = u_star + dt * forcing[0]
                    v_star = v_star + dt * forcing[1]
            u_star, v_star = bc_fn(u_star, v_star, state.step, state.t)

        # --- IBM on the predictor (v5.py:405-407). The damped momentum is
        # the penalization force on the body (drag/lift), accumulated over
        # both IBM applications.
        fx_sum = fy_sum = jnp.float32(0.0)
        if ibm_mask is not None:
            strength = ibm_ramp(state.step, cfg.ibm_ramp_steps)
            u_pre, v_pre = u_star, v_star
            u_star, v_star = apply_ibm(u_star, v_star, ibm_mask, strength)
            if cfg.compute_metrics:
                fx_sum = fx_sum + jnp.sum(u_pre - u_star)
                fy_sum = fy_sum + jnp.sum(v_pre - v_star)

        # --- pressure projection (v5.py:409-417)
        div_star = divergence(u_star, v_star, dx, dy)
        rhs = div_star / dt
        if cfg.poisson.bc == "neumann" and cfg.poisson.method not in ("dct", "fft"):
            # solvability of the pure-Neumann problem; the direct solvers
            # discard the k=0 mode in-spectrum, so the two extra HBM passes
            # here would be redundant for them
            rhs = rhs - jnp.mean(rhs)
        phi = solve_poisson(p, rhs, dx, dy, cfg.poisson, solid_mask=pois_mask)
        gx, gy = gradient(phi, dx, dy)
        u_new = u_star - dt * gx
        v_new = v_star - dt * gy

        # --- divergence cleanup + re-BC + re-IBM (v5.py:419-425)
        if cfg.cleanup_iters > 0:
            u_new, v_new = _cleanup_divergence(u_new, v_new, dx, dy, cfg.cleanup_iters)
        u_new, v_new = bc_fn(u_new, v_new, state.step, state.t)
        if ibm_mask is not None:
            u_pre2, v_pre2 = u_new, v_new
            u_new, v_new = apply_ibm(u_new, v_new, ibm_mask, strength)
            if cfg.compute_metrics:
                fx_sum = fx_sum + jnp.sum(u_pre2 - u_new)
                fy_sum = fy_sum + jnp.sum(v_pre2 - v_new)

        # --- clipping (v5.py:437-438)
        u_new = jnp.clip(u_new, -cfg.max_velocity, cfg.max_velocity)
        v_new = jnp.clip(v_new, -cfg.max_velocity, cfg.max_velocity)

        u_out, v_out = u_new, v_new
        if cfg.storage == "bf16":
            u_out = u_new.astype(jnp.bfloat16)
            v_out = v_new.astype(jnp.bfloat16)
        new_state = IncompressibleState(
            u=u_out,
            v=v_out,
            p=phi,
            t=state.t + dt,
            step=state.step + 1,
        )

        # --- on-device diagnostics (v5.py:410-435 log lines). The post-
        # projection divergence is measured away from a 2-node boundary
        # frame: BC discontinuities (e.g. the driven-lid corners) create a
        # pointwise divergence spike there that says nothing about the
        # quality of the projection.
        if cfg.compute_metrics:
            div_post = divergence(u_new, v_new, dx, dy)
            imask = interior_mask(div_post.shape, width=2)
            vort = curl(u_new, v_new, dx, dy)
            metrics = StepMetrics(
                dt=dt,
                div_pre=jnp.max(jnp.abs(div_star)),
                div_post=jnp.max(jnp.abs(div_post) * imask),
                max_vel=jnp.maximum(
                    jnp.max(jnp.abs(u_new)), jnp.max(jnp.abs(v_new))
                ),
                energy=jnp.mean(0.5 * (u_new * u_new + v_new * v_new)),
                vort_max=jnp.max(jnp.abs(vort)),
                poisson_res=poisson_residual(
                    phi, rhs, dx, dy, pois_mask, cfg.poisson.bc
                ),
                fx=fx_sum * (dx * dy) / dt,
                fy=fy_sum * (dx * dy) / dt,
            )
        else:
            zero = jnp.float32(0.0)
            metrics = StepMetrics(dt, zero, zero, zero, zero, zero, zero)
        return new_state, metrics

    return step


def make_chunk(cfg: IncompressibleConfig, step_fn: Callable, n_steps: int):
    """Roll ``n_steps`` into one jitted ``lax.scan`` — the whole-run-on-device
    idiom replacing the reference's per-step Python loop (v5.py:653)."""

    def chunk(state, cfl_scale):
        def body(s, _):
            return step_fn(s, cfl_scale)

        return jax.lax.scan(body, state, None, length=n_steps)

    return jax.jit(chunk, donate_argnums=(0,))
