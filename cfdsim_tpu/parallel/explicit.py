"""Fully explicit shard_map NS step: every halo exchange, boundary write,
and reduction hand-placed.

The GSPMD path (``make_sharded_step``) lets XLA insert the collectives;
this module is the manual counterpart — the template for custom comm
scheduling at scale. Inside one ``shard_map`` over the ("y","x") mesh, a
full Chorin projection step runs on local blocks:

- stencils: ``lax.ppermute`` halo exchange per application (ghost-cell
  swaps between devices — the reference's NG ghost layout, cavity_flow_v1.py:
  258-262, made inter-chip), zero-frame semantics restored with a
  global-interior mask; width-2 halos + global edge clamps for the TVD
  scheme's 5-point faces;
- BCs: edge writes guarded by ``lax.axis_index`` so only boundary shards
  touch their global edges;
- pressure: distributed red-black SOR with per-color halo exchange and
  globally correct checkerboard ordering (``sharded.rbsor_local``),
  optionally masked (φ frozen in solids, reference v5.py:213);
- reductions (adaptive dt, rhs mean, metrics): local reduce + ``psum``/
  ``pmax`` over both mesh axes.

The step is option-for-option equal to ``models.incompressible.make_step``
— every scheme (central/upwind/tvd/supg/supg_refparity), LES, implicit
diffusion (both the damped-Jacobi path and the exact DST Helmholtz, the
latter via the pencil-decomposed distributed transform in
``parallel/transforms.py``), divergence cleanup, IBM damping, masked
Poisson, and the full metrics set including vort_max and poisson_res —
and matches the single-device step exactly (verified in
tests/test_explicit_step.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from cfdsim_tpu.models.incompressible import (
    IncompressibleConfig,
    IncompressibleState,
    StepMetrics,
)
from cfdsim_tpu.ops.convection import (
    convection_central,
    convection_supg,
    convection_tvd,
    convection_upwind,
)
from cfdsim_tpu.ops.les import smagorinsky_viscosity
from cfdsim_tpu.ops.stencil import curl, divergence, gradient, laplacian_coeff
from cfdsim_tpu.parallel.halo import (
    clamp_global_edges,
    global_interior_mask,
    halo_exchange,
)
from cfdsim_tpu.parallel.sharded import rbsor_local

AXES = ("y", "x")


def _pmax(x):
    return lax.pmax(lax.pmax(x, "y"), "x")


def _psum(x):
    return lax.psum(lax.psum(x, "y"), "x")


def make_explicit_step(
    cfg: IncompressibleConfig,
    mesh: Mesh,
    bc_builder,
    use_ibm: bool = False,
    needs_y: bool = False,
):
    """Build the generic explicit-comm step.

    ``bc_builder(state, y_b, iy, ix, py, px) -> bc(u, v) -> (u, v)``
    returns the local BC closure (global-edge writes guarded by the shard
    indices). The returned step signature grows with the enabled extras:

        step(state, cfl_scale[, ibm_b][, y_b][, fluid_b])

    - ``ibm_b``: P("y","x")-sharded Gaussian-shell mask (``use_ibm``)
    - ``y_b``: P("y")-sharded global y-coordinate vector (``needs_y``)
    - ``fluid_b``: P("y","x")-sharded fluid mask (``cfg.masked_poisson``)
    """
    g = cfg.grid
    dx, dy = g.dx, g.dy
    ax, ay = 1.0 / (dx * dx), 1.0 / (dy * dy)
    py = mesh.shape["y"]
    px = mesh.shape["x"]
    n_global = float(g.nx * g.ny)
    # the distributed DST needs pencil-splittable local blocks; under
    # implicit_solver="auto" fall back to Jacobi when they are not (an
    # explicit "dst" request still surfaces the pencil error)
    _pencil_ok = (g.ny // py) % max(px, 1) == 0 and (g.nx // px) % max(py, 1) == 0
    spec = P("y", "x")
    state_spec = IncompressibleState(u=spec, v=spec, p=spec, t=P(), step=P())
    metric_spec = StepMetrics(*([P()] * len(StepMetrics._fields)))

    in_specs = [state_spec, P()]
    if use_ibm:
        in_specs.append(spec)
    if needs_y:
        in_specs.append(P("y"))
    if cfg.masked_poisson:
        in_specs.append(spec)

    def stencil(op, *fields, width: int = 1, clamp: bool = False):
        """Lift a zero-frame stencil op onto halo-exchanged local blocks.
        ``clamp`` replicates the op's internal edge-mode padding at global
        boundaries (needed by the TVD scheme's limited slopes)."""
        padded = [halo_exchange(f, py, px, width=width) for f in fields]
        if clamp:
            padded = [clamp_global_edges(p_, width=width) for p_ in padded]
        out = op(*padded)
        outs = out if isinstance(out, tuple) else (out,)
        mask = global_interior_mask(fields[0].shape, width=1)
        w = width
        cropped = tuple(jnp.where(mask, o[w:-w, w:-w], 0.0) for o in outs)
        return cropped if isinstance(out, tuple) else cropped[0]

    def local_supg_tau(u, v, dt, nu_eff):
        """supg_tau is pointwise with a zero global frame — no halo needed
        (parity: ops/convection.py supg_tau / reference v5.py:149-162)."""
        h = min(dx, dy)
        vel = jnp.sqrt(u * u + v * v)
        pe = vel * h / (nu_eff + 1e-10)
        tau_flow = h / (2.0 * jnp.maximum(vel, 1e-10)) * jnp.minimum(1.0, pe / 2.0)
        tau = jnp.where(vel > 1e-10, tau_flow, dt / 2.0)
        return jnp.where(global_interior_mask(u.shape, width=1), tau, 0.0)

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(state_spec, metric_spec),
    )
    def step(state: IncompressibleState, cfl_scale, *extras):
        u, v, p = state.u, state.v, state.p
        k = 0
        ibm_b = None
        y_b = None
        fluid_b = None
        if use_ibm:
            ibm_b = extras[k]
            k += 1
        if needs_y:
            y_b = extras[k]
            k += 1
        if cfg.masked_poisson:
            fluid_b = jnp.logical_not(extras[k].astype(bool))
            k += 1

        iy = lax.axis_index("y")
        ix = lax.axis_index("x")
        bc = bc_builder(state, y_b, iy, ix, py, px)

        # --- LES eddy viscosity (v5.py:385-391)
        if cfg.use_les:
            nu_t = stencil(
                lambda a, b: smagorinsky_viscosity(
                    a, b, dx, dy, cfg.smagorinsky_constant
                ),
                u, v,
            )
        else:
            nu_t = jnp.zeros_like(u)
        nu_eff = cfg.nu + nu_t + cfg.artificial_viscosity

        # --- adaptive dt (v5.py:316-326; reductions over the mesh)
        if cfg.adaptive_dt:
            vel_max = _pmax(
                jnp.maximum(jnp.max(jnp.abs(u)), jnp.max(jnp.abs(v)))
            )
            vel_max = jnp.maximum(vel_max, 1e-10)
            h = min(dx, dy)
            dt_cfl = cfg.cfl_target * cfl_scale * h / vel_max
            if cfg.diffusion == "implicit":
                dt = jnp.clip(dt_cfl, cfg.dt_min, cfg.dt_max)
            else:
                nu_total = (
                    cfg.nu + _psum(jnp.sum(nu_t)) / n_global
                    + cfg.artificial_viscosity
                )
                dt_visc = 0.2 * h * h / nu_total
                dt = jnp.clip(
                    jnp.minimum(dt_cfl, dt_visc), cfg.dt_min, cfg.dt_max
                )
            if cfg.warmup_steps > 0:
                dt = jnp.where(
                    state.step < cfg.warmup_steps, jnp.float32(cfg.warmup_dt), dt
                )
            dt = dt.astype(jnp.float32)
        else:
            dt = jnp.float32(cfg.dt_base)

        # --- convection (v5.py:392-399)
        if cfg.scheme in ("supg", "supg_refparity"):
            tau = local_supg_tau(u, v, dt, nu_eff)
            parity = cfg.scheme == "supg_refparity"
            conv_u = stencil(
                lambda a, b, c, t_: convection_supg(
                    a, b, c, dx, dy, t_, ref_parity=parity
                ),
                u, v, u, tau,
            )
            conv_v = stencil(
                lambda a, b, c, t_: convection_supg(
                    a, b, c, dx, dy, t_, ref_parity=parity
                ),
                u, v, v, tau,
            )
        elif cfg.scheme == "upwind":
            conv_u = stencil(lambda a, b, c: convection_upwind(a, b, c, dx, dy), u, v, u)
            conv_v = stencil(lambda a, b, c: convection_upwind(a, b, c, dx, dy), u, v, v)
        elif cfg.scheme == "tvd":
            # width-2 halos with clamped global edges replicate the
            # single-device op's internal edge-mode slope padding
            conv_u = stencil(
                lambda a, b, c: convection_tvd(a, b, c, dx, dy),
                u, v, u, width=2, clamp=True,
            )
            conv_v = stencil(
                lambda a, b, c: convection_tvd(a, b, c, dx, dy),
                u, v, v, width=2, clamp=True,
            )
        elif cfg.scheme == "central":
            conv_u = stencil(lambda a, b, c: convection_central(a, b, c, dx, dy), u, v, u)
            conv_v = stencil(lambda a, b, c: convection_central(a, b, c, dx, dy), u, v, v)
        else:
            raise ValueError(f"unknown scheme {cfg.scheme!r}")

        # --- diffusion + predictor (v5.py:400-403)
        use_dst = cfg.diffusion == "implicit" and (
            cfg.implicit_solver == "dst"
            or (cfg.implicit_solver == "auto" and not cfg.use_les
                and _pencil_ok)
        )
        if use_dst:
            # exact distributed Dirichlet Helmholtz: pencil-decomposed
            # DST-I over the mesh (parallel/transforms.py) — the same
            # dispatch the single-device step makes (incompressible.py
            # implicit_solver="dst"/"auto")
            from cfdsim_tpu.parallel.transforms import dst_helmholtz_local

            if cfg.use_les:
                raise ValueError(
                    "implicit_solver='dst' needs scalar viscosity; "
                    "use 'jacobi' with LES"
                )
            bu = u - dt * conv_u
            bv = v - dt * conv_v
            coeff = dt * (cfg.nu + cfg.artificial_viscosity)
            bu, bv = bc(bu, bv)
            u_star = dst_helmholtz_local(bu, coeff, dx, dy, py, px)
            v_star = dst_helmholtz_local(bv, coeff, dx, dy, py, px)
            u_star, v_star = bc(u_star, v_star)
        elif cfg.diffusion == "implicit":
            bu = u - dt * conv_u
            bv = v - dt * conv_v
            coeff = dt * nu_eff
            denom_inv = 1.0 / (1.0 + 2.0 * (ax + ay) * coeff)

            def nb(q):
                qp = halo_exchange(q, py, px, width=1)
                s = ax * (qp[1:-1, 2:] + qp[1:-1, :-2]) + ay * (
                    qp[2:, 1:-1] + qp[:-2, 1:-1]
                )
                return jnp.where(
                    global_interior_mask(q.shape, width=1), s, 0.0
                )

            def helmholtz_iter(_, uv):
                us, vs = uv
                us = (bu + coeff * nb(us)) * denom_inv
                vs = (bv + coeff * nb(vs)) * denom_inv
                return bc(us, vs)

            u_star, v_star = lax.fori_loop(
                0, cfg.implicit_iters, helmholtz_iter, bc(bu, bv)
            )
        else:
            lap_u = stencil(lambda a, n_: laplacian_coeff(a, dx, dy, n_), u, nu_eff)
            lap_v = stencil(lambda a, n_: laplacian_coeff(a, dx, dy, n_), v, nu_eff)
            u_star = u + dt * (lap_u - conv_u)
            v_star = v + dt * (lap_v - conv_v)
            u_star, v_star = bc(u_star, v_star)

        # --- IBM on the predictor (v5.py:405-407)
        if use_ibm:
            strength = (
                jnp.minimum(
                    1.0, state.step.astype(jnp.float32) / cfg.ibm_ramp_steps
                )
                if cfg.ibm_ramp_steps > 0
                else jnp.float32(1.0)
            )
            damp = 1.0 - ibm_b * strength
            u_star = u_star * damp
            v_star = v_star * damp

        # --- pressure projection (v5.py:409-417)
        div_star = stencil(lambda a, b: divergence(a, b, dx, dy), u_star, v_star)
        rhs = div_star / dt
        rhs = rhs - _psum(jnp.sum(rhs)) / n_global  # Neumann solvability
        phi = rbsor_local(
            p, rhs, py, px, ax, ay, cfg.poisson.iters, cfg.poisson.omega,
            fluid_b=fluid_b,
        )
        gx, gy = stencil(lambda a: gradient(a, dx, dy), phi)
        u_new = u_star - dt * gx
        v_new = v_star - dt * gy

        # --- divergence cleanup (v5.py:239-257: φ persists across sweeps)
        if cfg.cleanup_iters > 0:
            clean_denom = 1.0 / (2.0 * (ax + ay))
            cphi = jnp.zeros_like(u_new)
            for _ in range(cfg.cleanup_iters):
                cdiv = stencil(lambda a, b: divergence(a, b, dx, dy), u_new, v_new)
                # zero-frame Jacobi update (single-device _cleanup uses a
                # zero boundary frame: the non-circular halo already
                # delivers zeros at global edges)
                cp = halo_exchange(cphi, py, px, width=1)
                s = ax * (cp[1:-1, 2:] + cp[1:-1, :-2]) + ay * (
                    cp[2:, 1:-1] + cp[:-2, 1:-1]
                )
                cphi = jnp.where(
                    global_interior_mask(cphi.shape, width=1),
                    (s - cdiv) * clean_denom,
                    0.0,
                )
                cgx, cgy = stencil(lambda a: gradient(a, dx, dy), cphi)
                u_new = u_new - cgx
                v_new = v_new - cgy

        u_new, v_new = bc(u_new, v_new)
        if use_ibm:
            u_new = u_new * damp
            v_new = v_new * damp

        u_new = jnp.clip(u_new, -cfg.max_velocity, cfg.max_velocity)
        v_new = jnp.clip(v_new, -cfg.max_velocity, cfg.max_velocity)

        new_state = IncompressibleState(
            u=u_new, v=v_new, p=phi, t=state.t + dt, step=state.step + 1
        )

        # --- metrics (full parity with make_step, incl. vort/poisson_res)
        if cfg.compute_metrics:
            div_post = stencil(lambda a, b: divergence(a, b, dx, dy), u_new, v_new)
            imask = global_interior_mask(u_new.shape, width=2)
            vort = stencil(lambda a, b: curl(a, b, dx, dy), u_new, v_new)
            # poisson_res: |lap_neumann(phi) − rhs| over fluid nodes
            pp = clamp_global_edges(halo_exchange(phi, py, px, width=1), width=1)
            lap_n = (
                ax * (pp[1:-1, 2:] + pp[1:-1, :-2])
                + ay * (pp[2:, 1:-1] + pp[:-2, 1:-1])
                - 2.0 * (ax + ay) * phi
            )
            res = jnp.abs(lap_n - rhs)
            if fluid_b is not None:
                res = jnp.where(fluid_b, res, 0.0)
            metrics = StepMetrics(
                dt=dt,
                div_pre=_pmax(jnp.max(jnp.abs(div_star))),
                div_post=_pmax(jnp.max(jnp.where(imask, jnp.abs(div_post), 0.0))),
                max_vel=_pmax(
                    jnp.maximum(jnp.max(jnp.abs(u_new)), jnp.max(jnp.abs(v_new)))
                ),
                energy=_psum(jnp.sum(0.5 * (u_new**2 + v_new**2))) / n_global,
                vort_max=_pmax(jnp.max(jnp.abs(vort))),
                poisson_res=_pmax(jnp.max(res)),
            )
        else:
            zero = jnp.float32(0.0)
            metrics = StepMetrics(dt, zero, zero, zero, zero, zero, zero)
        return new_state, metrics

    return step


def make_cavity_explicit_step(cfg: IncompressibleConfig, mesh: Mesh,
                              lid_velocity: float = 1.0):
    """Explicit-comm step for the lid-driven cavity. Poisson sweeps come
    from ``cfg.poisson.iters``/``omega`` (method must be "rbsor")."""
    assert cfg.poisson.method == "rbsor", "explicit step uses distributed rbsor"

    def bc_builder(state, y_b, iy, ix, py, px):
        def bc(u, v):
            u = jnp.where(ix == 0, u.at[:, 0].set(0.0), u)
            u = jnp.where(ix == px - 1, u.at[:, -1].set(0.0), u)
            u = jnp.where(iy == 0, u.at[0, :].set(0.0), u)
            u = jnp.where(iy == py - 1, u.at[-1, :].set(lid_velocity), u)
            v = jnp.where(ix == 0, v.at[:, 0].set(0.0), v)
            v = jnp.where(ix == px - 1, v.at[:, -1].set(0.0), v)
            v = jnp.where(iy == 0, v.at[0, :].set(0.0), v)
            v = jnp.where(iy == py - 1, v.at[-1, :].set(0.0), v)
            return u, v

        return bc

    return make_explicit_step(cfg, mesh, bc_builder)


def make_cylinder_explicit_step(cfg: IncompressibleConfig, mesh: Mesh,
                                ibm_mask=None, v_inf: float = 1.0,
                                perturb_amp: float = 0.01,
                                perturb_ramp_steps: int = 1000):
    """Explicit-comm step for the IBM cylinder case (any cfg.scheme, LES,
    implicit diffusion, cleanup, masked Poisson — full make_step parity).

    Call as ``step(state, cfl_scale, ibm_block, y_block[, solid_block])``
    with the global (ny, nx) Gaussian-shell mask sharded P("y","x"), the
    global y-coordinate vector sharded P("y"), and — iff
    ``cfg.masked_poisson`` — the solid mask sharded P("y","x").
    """
    assert cfg.poisson.method == "rbsor", "explicit step uses distributed rbsor"
    del ibm_mask  # the mask is passed at call time as a sharded block
    g = cfg.grid

    def bc_builder(state, y_b, iy, ix, py, px):
        def bc(uu, vv):
            # inflow perturbation ramp (reference v5.py:349-360) on x_lo
            scale = (
                jnp.minimum(1.0, state.step / perturb_ramp_steps) * perturb_amp
            )
            pert = scale * jnp.sin(
                2.0 * jnp.pi * y_b / g.y_max + 0.02 * state.step
            )
            uu = jnp.where(ix == 0, uu.at[:, 0].set(v_inf * (1.0 + pert)), uu)
            vv = jnp.where(ix == 0, vv.at[:, 0].set(0.0), vv)
            uu = jnp.where(ix == px - 1, uu.at[:, -1].set(uu[:, -2]), uu)
            vv = jnp.where(ix == px - 1, vv.at[:, -1].set(vv[:, -2]), vv)
            uu = jnp.where(iy == 0, uu.at[0, :].set(0.0), uu)
            uu = jnp.where(iy == py - 1, uu.at[-1, :].set(0.0), uu)
            vv = jnp.where(iy == 0, vv.at[0, :].set(0.0), vv)
            vv = jnp.where(iy == py - 1, vv.at[-1, :].set(0.0), vv)
            return uu, vv

        return bc

    return make_explicit_step(cfg, mesh, bc_builder, use_ibm=True, needs_y=True)
