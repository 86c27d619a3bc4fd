"""3D incompressible MAC solver on stretched (tensor-product) grids.

Completes the solver matrix: {2D, 3D} × {uniform, wall-clustered}. This is
the 3D member of the stretched tier (models/mac_stretched.py is 2D): face
velocities on a nonuniform tensor-product grid, conservative advection
in divergence form with metric-weighted interpolants (central, or
upwind / van-Leer-MUSCL donor values on the nonuniform metrics —
``scheme``), flux-form diffusion, and the *exact* pressure projection
via the 3D
fast-diagonalization method (solvers/fdm.py make_fdm_solver_3d — six dense
matmuls, the stretched analog of the 3D DCT). Boundary-layer clustering in
3D is the capability the reference's gmsh/FEM path was meant for
(v1.jl:24-97), kept structured.

Layout matches models/mac3d.py: u (nz, ny, nx+1), v (nz, ny+1, nx),
w (nz+1, ny, nx), p (nz, ny, nx); lid at z_hi moving in +x for the cavity
BCs. With uniform face spacing the step reduces to the mac3d central step
(asserted in tests/test_stretched3d.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp
import numpy as np
from jax import lax

from cfdsim_tpu.models.incompressible import StepMetrics
from cfdsim_tpu.models.mac3d import MAC3DBCs, MAC3DState, cavity3d_bcs
from cfdsim_tpu.models.mac_stretched import _limited_gradient, _metrics
from cfdsim_tpu.solvers.fdm import make_fdm_solver_3d


def _muscl_axis(q, inv_sp, d_lo, d_hi, axis: int, tvd: bool):
    """(q_lo, q_hi) MUSCL donor values at the targets between consecutive
    samples of ``q`` along ``axis`` on a nonuniform grid: van-Leer
    limited gradients from the one-sided divided differences (inv_sp =
    1/gap per sample interval), advanced by the donor→target distances
    d_lo/d_hi; tvd=False returns the plain donor samples (1st-order
    upwind). The 3D habitat of mac_stretched.py's per-direction blocks;
    on uniform spacing reduces exactly to mac._face_value's q ± σ/2."""
    n = q.shape[axis]
    lo = lax.slice_in_dim(q, 0, n - 1, axis=axis)
    hi = lax.slice_in_dim(q, 1, n, axis=axis)
    if not tvd:
        return lo, hi
    dq = (hi - lo) * inv_sp
    m = dq.shape[axis]
    g = _limited_gradient(
        lax.slice_in_dim(dq, 0, m - 1, axis=axis),
        lax.slice_in_dim(dq, 1, m, axis=axis),
    )
    pads = [(0, 0)] * q.ndim
    pads[axis] = (1, 1)
    g = jnp.pad(g, pads)  # zero gradient at the end samples
    glo = lax.slice_in_dim(g, 0, n - 1, axis=axis)
    ghi = lax.slice_in_dim(g, 1, n, axis=axis)
    return lo + glo * d_lo, hi - ghi * d_hi


def smagorinsky_viscosity_stretched3d(
    u, v, w, ghosts, inv_hx, inv_hy, inv_hz, inv_dfx, inv_dfy, inv_dfz,
    cs2_delta2,
):
    """ν_t = (C_s Δ)²|S| at cell centers on stretched metrics — the
    nonuniform habitat of mac3d.smagorinsky_viscosity_mac3d (reference
    LES physics v5.py:96-110): Δ is the *local* (hx hy hz)^{1/3}
    (``cs2_delta2`` = (C_s Δ_ijk)² precomputed), normal strains use cell
    widths, the three shear sums use the ghost-extended center gaps
    (inv_df*) on their natural edge sets and are 0.5/0.5-averaged back
    to centers — exactly the uniform recipe when h = const (tested)."""
    u_gy, u_gz, v_gx, v_gz, w_gx, w_gy = ghosts
    sxx = (u[:, :, 1:] - u[:, :, :-1]) * inv_hx
    syy = (v[:, 1:, :] - v[:, :-1, :]) * inv_hy
    szz = (w[1:] - w[:-1]) * inv_hz

    def to_c(e, ax1, ax2):
        lo1 = lax.slice_in_dim(e, 0, e.shape[ax1] - 1, axis=ax1)
        hi1 = lax.slice_in_dim(e, 1, e.shape[ax1], axis=ax1)
        s = 0.5 * (lo1 + hi1)
        lo2 = lax.slice_in_dim(s, 0, s.shape[ax2] - 1, axis=ax2)
        hi2 = lax.slice_in_dim(s, 1, s.shape[ax2], axis=ax2)
        return 0.5 * (lo2 + hi2)

    sh_xy = (u_gy[:, 1:, :] - u_gy[:, :-1, :]) * inv_dfy + (
        v_gx[:, :, 1:] - v_gx[:, :, :-1]
    ) * inv_dfx
    sh_xz = (u_gz[1:] - u_gz[:-1]) * inv_dfz + (
        w_gx[:, :, 1:] - w_gx[:, :, :-1]
    ) * inv_dfx
    sh_yz = (v_gz[1:] - v_gz[:-1]) * inv_dfz + (
        w_gy[:, 1:, :] - w_gy[:, :-1, :]
    ) * inv_dfy
    s2 = (
        2.0 * (sxx * sxx + syy * syy + szz * szz)
        + to_c(sh_xy * sh_xy, 1, 2)
        + to_c(sh_xz * sh_xz, 0, 2)
        + to_c(sh_yz * sh_yz, 0, 1)
    )
    return cs2_delta2 * jnp.sqrt(s2)


def _diffuse_les_stretched3d(
    u, v, w, ghosts, nu_eff_c,
    inv_hx, inv_hy, inv_hz, inv_dcx, inv_dcy, inv_dcz,
    inv_dfx, inv_dfy, inv_dfz,
):
    """Flux-form variable-ν diffusion ∇·(ν_eff ∇·) on interior faces on
    the stretched metrics (the nonuniform mac3d._diffuse_les3d): ν_eff
    at cell centers; cross-derivative fluxes use the 0.25 four-point
    edge average of the edge-clamp-padded ν (the same average the
    uniform step uses, so uniform faces reproduce it exactly). With
    constant ν this reduces to ν × the constant-ν metric Laplacian."""
    u_gy, u_gz, v_gx, v_gz, w_gx, w_gy = ghosts
    nu_e = jnp.pad(nu_eff_c, 1, mode="edge")
    nu_xy = 0.25 * (
        nu_e[1:-1, :-1, :-1] + nu_e[1:-1, :-1, 1:]
        + nu_e[1:-1, 1:, :-1] + nu_e[1:-1, 1:, 1:]
    )  # (nz, ny+1, nx+1) z-edges
    nu_xz = 0.25 * (
        nu_e[:-1, 1:-1, :-1] + nu_e[:-1, 1:-1, 1:]
        + nu_e[1:, 1:-1, :-1] + nu_e[1:, 1:-1, 1:]
    )  # (nz+1, ny, nx+1) y-edges
    nu_yz = 0.25 * (
        nu_e[:-1, :-1, 1:-1] + nu_e[:-1, 1:, 1:-1]
        + nu_e[1:, :-1, 1:-1] + nu_e[1:, 1:, 1:-1]
    )  # (nz+1, ny+1, nx) x-edges

    # u-momentum, interior faces (nz, ny, nx-1)
    fux = nu_eff_c * (u[:, :, 1:] - u[:, :, :-1]) * inv_hx
    fuy = nu_xy * (u_gy[:, 1:, :] - u_gy[:, :-1, :]) * inv_dfy
    fuz = nu_xz * (u_gz[1:] - u_gz[:-1]) * inv_dfz
    lap_u = (
        (fux[:, :, 1:] - fux[:, :, :-1]) * inv_dcx
        + (fuy[:, 1:, 1:-1] - fuy[:, :-1, 1:-1]) * inv_hy
        + (fuz[1:, :, 1:-1] - fuz[:-1, :, 1:-1]) * inv_hz
    )
    # v-momentum, interior faces (nz, ny-1, nx)
    fvy = nu_eff_c * (v[:, 1:, :] - v[:, :-1, :]) * inv_hy
    fvx = nu_xy * (v_gx[:, :, 1:] - v_gx[:, :, :-1]) * inv_dfx
    fvz = nu_yz * (v_gz[1:] - v_gz[:-1]) * inv_dfz
    lap_v = (
        (fvx[:, 1:-1, 1:] - fvx[:, 1:-1, :-1]) * inv_hx
        + (fvy[:, 1:, :] - fvy[:, :-1, :]) * inv_dcy
        + (fvz[1:, 1:-1, :] - fvz[:-1, 1:-1, :]) * inv_hz
    )
    # w-momentum, interior faces (nz-1, ny, nx)
    fwz = nu_eff_c * (w[1:] - w[:-1]) * inv_hz
    fwx = nu_xz * (w_gx[:, :, 1:] - w_gx[:, :, :-1]) * inv_dfx
    fwy = nu_yz * (w_gy[:, 1:, :] - w_gy[:, :-1, :]) * inv_dfy
    lap_w = (
        (fwx[1:-1, :, 1:] - fwx[1:-1, :, :-1]) * inv_hx
        + (fwy[1:-1, 1:, :] - fwy[1:-1, :-1, :]) * inv_hy
        + (fwz[1:] - fwz[:-1]) * inv_dcz
    )
    return lap_u, lap_v, lap_w


@dataclasses.dataclass(frozen=True)
class StretchedMAC3DConfig:
    nx: int
    ny: int
    nz: int
    nu: float
    scheme: str = "central"  # central | upwind | tvd (van Leer MUSCL)
    # Smagorinsky LES with the local filter width Δ = (hx hy hz)^{1/3}
    # — the stretched-grid habitat of mac3d's LES (VERDICT r2 item 2);
    # variable-ν diffusion runs in flux form on the metric gaps
    use_les: bool = False
    smagorinsky_constant: float = 0.17
    # "smagorinsky" (static C_s) or "dynamic" (Germano–Lilly with the
    # local Δ² inside the identity and IBM-body cells masked out of
    # the contraction — ops/les_dynamic.dynamic_cs2_3d)
    les_model: str = "smagorinsky"
    # "chorin" or "incremental" (see mac.MACConfig.projection)
    projection: str = "chorin"
    # "euler" or "rk2" (Heun with a projection per stage — see
    # mac.MACConfig.time_scheme)
    time_scheme: str = "euler"
    adaptive_dt: bool = True
    cfl_target: float = 0.4
    dt_base: float = 1e-3
    dt_min: float = 1e-7
    dt_max: float = 1.0
    max_velocity: float = 1e3
    compute_metrics: bool = True


def init_state(cfg: StretchedMAC3DConfig) -> MAC3DState:
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    return MAC3DState(
        u=jnp.zeros((nz, ny, nx + 1), jnp.float32),
        v=jnp.zeros((nz, ny + 1, nx), jnp.float32),
        w=jnp.zeros((nz + 1, ny, nx), jnp.float32),
        p=jnp.zeros((nz, ny, nx), jnp.float32),
        t=jnp.float32(0.0),
        step=jnp.int32(0),
    )


def make_step(
    cfg: StretchedMAC3DConfig,
    bcs: MAC3DBCs,
    x_faces,
    y_faces,
    z_faces,
    ibm_mask_u=None,
    ibm_mask_v=None,
    ibm_mask_w=None,
    ibm_ramp_steps: int = 0,
    moving_body=None,
    ibm_ghost=None,
    moving_scheme: str = "penalize",
) -> Callable:
    """Build ``step(state, cfl_scale) -> (state, StepMetrics)`` on the
    stretched grid defined by the three face-coordinate vectors.

    ``ibm_mask_{u,v,w}`` are face-sampled penalization masks
    (ibm.sphere_masks_faces on the same face vectors); the body force
    reported in the metrics is the volume-weighted momentum sink
    F = Σ Δu·V_face/dt (per unit density), V_face the staggered control
    volume — the nonuniform analog of mac3d.make_step's IBM block.
    ``moving_body`` (ibm.MovingBody3D): moving-geometry IBM on the
    stretched metrics — sharp masks rebuilt on device with a taper
    width of the minimum spacing, penalization toward u_b(t),
    volume-weighted forces.
    ``ibm_ghost`` (ibm_ghost.GhostIBM3D): the sharp-interface
    ghost-cell direct-forcing alternative to the penalization masks —
    second-order wall placement at the exact body surface (the LES
    wall treatment for under-resolved boundary layers; mutually
    exclusive with ibm_mask_*). Forces use the same Σ Δu·V/dt
    momentum-exchange accounting. ``moving_scheme="ghost"`` upgrades
    ``moving_body`` to the same treatment with on-device per-stage
    stencil rebuild (searchsorted probe lookup on the nonuniform
    metrics, ibm_ghost.moving_ghost_forcing_3d_nonuniform)."""
    if ibm_ghost is not None and ibm_mask_u is not None:
        raise ValueError("ibm_ghost and ibm_mask_* are mutually exclusive")
    if moving_scheme not in ("penalize", "ghost"):
        raise ValueError(f"unknown moving_scheme {moving_scheme!r}")
    mx = _metrics(x_faces)
    my = _metrics(y_faces)
    mz = _metrics(z_faces)
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    assert len(mx.h) == nx and len(my.h) == ny and len(mz.h) == nz

    f32 = lambda a: jnp.asarray(a, jnp.float32)
    # broadcastable metric constants: axis order (z, y, x)
    inv_hx = f32(1.0 / mx.h)[None, None, :]          # (1,1,nx) cell widths
    inv_hy = f32(1.0 / my.h)[None, :, None]
    inv_hz = f32(1.0 / mz.h)[:, None, None]
    inv_dcx = f32(1.0 / mx.dc)[None, None, :]        # (1,1,nx-1) interior faces
    inv_dcy = f32(1.0 / my.dc)[None, :, None]
    inv_dcz = f32(1.0 / mz.dc)[:, None, None]
    inv_dfx = f32(1.0 / mx.dfull)[None, None, :]     # (1,1,nx+1) incl. ghosts
    inv_dfy = f32(1.0 / my.dfull)[None, :, None]
    inv_dfz = f32(1.0 / mz.dfull)[:, None, None]
    # interior-face interpolation weights (ghost faces use 0.5)
    wfx = f32(np.concatenate([[0.5], mx.wf, [0.5]]))[None, None, :]  # (1,1,nx+1)
    wfy = f32(np.concatenate([[0.5], my.wf, [0.5]]))[None, :, None]
    wfz = f32(np.concatenate([[0.5], mz.wf, [0.5]]))[:, None, None]
    h_min = float(min(mx.h.min(), my.h.min(), mz.h.min()))
    if cfg.use_les:
        delta2 = f32(
            (mz.h[:, None, None] * my.h[None, :, None]
             * mx.h[None, None, :]) ** (2.0 / 3.0)
        )
        if cfg.les_model == "dynamic":
            # Germano–Lilly on the stretched metrics: dimensionless
            # C_s² from the volume-averaged Lilly quotient (local Δ²
            # inside both M terms; index-space test filter), then
            # ν_t = C_s²·Δ²(x)·|S| through the same staggered strain
            # the static model uses (ops/les_dynamic.py)
            from cfdsim_tpu.ops.les_dynamic import (
                dynamic_cs2_3d,
                ibm_fluid_mask_centers,
            )

            if moving_body is not None:
                raise ValueError(
                    "les_model='dynamic' does not support moving_body "
                    "yet (the Germano contraction needs the body "
                    "masked per step); use les_model='smagorinsky'"
                )

            def _g2(xc):
                xg = np.concatenate([[xc[0]], xc, [xc[-1]]])
                return 1.0 / (xg[2:] - xg[:-2])

            inv_g2x = f32(_g2(mx.xc))[None, None, :]
            inv_g2y = f32(_g2(my.xc))[None, :, None]
            inv_g2z = f32(_g2(mz.xc))[:, None, None]
            fluid_mask = ibm_fluid_mask_centers(
                ibm_mask_u, ibm_mask_v, ibm_mask_w, ibm_ghost
            )

            def nu_turb(u, v, w, ghosts):
                uc = 0.5 * (u[:, :, 1:] + u[:, :, :-1])
                vc = 0.5 * (v[:, 1:, :] + v[:, :-1, :])
                wc = 0.5 * (w[1:] + w[:-1])
                cs2 = dynamic_cs2_3d(
                    uc, vc, wc, inv_g2x, inv_g2y, inv_g2z, delta2,
                    mask=fluid_mask,
                )
                return cs2 * smagorinsky_viscosity_stretched3d(
                    u, v, w, ghosts, inv_hx, inv_hy, inv_hz,
                    inv_dfx, inv_dfy, inv_dfz, delta2,
                )
        else:
            cs2_delta2 = cfg.smagorinsky_constant ** 2 * delta2

            def nu_turb(u, v, w, ghosts):
                return smagorinsky_viscosity_stretched3d(
                    u, v, w, ghosts, inv_hx, inv_hy, inv_hz,
                    inv_dfx, inv_dfy, inv_dfz, cs2_delta2,
                )

    if cfg.scheme not in ("central", "upwind", "tvd"):
        raise ValueError(f"unknown stretched-3D scheme {cfg.scheme!r}")
    if cfg.les_model not in ("smagorinsky", "dynamic"):
        raise ValueError(f"unknown les_model {cfg.les_model!r}")
    if cfg.time_scheme not in ("euler", "rk2"):
        raise ValueError(f"unknown time scheme {cfg.time_scheme!r}")
    tvd = cfg.scheme == "tvd"
    # donor→target distances for the MUSCL reconstructions (numpy once):
    # *_c = face-sample arrays advected to cell centers; *_f = ghost-
    # extended center-sample arrays advected to faces
    xf, yf, zf = (np.asarray(a) for a in (x_faces, y_faces, z_faces))
    xg = np.concatenate([[mx.xc[0] - mx.h[0]], mx.xc, [mx.xc[-1] + mx.h[-1]]])
    yg = np.concatenate([[my.xc[0] - my.h[0]], my.xc, [my.xc[-1] + my.h[-1]]])
    zg = np.concatenate([[mz.xc[0] - mz.h[0]], mz.xc, [mz.xc[-1] + mz.h[-1]]])
    bx = lambda a: f32(a)[None, None, :]
    by = lambda a: f32(a)[None, :, None]
    bz = lambda a: f32(a)[:, None, None]
    dxl_c, dxr_c = bx(mx.xc - xf[:-1]), bx(xf[1:] - mx.xc)
    dyl_c, dyr_c = by(my.xc - yf[:-1]), by(yf[1:] - my.xc)
    dzl_c, dzr_c = bz(mz.xc - zf[:-1]), bz(zf[1:] - mz.xc)
    dxl_f, dxr_f = bx(xf - xg[:-1]), bx(xg[1:] - xf)
    dyl_f, dyr_f = by(yf - yg[:-1]), by(yg[1:] - yf)
    dzl_f, dzr_f = bz(zf - zg[:-1]), bz(zg[1:] - zf)

    solve_p = make_fdm_solver_3d(mx.h, my.h, mz.h)

    if (ibm_mask_u is not None or moving_body is not None
            or ibm_ghost is not None):
        # staggered control volumes for the penalization force
        cv_u = f32(
            mz.h[:, None, None] * my.h[None, :, None]
            * mx.dfull[None, None, :]
        )
        cv_v = f32(
            mz.h[:, None, None] * my.dfull[None, :, None]
            * mx.h[None, None, :]
        )
        cv_w = f32(
            mz.dfull[:, None, None] * my.h[None, :, None]
            * mx.h[None, None, :]
        )

    if moving_body is not None:
        def _face_coords(face_axis):
            xs = xf if face_axis == 0 else mx.xc
            ys = yf if face_axis == 1 else my.xc
            zs = zf if face_axis == 2 else mz.xc
            Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
            return (f32(X), f32(Y), f32(Z))

        XU, YU, ZU = _face_coords(0)
        XV, YV, ZV = _face_coords(1)
        XW, YW, ZW = _face_coords(2)

        def body_masks(t):
            cx, cy, cz = moving_body.center(t)
            r = moving_body.radius

            def m(X, Y, Z):
                d = jnp.sqrt(
                    (X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2
                )
                return jnp.clip((r + 0.5 * h_min - d) / h_min, 0.0, 1.0)

            return m(XU, YU, ZU), m(XV, YV, ZV), m(XW, YW, ZW)

    def step(state: MAC3DState, cfl_scale):
        u, v, w = bcs.set_normal(state.u, state.v, state.w)

        if cfg.use_les:
            nu_stab = cfg.nu + jnp.mean(
                nu_turb(u, v, w, bcs.ghosts(u, v, w))
            )
        else:
            nu_stab = cfg.nu
        if cfg.adaptive_dt:
            vel_max = jnp.maximum(
                jnp.maximum(jnp.max(jnp.abs(u)), jnp.max(jnp.abs(v))),
                jnp.maximum(jnp.max(jnp.abs(w)), 1e-10),
            )
            dt_cfl = cfg.cfl_target * cfl_scale * h_min / vel_max
            dt_visc = 0.125 * h_min * h_min / nu_stab
            dt = jnp.clip(
                jnp.minimum(dt_cfl, dt_visc), cfg.dt_min, cfg.dt_max
            ).astype(jnp.float32)
        else:
            dt = jnp.float32(cfg.dt_base)

        def stage(u, v, w, p_warm, t_s):
            """One projected Euler stage (mac3d.make_step stage
            pattern on the stretched metrics)."""
            u_gy, u_gz, v_gx, v_gz, w_gx, w_gy = bcs.ghosts(u, v, w)

            # --- edge interpolants with metric weights (mac3d.py uses 0.5;
            # on a stretched grid the interior-face weight is wf toward the
            # higher-index sample, ghosts stay 0.5 — the tangential ghost sits
            # mirrored at the first cell width)
            u_y = (1.0 - wfy) * u_gy[:, :-1, :] + wfy * u_gy[:, 1:, :]
            v_x = (1.0 - wfx) * v_gx[:, :, :-1] + wfx * v_gx[:, :, 1:]
            u_z = (1.0 - wfz) * u_gz[:-1] + wfz * u_gz[1:]
            w_x = (1.0 - wfx) * w_gx[:, :, :-1] + wfx * w_gx[:, :, 1:]
            v_z = (1.0 - wfz) * v_gz[:-1] + wfz * v_gz[1:]
            w_y = (1.0 - wfy) * w_gy[:, :-1, :] + wfy * w_gy[:, 1:, :]
            uc = 0.5 * (u[:, :, :-1] + u[:, :, 1:])
            vc = 0.5 * (v[:, :-1, :] + v[:, 1:, :])
            wc = 0.5 * (w[:-1] + w[1:])

            # --- conservative fluxes (divergence form; each momentum flux
            # divided by its control-volume extent in the sweep direction).
            # central: symmetric interpolants; upwind/tvd: MUSCL donor
            # values on the nonuniform metrics (mac_stretched.py pattern)
            if cfg.scheme == "central":
                F_u = uc * uc
                G_u = v_x * u_y
                H_u = w_x * u_z
                F_v = u_y * v_x
                G_v = vc * vc
                H_v = w_y * v_z
                F_w = u_z * w_x
                G_w = v_z * w_y
                H_w = wc * wc
            else:

                def upw(adv, lo_hi):
                    lo, hi = lo_hi
                    return jnp.where(adv >= 0.0, lo, hi)

                F_u = uc * upw(uc, _muscl_axis(u, inv_hx, dxl_c, dxr_c, 2, tvd))
                G_u = v_x * upw(
                    v_x, _muscl_axis(u_gy, inv_dfy, dyl_f, dyr_f, 1, tvd)
                )
                H_u = w_x * upw(
                    w_x, _muscl_axis(u_gz, inv_dfz, dzl_f, dzr_f, 0, tvd)
                )
                F_v = u_y * upw(
                    u_y, _muscl_axis(v_gx, inv_dfx, dxl_f, dxr_f, 2, tvd)
                )
                G_v = vc * upw(vc, _muscl_axis(v, inv_hy, dyl_c, dyr_c, 1, tvd))
                H_v = w_y * upw(
                    w_y, _muscl_axis(v_gz, inv_dfz, dzl_f, dzr_f, 0, tvd)
                )
                F_w = u_z * upw(
                    u_z, _muscl_axis(w_gx, inv_dfx, dxl_f, dxr_f, 2, tvd)
                )
                G_w = v_z * upw(
                    v_z, _muscl_axis(w_gy, inv_dfy, dyl_f, dyr_f, 1, tvd)
                )
                H_w = wc * upw(wc, _muscl_axis(w, inv_hz, dzl_c, dzr_c, 0, tvd))
            conv_u = (
                (F_u[:, :, 1:] - F_u[:, :, :-1]) * inv_dcx
                + (G_u[:, 1:, 1:-1] - G_u[:, :-1, 1:-1]) * inv_hy
                + (H_u[1:, :, 1:-1] - H_u[:-1, :, 1:-1]) * inv_hz
            )
            conv_v = (
                (F_v[:, 1:-1, 1:] - F_v[:, 1:-1, :-1]) * inv_hx
                + (G_v[:, 1:, :] - G_v[:, :-1, :]) * inv_dcy
                + (H_v[1:, 1:-1, :] - H_v[:-1, 1:-1, :]) * inv_hz
            )
            conv_w = (
                (F_w[1:-1, :, 1:] - F_w[1:-1, :, :-1]) * inv_hx
                + (G_w[1:-1, 1:, :] - G_w[1:-1, :-1, :]) * inv_hy
                + (H_w[1:, :, :] - H_w[:-1, :, :]) * inv_dcz
            )

            # --- flux-form diffusion on interior faces:
            # u-momentum: d/dx(du/dx)/dcx + d/dy(du/dy)/hy + d/dz(du/dz)/hz
            dux = (u[:, :, 1:] - u[:, :, :-1]) * inv_hx          # at centers
            lap_u_x = (dux[:, :, 1:] - dux[:, :, :-1]) * inv_dcx
            duy = (u_gy[:, 1:, :] - u_gy[:, :-1, :]) * inv_dfy   # at y-faces
            lap_u_y = (duy[:, 1:, 1:-1] - duy[:, :-1, 1:-1]) * inv_hy
            duz = (u_gz[1:] - u_gz[:-1]) * inv_dfz               # at z-faces
            lap_u_z = (duz[1:, :, 1:-1] - duz[:-1, :, 1:-1]) * inv_hz
            lap_u = lap_u_x + lap_u_y + lap_u_z

            dvy = (v[:, 1:, :] - v[:, :-1, :]) * inv_hy
            lap_v_y = (dvy[:, 1:, :] - dvy[:, :-1, :]) * inv_dcy
            dvx = (v_gx[:, :, 1:] - v_gx[:, :, :-1]) * inv_dfx
            lap_v_x = (dvx[:, 1:-1, 1:] - dvx[:, 1:-1, :-1]) * inv_hx
            dvz = (v_gz[1:] - v_gz[:-1]) * inv_dfz
            lap_v_z = (dvz[1:, 1:-1, :] - dvz[:-1, 1:-1, :]) * inv_hz
            lap_v = lap_v_x + lap_v_y + lap_v_z

            dwz = (w[1:] - w[:-1]) * inv_hz
            lap_w_z = (dwz[1:] - dwz[:-1]) * inv_dcz
            dwx = (w_gx[:, :, 1:] - w_gx[:, :, :-1]) * inv_dfx
            lap_w_x = (dwx[1:-1, :, 1:] - dwx[1:-1, :, :-1]) * inv_hx
            dwy = (w_gy[:, 1:, :] - w_gy[:, :-1, :]) * inv_dfy
            lap_w_y = (dwy[1:-1, 1:, :] - dwy[1:-1, :-1, :]) * inv_hy
            lap_w = lap_w_x + lap_w_y + lap_w_z

            visc_u = cfg.nu * lap_u
            visc_v = cfg.nu * lap_v
            visc_w = cfg.nu * lap_w
            if cfg.use_les:
                # replace the molecular fluxes entirely: the variable-ν
                # flux-form diffusion with ν_eff = ν + ν_t (the lap_*
                # above become the ν_t=0 special case; kept separate so
                # the no-LES path pays no ν interpolation)
                ghosts = (u_gy, u_gz, v_gx, v_gz, w_gx, w_gy)
                nu_eff_c = cfg.nu + nu_turb(u, v, w, ghosts)
                visc_u, visc_v, visc_w = _diffuse_les_stretched3d(
                    u, v, w, ghosts, nu_eff_c,
                    inv_hx, inv_hy, inv_hz, inv_dcx, inv_dcy, inv_dcz,
                    inv_dfx, inv_dfy, inv_dfz,
                )

            u_star = u.at[:, :, 1:-1].add(dt * (visc_u - conv_u))
            v_star = v.at[:, 1:-1, :].add(dt * (visc_v - conv_v))
            w_star = w.at[1:-1].add(dt * (visc_w - conv_w))
            if cfg.projection == "incremental":
                u_star = u_star.at[:, :, 1:-1].add(
                    -dt * (p_warm[:, :, 1:] - p_warm[:, :, :-1]) * inv_dcx
                )
                v_star = v_star.at[:, 1:-1, :].add(
                    -dt * (p_warm[:, 1:, :] - p_warm[:, :-1, :]) * inv_dcy
                )
                w_star = w_star.at[1:-1].add(
                    -dt * (p_warm[1:] - p_warm[:-1]) * inv_dcz
                )
            u_star, v_star, w_star = bcs.set_normal(u_star, v_star, w_star)

            fx = fy = fz = jnp.float32(0.0)
            if ibm_mask_u is not None:
                from cfdsim_tpu.ibm import ibm_ramp

                strength = ibm_ramp(state.step, ibm_ramp_steps)
                du_ibm = u_star * (strength * ibm_mask_u)
                dv_ibm = v_star * (strength * ibm_mask_v)
                dw_ibm = w_star * (strength * ibm_mask_w)
                u_star = u_star - du_ibm
                v_star = v_star - dv_ibm
                w_star = w_star - dw_ibm
                if cfg.compute_metrics:
                    fx = jnp.sum(du_ibm * cv_u) / dt
                    fy = jnp.sum(dv_ibm * cv_v) / dt
                    fz = jnp.sum(dw_ibm * cv_w) / dt

            if ibm_ghost is not None:
                from cfdsim_tpu.ibm import ibm_ramp
                from cfdsim_tpu.ibm_ghost import apply_ghost_forcing

                strength = ibm_ramp(state.step, ibm_ramp_steps)
                u_star, du_g = apply_ghost_forcing(
                    u_star, ibm_ghost.u, strength
                )
                v_star, dv_g = apply_ghost_forcing(
                    v_star, ibm_ghost.v, strength
                )
                w_star, dw_g = apply_ghost_forcing(
                    w_star, ibm_ghost.w, strength
                )
                if cfg.compute_metrics:
                    fx = jnp.sum(du_g * cv_u) / dt
                    fy = jnp.sum(dv_g * cv_v) / dt
                    fz = jnp.sum(dw_g * cv_w) / dt

            if moving_body is not None:
                from cfdsim_tpu.ibm import ibm_ramp

                ub, vb, wb = moving_body.velocity(t_s)
                strength = ibm_ramp(state.step, ibm_ramp_steps)
                if moving_scheme == "ghost":
                    from cfdsim_tpu.ibm_ghost import (
                        moving_ghost_forcing_3d_nonuniform,
                    )

                    ctr = moving_body.center(t_s)
                    r = moving_body.radius
                    delta = 1.5 * h_min
                    u_star, du_mb = moving_ghost_forcing_3d_nonuniform(
                        u_star, XU, YU, ZU, xf, my.xc, mz.xc, ctr, r,
                        delta, ub, strength,
                    )
                    v_star, dv_mb = moving_ghost_forcing_3d_nonuniform(
                        v_star, XV, YV, ZV, mx.xc, yf, mz.xc, ctr, r,
                        delta, vb, strength,
                    )
                    w_star, dw_mb = moving_ghost_forcing_3d_nonuniform(
                        w_star, XW, YW, ZW, mx.xc, my.xc, zf, ctr, r,
                        delta, wb, strength,
                    )
                else:
                    m_u, m_v, m_w = body_masks(t_s)
                    du_mb = (u_star - ub) * (strength * m_u)
                    dv_mb = (v_star - vb) * (strength * m_v)
                    dw_mb = (w_star - wb) * (strength * m_w)
                    u_star = u_star - du_mb
                    v_star = v_star - dv_mb
                    w_star = w_star - dw_mb
                if cfg.compute_metrics:
                    fx = fx + jnp.sum(du_mb * cv_u) / dt
                    fy = fy + jnp.sum(dv_mb * cv_v) / dt
                    fz = fz + jnp.sum(dw_mb * cv_w) / dt

            # --- exact projection (FV divergence / center-gap gradient pair)
            div_star = (
                (u_star[:, :, 1:] - u_star[:, :, :-1]) * inv_hx
                + (v_star[:, 1:, :] - v_star[:, :-1, :]) * inv_hy
                + (w_star[1:] - w_star[:-1]) * inv_hz
            )
            phi = solve_p(div_star / dt)
            u_new = u_star.at[:, :, 1:-1].add(
                -dt * (phi[:, :, 1:] - phi[:, :, :-1]) * inv_dcx
            )
            v_new = v_star.at[:, 1:-1, :].add(
                -dt * (phi[:, 1:, :] - phi[:, :-1, :]) * inv_dcy
            )
            w_new = w_star.at[1:-1].add(-dt * (phi[1:] - phi[:-1]) * inv_dcz)
            u_new, v_new, w_new = bcs.set_normal(u_new, v_new, w_new)
            u_new = jnp.clip(u_new, -cfg.max_velocity, cfg.max_velocity)
            v_new = jnp.clip(v_new, -cfg.max_velocity, cfg.max_velocity)
            w_new = jnp.clip(w_new, -cfg.max_velocity, cfg.max_velocity)
            if cfg.projection == "incremental":
                phi = p_warm + phi
            return u_new, v_new, w_new, phi, (fx, fy, fz, div_star)

        u_new, v_new, w_new, phi, (fx, fy, fz, div_star) = stage(
            u, v, w, state.p, state.t
        )
        if cfg.time_scheme == "rk2":
            # Heun: average with a second projected Euler stage (both
            # solenoidal ⇒ so is the average)
            u2, v2, w2, phi2, (fx2, fy2, fz2, div_star) = stage(
                u_new, v_new, w_new, phi, state.t + dt
            )
            u_new = 0.5 * (u + u2)
            v_new = 0.5 * (v + v2)
            w_new = 0.5 * (w + w2)
            u_new, v_new, w_new = bcs.set_normal(u_new, v_new, w_new)
            phi = 0.5 * (phi + phi2)
            fx = 0.5 * (fx + fx2)
            fy = 0.5 * (fy + fy2)
            fz = 0.5 * (fz + fz2)

        new_state = MAC3DState(
            u=u_new, v=v_new, w=w_new, p=phi,
            t=state.t + dt, step=state.step + 1,
        )

        if cfg.compute_metrics:
            div_post = (
                (u_new[:, :, 1:] - u_new[:, :, :-1]) * inv_hx
                + (v_new[:, 1:, :] - v_new[:, :-1, :]) * inv_hy
                + (w_new[1:] - w_new[:-1]) * inv_hz
            )
            ucc = 0.5 * (u_new[:, :, :-1] + u_new[:, :, 1:])
            vcc = 0.5 * (v_new[:, :-1, :] + v_new[:, 1:, :])
            wcc = 0.5 * (w_new[:-1] + w_new[1:])
            vol_w = f32(
                mz.h[:, None, None] * my.h[None, :, None] * mx.h[None, None, :]
            )
            vol = float(np.sum(mz.h) * np.sum(my.h) * np.sum(mx.h))
            dwdy = ((w_new[:, 1:, :] - w_new[:, :-1, :]) * inv_dcy)[1:-1]
            dvdz = ((v_new[1:] - v_new[:-1]) * inv_dcz)[:, 1:-1, :]
            metrics = StepMetrics(
                dt=dt,
                div_pre=jnp.max(jnp.abs(div_star)),
                div_post=jnp.max(jnp.abs(div_post)),
                max_vel=jnp.maximum(
                    jnp.maximum(jnp.max(jnp.abs(u_new)), jnp.max(jnp.abs(v_new))),
                    jnp.max(jnp.abs(w_new)),
                ),
                energy=jnp.sum(
                    vol_w * 0.5 * (ucc * ucc + vcc * vcc + wcc * wcc)
                ) / vol,
                vort_max=jnp.max(jnp.abs(dwdy - dvdz)),
                poisson_res=jnp.float32(0.0),  # FDM is exact
                fx=fx,
                fy=fy,
                fz=fz,
            )
        else:
            zero = jnp.float32(0.0)
            metrics = StepMetrics(dt, zero, zero, zero, zero, zero, zero)
        return new_state, metrics

    return step


__all__ = [
    "StretchedMAC3DConfig",
    "smagorinsky_viscosity_stretched3d",
    "MAC3DState",
    "cavity3d_bcs",
    "init_state",
    "make_step",
]
