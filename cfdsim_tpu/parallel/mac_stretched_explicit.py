"""Explicit shard_map step for the *stretched* MAC solver.

The multi-chip path for the boundary-layer-refinement tier
(models/mac_stretched.py): trimmed-state blocks + ppermute halos exactly
as in ``parallel/mac_explicit.py``, with every metric coefficient (cell
widths, center gaps, donor distances, corner interpolation weights)
looked up per position from the global per-axis vectors by *global index*
(``jnp.take`` on trace-time constants — the vectors are tiny, and the
indices are iota-based so XLA lowers them to slices). The pressure
projection stays exact across the mesh via the distributed
fast-diagonalization solve (``transforms.make_fdm_poisson_local``, dense
eigenbasis matmuls on locally-complete pencil axes → matmul work + six
all_to_alls).

Equality with the single-device ``mac_stretched.make_step`` on an
8-device mesh is asserted in tests/test_mac_explicit.py (stretched
section).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from cfdsim_tpu.models.incompressible import StepMetrics
from cfdsim_tpu.models.mac import MACState
from cfdsim_tpu.models.mac_stretched import StretchedMACConfig, _metrics
from cfdsim_tpu.ops.limiters import vanleer_slope
from cfdsim_tpu.parallel.halo import halo_exchange
from cfdsim_tpu.parallel.mac_explicit import (
    MACLocalBCs,
    _grids,
    _pmax,
    _psum,
    cavity_mac_local_bcs,
)
from cfdsim_tpu.parallel.transforms import make_fdm_poisson_local


_PAD = 4


def _lut(vec, axis: int):
    """Per-axis metric lookup as a dynamic 1D slice of an edge-padded
    global vector, broadcast over the other axis.

    Every lookup index in the step is affine in the local iota (a global
    offset plus the row/col position), so a gather is never needed — and
    gathers inside shard_map MISCOMPILE on this jax/XLA CPU build (values
    come back as uninitialized-memory garbage once the graph is large;
    the same class of backend bug as the GSPMD uneven-shape xfails).
    ``at(start, length)`` returns vec[start : start+length] (global
    indices, clamped at the ends by the edge padding) shaped (length, 1)
    for axis 0 or (1, length) for axis 1."""
    v = np.asarray(vec, np.float32)
    vp = jnp.asarray(np.pad(v, _PAD, mode="edge"))

    def at(start, length: int):
        s = lax.dynamic_slice(vp, (start + _PAD,), (length,))
        return s[:, None] if axis == 0 else s[None, :]

    return at


def make_stretched_mac_explicit_step(
    cfg: StretchedMACConfig,
    mesh: Mesh,
    bcs: MACLocalBCs,
    x_faces,
    y_faces,
    use_ibm: bool = False,
    ibm_ramp_steps: int = 0,
    moving_body=None,
    moving_scheme: str = "penalize",
    moving_ghost_halo: int = 5,
):
    """Build the explicit-comm stretched-MAC step on the trimmed
    representation: ``step(tstate, cfl_scale[, mask_u_t, mask_v_t])``
    on P("y","x")-sharded (ny, nx) blocks.

    ``moving_body`` (ibm.MovingBody) enables the sharded moving-geometry
    IBM on the stretched metrics: sharp face masks rebuilt per step from
    per-axis coordinate LUT slices (``_lut`` — dynamic slices, never
    gathers, per the shard_map backend-bug rules) with the h_min taper,
    penalization toward u_b(t), volume-weighted psum'd forces — the
    stretched habitat of mac_explicit's moving_body.

    ``moving_scheme="ghost"`` upgrades the moving body to the sharded
    sharp-interface moving ghost (the Dütsch KC=5 quality tier,
    ibm_ghost_explicit.moving_ghost_forcing_2d_nonuniform_local): the
    full coordinate vectors ride into the shard_map as replicated ARGS
    for the searchsorted corner lookup, probe gathers run through
    width-``moving_ghost_halo`` halo windows (default 5 covers
    δ = 1.5·h_min probes for a body in the refined region — the
    standing moving-body convention)."""
    mx = _metrics(x_faces)
    my = _metrics(y_faces)
    nx, ny = cfg.nx, cfg.ny
    py = mesh.shape["y"]
    px = mesh.shape["x"]
    ny_l, nx_l = ny // py, nx // px
    if ny % py or nx % px:
        raise ValueError(f"grid {ny}x{nx} not divisible by mesh {py}x{px}")
    if ny_l < 4 or nx_l < 4:
        raise ValueError("local blocks must be at least 4x4 for width-2 halos")
    if getattr(cfg, "time_scheme", "euler") != "euler":
        raise ValueError(
            "the explicit sharded stretched step implements "
            "time_scheme='euler'"
        )
    if getattr(cfg, "projection", "chorin") != "chorin":
        raise ValueError("the explicit sharded step implements projection='chorin'")

    # --- metric lookups (global-index slices → coefficient lines)
    inv_hx = _lut(1.0 / mx.h, 1)           # by cell col
    inv_hy = _lut(1.0 / my.h, 0)           # by cell row
    # center gap across interior face/row-face g = dc[g−1]
    inv_dcx = _lut(1.0 / mx.dc, 1)
    inv_dcy = _lut(1.0 / my.dc, 0)
    # donor-to-donor gaps incl. ghost gaps: dfull[k] = gap(sample k−1, k)
    inv_dfx = _lut(1.0 / mx.dfull, 1)
    inv_dfy = _lut(1.0 / my.dfull, 0)
    # corner interpolation weight toward the higher-index sample
    wcx = _lut(np.concatenate([[0.5], mx.wf, [0.5]]), 1)   # by corner col
    wcy = _lut(np.concatenate([[0.5], my.wf, [0.5]]), 0)   # by corner row
    # TVD donor distances
    xf = np.asarray(x_faces, np.float64)
    yf = np.asarray(y_faces, np.float64)
    dxl_c = _lut(mx.xc - xf[:-1], 1)       # face i → center i, by cell
    dxr_c = _lut(xf[1:] - mx.xc, 1)
    dyl_c = _lut(my.xc - yf[:-1], 0)       # by cell row
    dyr_c = _lut(yf[1:] - my.xc, 0)
    ygd = np.concatenate([[my.xc[0] - my.h[0]], my.xc, [my.xc[-1] + my.h[-1]]])
    dyl_k = _lut(yf - ygd[:-1], 0)   # lower u-row donor → y-face, by corner row
    dyr_k = _lut(ygd[1:] - yf, 0)
    xgd = np.concatenate([[mx.xc[0] - mx.h[0]], mx.xc, [mx.xc[-1] + mx.h[-1]]])
    dxl_k = _lut(xf - xgd[:-1], 1)         # by corner col
    dxr_k = _lut(xgd[1:] - xf, 1)
    h_min = float(min(mx.h.min(), my.h.min()))
    area_u = _lut(mx.dfull, 1)             # u-face control width, by face
    area_v = _lut(my.dfull, 0)             # v-face control height, by row-face
    hx_at = _lut(mx.h, 1)
    hy_at = _lut(my.h, 0)
    vol = float(np.sum(my.h) * np.sum(mx.h))

    if moving_body is not None:
        # face-coordinate lookups (global-index slices, h_min taper —
        # models/mac_stretched.py body_masks on the trimmed layout)
        xf_at = _lut(xf, 1)            # u-face x, by face col
        yc_at = _lut(my.xc, 0)         # u-face y, by cell row
        xc_at = _lut(mx.xc, 1)         # v-face x, by cell col
        yf_at = _lut(yf, 0)            # v-face y, by row face

        def _mb_masks(gy0, gx0, t):
            cx, cy = moving_body.center(t)
            r = moving_body.radius
            du = jnp.sqrt((xf_at(gx0, nx_l) - cx) ** 2
                          + (yc_at(gy0, ny_l) - cy) ** 2)
            dv = jnp.sqrt((xc_at(gx0, nx_l) - cx) ** 2
                          + (yf_at(gy0, ny_l) - cy) ** 2)
            m_u = jnp.clip((r + 0.5 * h_min - du) / h_min, 0.0, 1.0)
            m_v = jnp.clip((r + 0.5 * h_min - dv) / h_min, 0.0, 1.0)
            return m_u, m_v

    if moving_scheme not in ("penalize", "ghost"):
        raise ValueError(f"unknown moving_scheme {moving_scheme!r}")
    use_mg = moving_body is not None and moving_scheme == "ghost"
    if use_mg:
        _mg_delta = 1.5 * h_min  # = models/mac_stretched.py's δ
        _mg_width = int(moving_ghost_halo)
        if _mg_width >= min(ny_l, nx_l):
            raise ValueError(
                f"moving-ghost halo width {_mg_width} needs local "
                f"blocks > {_mg_width}; got {ny_l}x{nx_l}"
            )
        # full sample-coordinate vectors — shard_map ARGS (replicated)
        # for the searchsorted corner lookup, fp32 exactly as the
        # single-device moving_ghost_forcing_2d_nonuniform casts them
        _mg_vecs = (
            jnp.asarray(xf, jnp.float32),      # u-face x (nx+1,)
            jnp.asarray(my.xc, jnp.float32),   # u-face y (ny,)
            jnp.asarray(mx.xc, jnp.float32),   # v-face x (nx,)
            jnp.asarray(yf, jnp.float32),      # v-face y (ny+1,)
        )

    solve_p = make_fdm_poisson_local(mx.h, my.h, py, px)

    spec = P("y", "x")
    state_spec = MACState(u=spec, v=spec, p=spec, t=P(), step=P())
    metric_spec = StepMetrics(*([P()] * len(StepMetrics._fields)))
    in_specs = [state_spec, P()]
    if use_ibm:
        in_specs += [spec, spec]
    if use_mg:
        in_specs += [(P(), P(), P(), P())]

    def step_local(tstate: MACState, cfl_scale, *extras):
        iy = lax.axis_index("y")
        ix = lax.axis_index("x")
        gy0 = iy * ny_l
        gx0 = ix * nx_l
        gr0, gc0 = _grids((ny_l, nx_l), iy, ix, ny_l, nx_l, 0)

        def set_normal(u_t, v_t):
            u_t, v_t = bcs.pre(u_t, v_t, gc0, gr0, tstate)
            a = bcs.aux(u_t, v_t, gc0, gr0, tstate)
            return u_t, v_t, a

        def pad(u_t, v_t, a, w: int):
            U = halo_exchange(u_t, py, px, width=w)
            V = halo_exchange(v_t, py, px, width=w)
            grU, gfU = _grids(U.shape, iy, ix, ny_l, nx_l, w)
            grV, gcV = _grids(V.shape, iy, ix, ny_l, nx_l, w)
            U = bcs.post_u(U, grU, gfU, tstate, a)
            V = bcs.post_v(V, grV, gcV, tstate, a)
            return U, V, (grU, gfU, grV, gcV)

        u_t, v_t, a = set_normal(tstate.u, tstate.v)
        U, V, (grU, gfU, grV, gcV) = pad(u_t, v_t, a, w=2)
        real_u = (grU >= 0) & (grU < ny) & (gfU >= 0) & (gfU <= nx)
        real_v = (grV >= 0) & (grV <= ny) & (gcV >= 0) & (gcV < nx)

        # --- adaptive dt (mac_stretched.adaptive_dt)
        if cfg.adaptive_dt:
            vel_max = _pmax(
                jnp.maximum(
                    jnp.max(jnp.where(real_u, jnp.abs(U), 0.0)),
                    jnp.max(jnp.where(real_v, jnp.abs(V), 0.0)),
                )
            )
            vel_max = jnp.maximum(vel_max, 1e-10)
            dt_cfl = cfg.cfl_target * cfl_scale * h_min / vel_max
            dt_visc = 0.2 * h_min * h_min / cfg.nu
            dt = jnp.clip(jnp.minimum(dt_cfl, dt_visc), cfg.dt_min, cfg.dt_max)
            if cfg.warmup_steps > 0:
                dt = jnp.where(
                    tstate.step < cfg.warmup_steps, jnp.float32(cfg.warmup_dt), dt
                )
            dt = dt.astype(jnp.float32)
        else:
            dt = jnp.float32(cfg.dt_base)

        # --- metric coefficient lines for the W=2 padded arrays. Index
        # maps: U/V entry (r, c) ↔ global (gy0−2+r, gx0−2+c); UC/DUX cols
        # and VC/DVY rows are cell-aligned with the lower face/row-face;
        # UY rows / VX cols are corner-aligned at global offset −1.
        hx_cells = inv_hx(gx0 - 2, nx_l + 3)       # cells gx0−2 .. gx0+nx_l
        hy_cells = inv_hy(gy0 - 2, ny_l + 3)
        wy = wcy(gy0 - 1, ny_l + 3)                # corner rows gy0−1 ..
        wx = wcx(gx0 - 1, nx_l + 3)                # corner cols gx0−1 ..

        # --- advecting velocities with metric corner weights
        UC = 0.5 * (U[:, :-1] + U[:, 1:])
        VC = 0.5 * (V[:-1, :] + V[1:, :])
        UY = (1.0 - wy) * U[:-1, :] + wy * U[1:, :]
        VX = (1.0 - wx) * V[:, :-1] + wx * V[:, 1:]
        UYc = UY[:, 1:]           # canonical corners (gy0−1+a, gx0−1+b)
        VXc = VX[1:, :]

        if cfg.scheme == "central":
            FU = UC * UC
            GU = VXc * UYc
            FV = UYc * VXc
            GV = VC * VC
        elif cfg.scheme in ("upwind", "tvd"):
            if cfg.scheme == "tvd":
                # limited gradients; the single-device op zeroes them at
                # its array-boundary lines — reproduce by global index
                gxu = vanleer_slope(
                    (U[:, 1:-1] - U[:, :-2]) * inv_hx(gx0 - 2, nx_l + 2),
                    (U[:, 2:] - U[:, 1:-1]) * inv_hx(gx0 - 1, nx_l + 2),
                )
                GXU = jnp.pad(gxu, ((0, 0), (1, 1)))
                GXU = jnp.where((gfU <= 0) | (gfU >= nx), 0.0, GXU)
                gyu = vanleer_slope(
                    (U[1:-1, :] - U[:-2, :]) * inv_dfy(gy0 - 1, ny_l + 2),
                    (U[2:, :] - U[1:-1, :]) * inv_dfy(gy0, ny_l + 2),
                )
                GYU = jnp.pad(gyu, ((1, 1), (0, 0)))
                GYU = jnp.where((grU <= -1) | (grU >= ny), 0.0, GYU)
                gyv = vanleer_slope(
                    (V[1:-1, :] - V[:-2, :]) * inv_hy(gy0 - 2, ny_l + 2),
                    (V[2:, :] - V[1:-1, :]) * inv_hy(gy0 - 1, ny_l + 2),
                )
                GYV = jnp.pad(gyv, ((1, 1), (0, 0)))
                GYV = jnp.where((grV <= 0) | (grV >= ny), 0.0, GYV)
                gxv = vanleer_slope(
                    (V[:, 1:-1] - V[:, :-2]) * inv_dfx(gx0 - 1, nx_l + 2),
                    (V[:, 2:] - V[:, 1:-1]) * inv_dfx(gx0, nx_l + 2),
                )
                GXV = jnp.pad(gxv, ((0, 0), (1, 1)))
                GXV = jnp.where((gcV <= -1) | (gcV >= nx), 0.0, GXV)
            else:
                GXU = jnp.zeros_like(U)
                GYU = jnp.zeros_like(U)
                GYV = jnp.zeros_like(V)
                GXV = jnp.zeros_like(V)

            u_lo = U[:, :-1] + GXU[:, :-1] * dxl_c(gx0 - 2, nx_l + 3)
            u_hi = U[:, 1:] - GXU[:, 1:] * dxr_c(gx0 - 2, nx_l + 3)
            FU = UC * jnp.where(UC >= 0.0, u_lo, u_hi)

            uy_lo = U[:-1, 1:] + GYU[:-1, 1:] * dyl_k(gy0 - 1, ny_l + 3)
            uy_hi = U[1:, 1:] - GYU[1:, 1:] * dyr_k(gy0 - 1, ny_l + 3)
            GU = VXc * jnp.where(VXc >= 0.0, uy_lo, uy_hi)

            v_lo = V[:-1, :] + GYV[:-1, :] * dyl_c(gy0 - 2, ny_l + 3)
            v_hi = V[1:, :] - GYV[1:, :] * dyr_c(gy0 - 2, ny_l + 3)
            GV = VC * jnp.where(VC >= 0.0, v_lo, v_hi)

            vx_lo = V[1:, :-1] + GXV[1:, :-1] * dxl_k(gx0 - 1, nx_l + 3)
            vx_hi = V[1:, 1:] - GXV[1:, 1:] * dxr_k(gx0 - 1, nx_l + 3)
            FV = UYc * jnp.where(UYc >= 0.0, vx_lo, vx_hi)
        else:
            raise ValueError(f"unknown scheme {cfg.scheme!r}")

        # owned-face coefficient lines
        dcx_f = inv_dcx(gx0 - 1, nx_l)   # center gap across owned face i
        dcy_f = inv_dcy(gy0 - 1, ny_l)   # center gap across owned row-face
        hx_own = inv_hx(gx0, nx_l)       # owned cell widths
        hy_own = inv_hy(gy0, ny_l)

        # --- flux divergences at owned faces (index maps as mac_explicit)
        conv_u = (
            FU[2 : 2 + ny_l, 2 : 2 + nx_l] - FU[2 : 2 + ny_l, 1 : 1 + nx_l]
        ) * dcx_f + (
            GU[2 : 2 + ny_l, 1 : 1 + nx_l] - GU[1 : 1 + ny_l, 1 : 1 + nx_l]
        ) * hy_own
        conv_v = (
            FV[1 : 1 + ny_l, 2 : 2 + nx_l] - FV[1 : 1 + ny_l, 1 : 1 + nx_l]
        ) * hx_own + (
            GV[2 : 2 + ny_l, 2 : 2 + nx_l] - GV[1 : 1 + ny_l, 2 : 2 + nx_l]
        ) * dcy_f

        # --- flux-form diffusion (mac_stretched.diffuse)
        DUX = (U[:, 1:] - U[:, :-1]) * hx_cells             # at centers
        lap_u_x = (
            DUX[2 : 2 + ny_l, 2 : 2 + nx_l] - DUX[2 : 2 + ny_l, 1 : 1 + nx_l]
        ) * dcx_f
        DUY = (U[1:, :] - U[:-1, :]) * inv_dfy(gy0 - 1, ny_l + 3)  # y-faces
        lap_u_y = (
            DUY[2 : 2 + ny_l, 2 : 2 + nx_l] - DUY[1 : 1 + ny_l, 2 : 2 + nx_l]
        ) * hy_own
        lap_u = lap_u_x + lap_u_y
        DVY = (V[1:, :] - V[:-1, :]) * hy_cells             # at centers
        lap_v_y = (
            DVY[2 : 2 + ny_l, 2 : 2 + nx_l] - DVY[1 : 1 + ny_l, 2 : 2 + nx_l]
        ) * dcy_f
        DVX = (V[:, 1:] - V[:, :-1]) * inv_dfx(gx0 - 1, nx_l + 3)  # x-faces
        lap_v_x = (
            DVX[2 : 2 + ny_l, 2 : 2 + nx_l] - DVX[2 : 2 + ny_l, 1 : 1 + nx_l]
        ) * hx_own
        lap_v = lap_v_x + lap_v_y

        u_star = u_t + jnp.where(gc0 >= 1, dt * (cfg.nu * lap_u - conv_u), 0.0)
        v_star = v_t + jnp.where(gr0 >= 1, dt * (cfg.nu * lap_v - conv_v), 0.0)
        u_star, v_star, a = set_normal(u_star, v_star)

        fx = fy = jnp.float32(0.0)
        if use_ibm:
            mask_u_t, mask_v_t = extras
            from cfdsim_tpu.ibm import ibm_ramp

            strength = ibm_ramp(tstate.step, ibm_ramp_steps)
            du_ibm = u_star * (strength * mask_u_t)
            dv_ibm = v_star * (strength * mask_v_t)
            u_star = u_star - du_ibm
            v_star = v_star - dv_ibm
            if cfg.compute_metrics:
                # control-volume-weighted momentum sink (mac_stretched)
                au = hy_at(gy0, ny_l) * area_u(gx0, nx_l)
                av = area_v(gy0, ny_l) * hx_at(gx0, nx_l)
                fx = _psum(jnp.sum(du_ibm * au)) / dt
                fy = _psum(jnp.sum(dv_ibm * av)) / dt

        if moving_body is not None:
            from cfdsim_tpu.ibm import ibm_ramp

            ub, vb = moving_body.velocity(tstate.t)
            strength = ibm_ramp(tstate.step, ibm_ramp_steps)
            if use_mg:
                from cfdsim_tpu.parallel.ibm_ghost_explicit import (
                    moving_ghost_forcing_2d_nonuniform_local,
                )

                xs_u, ys_u, xs_v, ys_v = extras[-1]
                ctr = moving_body.center(tstate.t)
                r = moving_body.radius
                u_star, du_mb = moving_ghost_forcing_2d_nonuniform_local(
                    u_star, xf_at(gx0 - 1, nx_l + 2),
                    yc_at(gy0 - 1, ny_l + 2), xs_u, ys_u, gy0, gx0, ctr,
                    r, _mg_delta, ub, strength, py, px, _mg_width,
                )
                v_star, dv_mb = moving_ghost_forcing_2d_nonuniform_local(
                    v_star, xc_at(gx0 - 1, nx_l + 2),
                    yf_at(gy0 - 1, ny_l + 2), xs_v, ys_v, gy0, gx0, ctr,
                    r, _mg_delta, vb, strength, py, px, _mg_width,
                )
            else:
                m_u, m_v = _mb_masks(gy0, gx0, tstate.t)
                du_mb = (u_star - ub) * (strength * m_u)
                dv_mb = (v_star - vb) * (strength * m_v)
                u_star = u_star - du_mb
                v_star = v_star - dv_mb
            if cfg.compute_metrics:
                au = hy_at(gy0, ny_l) * area_u(gx0, nx_l)
                av = area_v(gy0, ny_l) * hx_at(gx0, nx_l)
                fx = fx + _psum(jnp.sum(du_mb * au)) / dt
                fy = fy + _psum(jnp.sum(dv_mb * av)) / dt

        # --- exact distributed FDM projection
        US, VS, _ = pad(u_star, v_star, a, w=1)
        div_star = (US[1:-1, 2:] - US[1:-1, 1:-1]) * hx_own + (
            VS[2:, 1:-1] - VS[1:-1, 1:-1]
        ) * hy_own
        phi = solve_p(div_star / dt)
        PH = halo_exchange(phi, py, px, width=1)
        gx = (PH[1:-1, 1:-1] - PH[1:-1, :-2]) * dcx_f
        gy_ = (PH[1:-1, 1:-1] - PH[:-2, 1:-1]) * dcy_f
        u_new = u_star - jnp.where(gc0 >= 1, dt * gx, 0.0)
        v_new = v_star - jnp.where(gr0 >= 1, dt * gy_, 0.0)
        u_new, v_new, a = set_normal(u_new, v_new)

        u_new = jnp.clip(u_new, -cfg.max_velocity, cfg.max_velocity)
        v_new = jnp.clip(v_new, -cfg.max_velocity, cfg.max_velocity)

        new_tstate = MACState(
            u=u_new, v=v_new, p=phi, t=tstate.t + dt, step=tstate.step + 1
        )

        if cfg.compute_metrics:
            UN, VN, (grn, gfn, grvn, gcvn) = pad(u_new, v_new, a, w=1)
            div_post = (UN[1:-1, 2:] - UN[1:-1, 1:-1]) * hx_own + (
                VN[2:, 1:-1] - VN[1:-1, 1:-1]
            ) * hy_own
            ucc = 0.5 * (UN[1:-1, 1:-1] + UN[1:-1, 2:])
            vcc = 0.5 * (VN[1:-1, 1:-1] + VN[2:, 1:-1])
            w_cell = hy_at(gy0, ny_l) * hx_at(gx0, nx_l)
            dvdx = (VN[1:-1, 1:-1] - VN[1:-1, :-2]) * dcx_f
            dudy = (UN[1:-1, 1:-1] - UN[:-2, 1:-1]) * dcy_f
            corner_ok = (gr0 >= 1) & (gc0 >= 1)
            vort = jnp.where(corner_ok, dvdx - dudy, 0.0)
            real_un = (grn >= 0) & (grn < ny) & (gfn >= 0) & (gfn <= nx)
            real_vn = (grvn >= 0) & (grvn <= ny) & (gcvn >= 0) & (gcvn < nx)
            metrics = StepMetrics(
                dt=dt,
                div_pre=_pmax(jnp.max(jnp.abs(div_star))),
                div_post=_pmax(jnp.max(jnp.abs(div_post))),
                max_vel=_pmax(
                    jnp.maximum(
                        jnp.max(jnp.where(real_un, jnp.abs(UN), 0.0)),
                        jnp.max(jnp.where(real_vn, jnp.abs(VN), 0.0)),
                    )
                ),
                energy=_psum(
                    jnp.sum(w_cell * 0.5 * (ucc * ucc + vcc * vcc))
                ) / vol,
                vort_max=_pmax(jnp.max(jnp.abs(vort))),
                poisson_res=jnp.float32(0.0),  # FDM is exact
                fx=fx,
                fy=fy,
            )
        else:
            zero = jnp.float32(0.0)
            metrics = StepMetrics(dt, zero, zero, zero, zero, zero, zero)
        return new_tstate, metrics

    sharded = jax.shard_map(
        step_local,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(state_spec, metric_spec),
    )
    if use_mg:
        # append the replicated coordinate vectors OUTSIDE the shard_map
        # body (they must be traced args inside, never closures)
        def step(tstate, cfl_scale, *extras):
            return sharded(tstate, cfl_scale, *extras, _mg_vecs)

        return step
    return sharded


def make_cavity_stretched_explicit_step(cfg: StretchedMACConfig, mesh: Mesh,
                                        x_faces, y_faces,
                                        lid_velocity: float = 1.0):
    """Explicit-comm stretched-MAC step for the wall-clustered cavity."""
    bcs = cavity_mac_local_bcs(cfg.ny, cfg.nx, lid_velocity)
    return jax.jit(
        make_stretched_mac_explicit_step(cfg, mesh, bcs, x_faces, y_faces)
    )


def make_cylinder_stretched_explicit_step(cfg: StretchedMACConfig, mesh: Mesh,
                                          x_faces, y_faces,
                                          v_inf: float = 1.0,
                                          perturb_amp: float = 0.01,
                                          perturb_ramp_steps: int = 1000,
                                          ibm_ramp_steps: int = 0):
    """Explicit-comm stretched-MAC step for the body/wake-refined cylinder.
    Call as ``step(tstate, cfl_scale, mask_u_t, mask_v_t)`` with masks
    from ``mac_explicit.trim_face_masks``."""
    from cfdsim_tpu.parallel.mac_explicit import external_flow_mac_local_bcs

    my = _metrics(y_faces)
    yf = np.asarray(y_faces, np.float64)
    bcs = external_flow_mac_local_bcs(
        cfg.ny, cfg.nx, dy=0.0, y_min=float(yf[0]), y_max=float(yf[-1]),
        v_inf=v_inf, perturb_amp=perturb_amp,
        perturb_ramp_steps=perturb_ramp_steps,
        y_centers=my.xc,
    )
    return jax.jit(
        make_stretched_mac_explicit_step(
            cfg, mesh, bcs, x_faces, y_faces,
            use_ibm=True, ibm_ramp_steps=ibm_ramp_steps,
        )
    )


def make_moving_body_stretched_explicit_step(
    cfg: StretchedMACConfig, mesh: Mesh, x_faces, y_faces, moving_body,
    ibm_ramp_steps: int = 0, moving_scheme: str = "penalize",
):
    """Explicit-comm stretched-MAC step for a moving body in a quiescent
    free-slip box — the sharded twin of cylinder_oscillating(
    stretched=True): masks from per-axis coordinate LUTs, volume-
    weighted psum'd forces. ``moving_scheme="ghost"`` selects the
    sharded sharp-interface moving ghost (the Dütsch KC=5 quality
    tier)."""
    from cfdsim_tpu.parallel.mac_explicit import free_slip_mac_local_bcs

    bcs = free_slip_mac_local_bcs(cfg.ny, cfg.nx)
    return jax.jit(make_stretched_mac_explicit_step(
        cfg, mesh, bcs, x_faces, y_faces, moving_body=moving_body,
        ibm_ramp_steps=ibm_ramp_steps, moving_scheme=moving_scheme,
    ))
