"""Explicit shard_map step for the 3D *stretched* MAC solver — the last
cell of the multi-chip solver matrix ({2D, 3D} × {uniform, stretched}).

Same layout as ``parallel/mac3d_explicit.py`` (trimmed state, z local,
width-1 y/x ppermute halos, masked-write cavity BCs) with the metric
machinery of ``parallel/mac_stretched_explicit.py``: every y/x metric
coefficient enters as a ``lax.dynamic_slice`` of an edge-padded global
vector (never a gather — backend miscompile, see CLAUDE.md), z metrics
are plain local constants, and the projection is the exact distributed
3D fast-diagonalization solve (``transforms.make_fdm_poisson3d_local`` —
dense eigenbasis matmuls between all_to_alls).

Equality with the single-device ``mac_stretched3d.make_step`` on an
8-device mesh: tests/test_mac3d_explicit.py (stretched section).

LES (round 4): both ``les_model="smagorinsky"`` and ``"dynamic"`` run
sharded — ν_t is evaluated on width-2 (±2-center) halo windows with
window-sliced metric lines and fed to the flux-form variable-ν
diffusion (``_diffuse_les_stretched3d`` on the window, cropped to
owned faces); the dynamic Germano coefficient reuses
``mac3d_explicit._dynamic_cs2_local`` with stretched ``inv_g2`` /
Δ²(x) window slices. This is the Re=3900 sphere production
configuration (stretched + ghost IBM + LES) made multi-chip
(tests/test_ghost_explicit.py stretched_les).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from cfdsim_tpu.models.incompressible import StepMetrics
from cfdsim_tpu.models.mac3d import MAC3DState
from cfdsim_tpu.models.mac_stretched import _metrics
from cfdsim_tpu.models.mac_stretched3d import StretchedMAC3DConfig
from cfdsim_tpu.parallel.mac_explicit import _pmax, _psum
from cfdsim_tpu.parallel.mac3d_explicit import _halo_yx
from cfdsim_tpu.parallel.transforms import make_fdm_poisson3d_local

_PAD = 4


def _lut3(vec, axis: int):
    """y (axis 1) / x (axis 2) metric line by dynamic slice of an
    edge-padded global vector; broadcastable over the other two axes."""
    v = np.asarray(vec, np.float32)
    vp = jnp.asarray(np.pad(v, _PAD, mode="edge"))

    def at(start, length: int):
        s = lax.dynamic_slice(vp, (start + _PAD,), (length,))
        return s[None, :, None] if axis == 1 else s[None, None, :]

    return at


def _zc(vec):
    """Local (replicated) z metric line, shape (len, 1, 1)."""
    return jnp.asarray(np.asarray(vec, np.float32))[:, None, None]


def make_stretched3d_explicit_step(
    cfg: StretchedMAC3DConfig,
    mesh: Mesh,
    x_faces,
    y_faces,
    z_faces,
    bcs,
    use_ibm: bool = False,
    ibm_ramp_steps: int = 0,
    moving_body=None,
    ghost_halo: int | None = None,
):
    """Build ``step(tstate, cfl_scale[, mask_u_t, mask_v_t, mask_w_t]) ->
    (tstate, StepMetrics)`` on the trimmed 3D representation,
    P(None, "y", "x")-sharded. ``bcs`` is a masked-write
    ``mac3d_explicit.MAC3DLocalBCs`` kit (its width-2 ``win`` hook is
    unused — this step runs width-1 halos, central scheme only);
    optional IBM masks are the trimmed face masks from
    ``mac3d_explicit.trim_face_masks3d``, with the body force
    volume-weighted by the staggered control volumes (the sharded analog
    of mac_stretched3d.make_step's IBM block). ``ghost_halo`` instead
    enables the sharded sharp-interface ghost-cell forcing: the step
    then takes the per-shard ``ShardedGhostIBM3D`` tables as a trailing
    argument (tables-as-args per the shard_map backend-bug rules) and
    ``ghost_halo`` is the static probe halo width from
    ``ibm_ghost_explicit.partition_ghost_ibm3d``."""
    if ghost_halo is not None and use_ibm:
        raise ValueError("ghost_halo and use_ibm are mutually exclusive")
    if cfg.scheme != "central":
        raise ValueError(
            "the explicit stretched-3D step implements scheme='central'"
        )
    use_les = getattr(cfg, "use_les", False)
    les_model = getattr(cfg, "les_model", "smagorinsky")
    if les_model not in ("smagorinsky", "dynamic"):
        raise ValueError(f"unknown les_model {les_model!r}")
    dynamic_les = use_les and les_model == "dynamic"
    if dynamic_les and moving_body is not None:
        raise ValueError(
            "les_model='dynamic' does not support moving_body yet "
            "(matches models/mac_stretched3d.py)"
        )
    if getattr(cfg, "time_scheme", "euler") != "euler":
        raise ValueError(
            "the explicit stretched-3D step implements time_scheme='euler'"
        )
    if getattr(cfg, "projection", "chorin") != "chorin":
        raise ValueError("the explicit sharded step implements projection='chorin'")
    mx = _metrics(x_faces)
    my = _metrics(y_faces)
    mz = _metrics(z_faces)
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    py = mesh.shape["y"]
    px = mesh.shape["x"]
    ny_l, nx_l = ny // py, nx // px
    if ny % py or nx % px:
        raise ValueError(f"grid {ny}x{nx} not divisible by mesh {py}x{px}")
    if ny_l < 2 or nx_l < 2:
        raise ValueError("local blocks must be at least 2x2 for width-1 halos")
    if dynamic_les:
        if any(d <= 6 for d in (nz, ny, nx)):
            raise ValueError(
                f"grid {(nz, ny, nx)} too small for the dynamic model's "
                "boundary_skip=3 (needs > 6 cells per axis)"
            )
        if ny_l < 3 or nx_l < 3:
            raise ValueError(
                "les_model='dynamic' needs local blocks >= 3x3 for its "
                f"width-3 halo windows; got {ny_l}x{nx_l}"
            )

    # y/x metric lines (dynamic-sliced per shard by iy/ix at run time)
    inv_hx = _lut3(1.0 / mx.h, 2)
    inv_hy = _lut3(1.0 / my.h, 1)
    inv_dcx = _lut3(1.0 / mx.dc, 2)
    inv_dcy = _lut3(1.0 / my.dc, 1)
    inv_dfx = _lut3(1.0 / mx.dfull, 2)
    inv_dfy = _lut3(1.0 / my.dfull, 1)
    wcx = _lut3(np.concatenate([[0.5], mx.wf, [0.5]]), 2)
    wcy = _lut3(np.concatenate([[0.5], my.wf, [0.5]]), 1)
    hx_at = _lut3(mx.h, 2)
    hy_at = _lut3(my.h, 1)
    # z metric lines (local constants)
    inv_hz = _zc(1.0 / mz.h)
    inv_dcz = _zc(1.0 / mz.dc)
    inv_dfz = _zc(1.0 / mz.dfull)
    wcz = _zc(np.concatenate([[0.5], mz.wf, [0.5]]))
    hz_c = _zc(mz.h)
    h_min = float(min(mx.h.min(), my.h.min(), mz.h.min()))
    vol = float(np.sum(mx.h) * np.sum(my.h) * np.sum(mz.h))
    dfx_at = _lut3(mx.dfull, 2)
    dfy_at = _lut3(my.dfull, 1)
    dfz_c = _zc(mz.dfull)

    if use_les:
        # Smagorinsky / dynamic LES on ±2-center halo windows — the
        # window-based twin of models/mac_stretched3d.py's nu_turb +
        # _diffuse_les_stretched3d (mac3d_explicit LES pattern on the
        # stretched metrics). The per-axis Δ^{2/3} factors multiply on
        # device; the f64-host-then-f32 product differs from the
        # single-device joint (hx hy hz)^{2/3} by ≤1 ulp f32.
        from cfdsim_tpu.models.mac_stretched3d import (
            _diffuse_les_stretched3d,
            smagorinsky_viscosity_stretched3d,
        )

        d23x_at = _lut3(np.asarray(mx.h, np.float64) ** (2.0 / 3.0), 2)
        d23y_at = _lut3(np.asarray(my.h, np.float64) ** (2.0 / 3.0), 1)
        d23z_c = _zc(np.asarray(mz.h, np.float64) ** (2.0 / 3.0))
    if dynamic_les:
        from cfdsim_tpu.parallel.mac3d_explicit import _dynamic_cs2_local

        def _g2v(m):
            # 1/(two-center gaps) on the ghost-extended centers — the
            # sharded slice of models/mac_stretched3d.py's _g2
            xg = np.concatenate([[m.xc[0]], m.xc, [m.xc[-1]]])
            return 1.0 / (xg[2:] - xg[:-2])

        g2x_at = _lut3(_g2v(mx), 2)
        g2y_at = _lut3(_g2v(my), 1)
        g2z_c = _zc(_g2v(mz))

    if moving_body is not None:
        # face-coordinate lookups (dynamic slices, h_min taper — the
        # sharded habitat of mac_stretched3d.make_step's body_masks)
        xf_at = _lut3(np.asarray(x_faces), 2)
        yc_at = _lut3(my.xc, 1)
        xc_at = _lut3(mx.xc, 2)
        yf_at = _lut3(np.asarray(y_faces), 1)
        zc_c = _zc(mz.xc)                        # cell centers (nz,1,1)
        zf_c = _zc(np.asarray(z_faces)[:-1])     # z faces 0..nz-1

    solve_p = make_fdm_poisson3d_local(mx.h, my.h, mz.h, py, px)

    spec = P(None, "y", "x")
    state_spec = MAC3DState(u=spec, v=spec, w=spec, p=spec, t=P(), step=P())
    metric_spec = StepMetrics(*([P()] * len(StepMetrics._fields)))
    in_specs = [state_spec, P()]
    if use_ibm:
        in_specs += [spec, spec, spec]
    if ghost_halo is not None:
        from cfdsim_tpu.parallel.ibm_ghost_explicit import ghost_ibm_spec

        in_specs += [ghost_ibm_spec()]

    def step_local(ts: MAC3DState, cfl_scale, *extras):
        iy = lax.axis_index("y")
        ix = lax.axis_index("x")
        gy0 = iy * ny_l
        gx0 = ix * nx_l
        ro = gy0 + lax.broadcasted_iota(jnp.int32, (ny_l, nx_l), 0)[None]
        co = gx0 + lax.broadcasted_iota(jnp.int32, (ny_l, nx_l), 1)[None]
        shp_p = (ny_l + 2, nx_l + 2)
        rp = gy0 - 1 + lax.broadcasted_iota(jnp.int32, shp_p, 0)[None]
        cp = gx0 - 1 + lax.broadcasted_iota(jnp.int32, shp_p, 1)[None]

        def set_normal(u_t, v_t, w_t):
            u_t, v_t, w_t = bcs.pre(u_t, v_t, w_t, ro, co, ts)
            a = bcs.aux(u_t, v_t, w_t, ro, co, ts)
            return u_t, v_t, w_t, a

        def pad(u_t, v_t, w_t, a):
            U = _halo_yx(u_t, py, px)
            V = _halo_yx(v_t, py, px)
            W = _halo_yx(w_t, py, px)
            Wz = jnp.concatenate([W, jnp.zeros_like(W[:1])], axis=0)
            return bcs.pad_writes(U, V, Wz, rp, cp, ts, a)

        u_t, v_t, w_t, a = set_normal(ts.u, ts.v, ts.w)
        U, V, Wz = pad(u_t, v_t, w_t, a)
        UZG = bcs.zghost_u(U)
        VZG = bcs.zghost_v(V)

        if use_les:
            # --- width-2 halo windows (±2-center virtual local domain,
            # mac3d_explicit pattern): ν_t is exact on the ±1 ring
            # around owned cells, which is all the flux-form diffusion
            # below reads for owned faces
            U2 = _halo_yx(u_t, py, px, w=2)
            V2 = _halo_yx(v_t, py, px, w=2)
            W2 = _halo_yx(w_t, py, px, w=2)
            shp2 = (ny_l + 4, nx_l + 4)
            r2 = gy0 - 2 + lax.broadcasted_iota(jnp.int32, shp2, 0)[None]
            c2 = gx0 - 2 + lax.broadcasted_iota(jnp.int32, shp2, 1)[None]
            U2, V2, W2 = bcs.win(U2, V2, W2, r2, c2, ts, a)
            u_win = jnp.concatenate(
                [U2, jnp.zeros_like(U2[:, :, :1])], axis=2
            )
            v_win = jnp.concatenate(
                [V2, jnp.zeros_like(V2[:, :1, :])], axis=1
            )
            w_win = jnp.concatenate(
                [W2, jnp.zeros_like(W2[:1])], axis=0
            )

            def zpad2(arr, axis):
                zl = jnp.zeros_like(lax.slice_in_dim(arr, 0, 1, axis=axis))
                return jnp.concatenate([zl, arr, zl], axis=axis)

            ghosts_win = (
                zpad2(u_win, 1), bcs.zghost_u(u_win),
                zpad2(v_win, 2), bcs.zghost_v(v_win),
                zpad2(w_win, 2), zpad2(w_win, 1),
            )
            hxw = inv_hx(gx0 - 2, nx_l + 4)
            hyw = inv_hy(gy0 - 2, ny_l + 4)
            dfxw = inv_dfx(gx0 - 2, nx_l + 5)
            dfyw = inv_dfy(gy0 - 2, ny_l + 5)
            d2w = (d23z_c * d23y_at(gy0 - 2, ny_l + 4)
                   * d23x_at(gx0 - 2, nx_l + 4))
            if dynamic_les:
                cs2 = _dynamic_cs2_local(
                    u_t, v_t, w_t, py, px, ny_l, nx_l, nz, ny, nx,
                    ro, co, g2x_at(gx0 - 2, nx_l + 4),
                    g2y_at(gy0 - 2, ny_l + 4), g2z_c, d2w,
                    use_ibm, ghost_halo, extras,
                )
                NUT = cs2 * smagorinsky_viscosity_stretched3d(
                    u_win, v_win, w_win, ghosts_win,
                    hxw, hyw, inv_hz, dfxw, dfyw, inv_dfz, d2w,
                )
            else:
                NUT = smagorinsky_viscosity_stretched3d(
                    u_win, v_win, w_win, ghosts_win,
                    hxw, hyw, inv_hz, dfxw, dfyw, inv_dfz,
                    cfg.smagorinsky_constant ** 2 * d2w,
                )
            # single-device edge-clamp (pad mode="edge") at GLOBAL edges
            NUT = jnp.where(r2 == -1, jnp.roll(NUT, -1, axis=1), NUT)
            NUT = jnp.where(r2 == ny, jnp.roll(NUT, 1, axis=1), NUT)
            NUT = jnp.where(c2 == -1, jnp.roll(NUT, -1, axis=2), NUT)
            NUT = jnp.where(c2 == nx, jnp.roll(NUT, 1, axis=2), NUT)
            nu_stab = cfg.nu + _psum(
                jnp.sum(NUT[:, 2 : 2 + ny_l, 2 : 2 + nx_l])
            ) / float(nx * ny * nz)
        else:
            nu_stab = cfg.nu

        if cfg.adaptive_dt:
            vel_max = _pmax(
                jnp.maximum(
                    jnp.maximum(jnp.max(jnp.abs(u_t)), jnp.max(jnp.abs(v_t))),
                    jnp.maximum(
                        jnp.maximum(
                            jnp.max(jnp.abs(w_t)), bcs.velmax_extra(u_t, a)
                        ),
                        1e-10,
                    ),
                )
            )
            dt_cfl = cfg.cfl_target * cfl_scale * h_min / vel_max
            dt_visc = 0.125 * h_min * h_min / nu_stab
            dt = jnp.clip(
                jnp.minimum(dt_cfl, dt_visc), cfg.dt_min, cfg.dt_max
            ).astype(jnp.float32)
        else:
            dt = jnp.float32(cfg.dt_base)

        # --- edge interpolants with metric corner weights
        # (mac_stretched3d.make_step; corner alignment as mac3d_explicit)
        wy = wcy(gy0, ny_l + 1)          # corner rows gy0 .. gy0+ny_l
        wx = wcx(gx0, nx_l + 1)          # corner cols gx0 .. gx0+nx_l
        UC = 0.5 * (U[:, :, :-1] + U[:, :, 1:])
        VCC = 0.5 * (V[:, :-1, :] + V[:, 1:, :])
        WCC = 0.5 * (Wz[:-1] + Wz[1:])
        UY = (1.0 - wy) * U[:, :-1, :] + wy * U[:, 1:, :]
        VX = (1.0 - wx) * V[:, :, :-1] + wx * V[:, :, 1:]
        UZ = (1.0 - wcz) * UZG[:-1] + wcz * UZG[1:]
        WX = (1.0 - wx) * Wz[:, :, :-1] + wx * Wz[:, :, 1:]
        VZ = (1.0 - wcz) * VZG[:-1] + wcz * VZG[1:]
        WY = (1.0 - wy) * Wz[:, :-1, :] + wy * Wz[:, 1:, :]

        dcx_f = inv_dcx(gx0 - 1, nx_l)
        dcy_f = inv_dcy(gy0 - 1, ny_l)
        hx_own = inv_hx(gx0, nx_l)
        hy_own = inv_hy(gy0, ny_l)

        # --- conservative central fluxes with per-axis gaps
        FU = UC * UC
        GU = VX[:, 1:, :] * UY[:, :, 1:]
        HU = WX[:, 1:-1, :] * UZ[:, 1:-1, 1:]
        conv_u = (
            (FU[:, 1 : 1 + ny_l, 1:] - FU[:, 1 : 1 + ny_l, :-1]) * dcx_f
        )[:, :, :nx_l] + (
            (GU[:, 1:, :] - GU[:, :-1, :]) * hy_own
        )[:, :, :nx_l] + (
            (HU[1:] - HU[:-1]) * inv_hz
        )[:, :, :nx_l]

        GVC = VCC * VCC
        HV = WY[:, :ny_l, 1 : 1 + nx_l] * VZ[:, 1 : 1 + ny_l, 1 : 1 + nx_l]
        conv_v = (
            (GU[:, :, 1:] - GU[:, :, :-1]) * hx_own
        )[:, :ny_l, :] + (
            (GVC[:, 1:, :] - GVC[:, :-1, :]) * dcy_f
        )[:, :ny_l, 1 : 1 + nx_l] + (HV[1:] - HV[:-1]) * inv_hz

        FW = UZ[:, 1:-1, 1:] * WX[:, 1:-1, :]
        GW = VZ[:, 1:, 1 : 1 + nx_l] * WY[:, :, 1 : 1 + nx_l]
        HWC = WCC * WCC
        dHW = jnp.pad(
            (HWC[1:] - HWC[:-1]) * inv_dcz, ((1, 0), (0, 0), (0, 0))
        )
        conv_w = (
            (FW[:, :, 1:] - FW[:, :, :-1]) * hx_own
        )[:nz] + (
            (GW[:, 1:, :] - GW[:, :-1, :]) * hy_own
        )[:nz] + dHW[:, 1 : 1 + ny_l, 1 : 1 + nx_l]

        # --- flux-form diffusion (mac_stretched3d.make_step)
        dux = (U[:, 1:-1, 1:] - U[:, 1:-1, :-1]) * inv_hx(gx0 - 1, nx_l + 1)
        lap_u_x = (dux[:, :, 1:] - dux[:, :, :-1]) * dcx_f
        duy = (U[:, 1:, 1:-1] - U[:, :-1, 1:-1]) * inv_dfy(gy0, ny_l + 1)
        lap_u_y = (duy[:, 1:, :] - duy[:, :-1, :]) * hy_own
        duz = (UZG[1:, 1:-1, 1:-1] - UZG[:-1, 1:-1, 1:-1]) * inv_dfz
        lap_u_z = (duz[1:] - duz[:-1]) * inv_hz
        lap_u = lap_u_x + lap_u_y + lap_u_z

        dvy = (V[:, 1:, 1:-1] - V[:, :-1, 1:-1]) * inv_hy(gy0 - 1, ny_l + 1)
        lap_v_y = (dvy[:, 1:, :] - dvy[:, :-1, :]) * dcy_f
        dvx = (V[:, 1:-1, 1:] - V[:, 1:-1, :-1]) * inv_dfx(gx0, nx_l + 1)
        lap_v_x = (dvx[:, :, 1:] - dvx[:, :, :-1]) * hx_own
        dvz = (VZG[1:, 1:-1, 1:-1] - VZG[:-1, 1:-1, 1:-1]) * inv_dfz
        lap_v_z = (dvz[1:] - dvz[:-1]) * inv_hz
        lap_v = lap_v_x + lap_v_y + lap_v_z

        Wp = Wz[:nz]
        dwx = (Wp[:, 1:-1, 1:] - Wp[:, 1:-1, :-1]) * inv_dfx(gx0, nx_l + 1)
        lap_w_x = (dwx[:, :, 1:] - dwx[:, :, :-1]) * hx_own
        dwy = (Wp[:, 1:, 1:-1] - Wp[:, :-1, 1:-1]) * inv_dfy(gy0, ny_l + 1)
        lap_w_y = (dwy[:, 1:, :] - dwy[:, :-1, :]) * hy_own
        dwz = (Wz[1:, 1:-1, 1:-1] - Wz[:-1, 1:-1, 1:-1]) * inv_hz  # at cells
        lap_w_z = jnp.pad(
            (dwz[1:] - dwz[:-1]) * inv_dcz, ((1, 0), (0, 0), (0, 0))
        )
        lap_w = lap_w_x + lap_w_y + lap_w_z

        if use_les:
            # replace the molecular fluxes entirely (single-device
            # pattern): variable-ν flux-form diffusion on the window
            # with ν_eff = ν + ν_t, cropped to owned faces
            visc_u, visc_v, visc_w = _diffuse_les_stretched3d(
                u_win, v_win, w_win, ghosts_win, cfg.nu + NUT,
                hxw, hyw, inv_hz,
                inv_dcx(gx0 - 2, nx_l + 3), inv_dcy(gy0 - 2, ny_l + 3),
                inv_dcz, dfxw, dfyw, inv_dfz,
            )
            du_v = visc_u[:, 2 : 2 + ny_l, 1 : 1 + nx_l]
            dv_v = visc_v[:, 1 : 1 + ny_l, 2 : 2 + nx_l]
            dw_v = visc_w[:, 2 : 2 + ny_l, 2 : 2 + nx_l]
            u_star = u_t + jnp.where(co >= 1, dt * (du_v - conv_u), 0.0)
            v_star = v_t + jnp.where(ro >= 1, dt * (dv_v - conv_v), 0.0)
            w_star = w_t.at[1:].add(dt * (dw_v - conv_w[1:]))
        else:
            u_star = u_t + jnp.where(
                co >= 1, dt * (cfg.nu * lap_u - conv_u), 0.0
            )
            v_star = v_t + jnp.where(
                ro >= 1, dt * (cfg.nu * lap_v - conv_v), 0.0
            )
            w_star = w_t.at[1:].add(dt * (cfg.nu * lap_w - conv_w)[1:])
        u_star, v_star, w_star, a = set_normal(u_star, v_star, w_star)

        # --- IBM penalization + volume-weighted body force
        # (mac_stretched3d.make_step ibm block, psum'd)
        fx = fy = fz = jnp.float32(0.0)
        if use_ibm:
            mask_u_t, mask_v_t, mask_w_t = extras
            from cfdsim_tpu.ibm import ibm_ramp

            strength = ibm_ramp(ts.step, ibm_ramp_steps)
            du_ibm = u_star * (strength * mask_u_t)
            dv_ibm = v_star * (strength * mask_v_t)
            dw_ibm = w_star * (strength * mask_w_t)
            u_star = u_star - du_ibm
            v_star = v_star - dv_ibm
            w_star = w_star - dw_ibm
            if cfg.compute_metrics:
                cv_u = hz_c * hy_at(gy0, ny_l) * dfx_at(gx0, nx_l)
                cv_v = hz_c * dfy_at(gy0, ny_l) * hx_at(gx0, nx_l)
                cv_w = dfz_c[:nz] * hy_at(gy0, ny_l) * hx_at(gx0, nx_l)
                fx = _psum(jnp.sum(du_ibm * cv_u)) / dt
                fy = _psum(jnp.sum(dv_ibm * cv_v)) / dt
                fz = _psum(jnp.sum(dw_ibm * cv_w)) / dt

        if ghost_halo is not None:
            # sharded twin of mac_stretched3d.make_step's ibm_ghost
            # block: sharp-interface forcing on the provisional fields,
            # volume-weighted forces psum'd; tables arrive as a
            # shard_map ARG (gather-on-constants miscompile rules)
            from cfdsim_tpu.ibm import ibm_ramp
            from cfdsim_tpu.parallel.ibm_ghost_explicit import (
                apply_ghost_forcing_local,
            )

            (tables,) = extras
            strength = ibm_ramp(ts.step, ibm_ramp_steps)
            u_star, du_g = apply_ghost_forcing_local(
                u_star, tables.u, py, px, ghost_halo, strength
            )
            v_star, dv_g = apply_ghost_forcing_local(
                v_star, tables.v, py, px, ghost_halo, strength
            )
            w_star, dw_g = apply_ghost_forcing_local(
                w_star, tables.w, py, px, ghost_halo, strength
            )
            if cfg.compute_metrics:
                cv_u = hz_c * hy_at(gy0, ny_l) * dfx_at(gx0, nx_l)
                cv_v = hz_c * dfy_at(gy0, ny_l) * hx_at(gx0, nx_l)
                cv_w = dfz_c[:nz] * hy_at(gy0, ny_l) * hx_at(gx0, nx_l)
                fx = _psum(jnp.sum(du_g * cv_u)) / dt
                fy = _psum(jnp.sum(dv_g * cv_v)) / dt
                fz = _psum(jnp.sum(dw_g * cv_w)) / dt

        if moving_body is not None:
            from cfdsim_tpu.ibm import ibm_ramp

            cx, cy, cz = moving_body.center(ts.t)
            r = moving_body.radius
            xu = xf_at(gx0, nx_l)
            yu = yc_at(gy0, ny_l)
            xv = xc_at(gx0, nx_l)
            yv = yf_at(gy0, ny_l)

            def _m(X, Y, Z):
                d = jnp.sqrt((X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2)
                return jnp.clip((r + 0.5 * h_min - d) / h_min, 0.0, 1.0)

            m_u = _m(xu, yu, zc_c)
            m_v = _m(xv, yv, zc_c)
            m_w = _m(xv, yu, zf_c)
            ub, vb, wb = moving_body.velocity(ts.t)
            strength = ibm_ramp(ts.step, ibm_ramp_steps)
            du_mb = (u_star - ub) * (strength * m_u)
            dv_mb = (v_star - vb) * (strength * m_v)
            dw_mb = (w_star - wb) * (strength * m_w)
            u_star = u_star - du_mb
            v_star = v_star - dv_mb
            w_star = w_star - dw_mb
            if cfg.compute_metrics:
                cv_u = hz_c * hy_at(gy0, ny_l) * dfx_at(gx0, nx_l)
                cv_v = hz_c * dfy_at(gy0, ny_l) * hx_at(gx0, nx_l)
                cv_w = dfz_c[:nz] * hy_at(gy0, ny_l) * hx_at(gx0, nx_l)
                fx = fx + _psum(jnp.sum(du_mb * cv_u)) / dt
                fy = fy + _psum(jnp.sum(dv_mb * cv_v)) / dt
                fz = fz + _psum(jnp.sum(dw_mb * cv_w)) / dt

        # --- exact distributed 3D FDM projection
        US, VS, WSz = pad(u_star, v_star, w_star, a)
        div_star = (
            (US[:, 1:-1, 2:] - US[:, 1:-1, 1:-1]) * hx_own
            + (VS[:, 2:, 1:-1] - VS[:, 1:-1, 1:-1]) * hy_own
            + (WSz[1:, 1:-1, 1:-1] - WSz[:-1, 1:-1, 1:-1]) * inv_hz
        )
        phi = solve_p(div_star / dt)
        PH = _halo_yx(phi, py, px)
        gx = (PH[:, 1:-1, 1:-1] - PH[:, 1:-1, :-2]) * dcx_f
        gy_ = (PH[:, 1:-1, 1:-1] - PH[:, :-2, 1:-1]) * dcy_f
        u_new = u_star - jnp.where(co >= 1, dt * gx, 0.0)
        v_new = v_star - jnp.where(ro >= 1, dt * gy_, 0.0)
        w_new = w_star.at[1:].add(-dt * (phi[1:] - phi[:-1]) * inv_dcz)
        u_new, v_new, w_new, a = set_normal(u_new, v_new, w_new)
        u_new = jnp.clip(u_new, -cfg.max_velocity, cfg.max_velocity)
        v_new = jnp.clip(v_new, -cfg.max_velocity, cfg.max_velocity)
        w_new = jnp.clip(w_new, -cfg.max_velocity, cfg.max_velocity)

        new_ts = MAC3DState(
            u=u_new, v=v_new, w=w_new, p=phi,
            t=ts.t + dt, step=ts.step + 1,
        )

        if cfg.compute_metrics:
            UN, VN, WNz = pad(u_new, v_new, w_new, a)
            div_post = (
                (UN[:, 1:-1, 2:] - UN[:, 1:-1, 1:-1]) * hx_own
                + (VN[:, 2:, 1:-1] - VN[:, 1:-1, 1:-1]) * hy_own
                + (WNz[1:, 1:-1, 1:-1] - WNz[:-1, 1:-1, 1:-1]) * inv_hz
            )
            ucc = 0.5 * (UN[:, 1:-1, 1:-1] + UN[:, 1:-1, 2:])
            vcc = 0.5 * (VN[:, 1:-1, 1:-1] + VN[:, 2:, 1:-1])
            wcc = 0.5 * (WNz[:-1, 1:-1, 1:-1] + WNz[1:, 1:-1, 1:-1])
            w_cell = hz_c * hy_at(gy0, ny_l) * hx_at(gx0, nx_l)
            dwdy = (
                (WNz[:, 1 : 1 + ny_l, 1 : 1 + nx_l]
                 - WNz[:, 0:ny_l, 1 : 1 + nx_l]) * dcy_f
            )[1:nz]
            dvdz = (
                VN[1:, 1 : 1 + ny_l, 1 : 1 + nx_l]
                - VN[:-1, 1 : 1 + ny_l, 1 : 1 + nx_l]
            ) * inv_dcz
            vort = jnp.where((ro >= 1), dwdy - dvdz, 0.0)
            metrics = StepMetrics(
                dt=dt,
                div_pre=_pmax(jnp.max(jnp.abs(div_star))),
                div_post=_pmax(jnp.max(jnp.abs(div_post))),
                max_vel=_pmax(
                    jnp.maximum(
                        jnp.maximum(jnp.max(jnp.abs(u_new)), jnp.max(jnp.abs(v_new))),
                        jnp.max(jnp.abs(w_new)),
                    )
                ),
                energy=_psum(
                    jnp.sum(w_cell * 0.5 * (ucc * ucc + vcc * vcc + wcc * wcc))
                ) / vol,
                vort_max=_pmax(jnp.max(jnp.abs(vort))),
                poisson_res=jnp.float32(0.0),  # FDM is exact
                fx=fx,
                fy=fy,
                fz=fz,
            )
        else:
            zero = jnp.float32(0.0)
            metrics = StepMetrics(dt, zero, zero, zero, zero, zero, zero)
        return new_ts, metrics

    return jax.shard_map(
        step_local,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(state_spec, metric_spec),
    )


def make_cavity3d_stretched_explicit_step(
    cfg: StretchedMAC3DConfig,
    mesh: Mesh,
    x_faces,
    y_faces,
    z_faces,
    lid_velocity: float = 1.0,
):
    """Explicit-comm stretched 3D MAC step for the lid-driven cavity."""
    from cfdsim_tpu.parallel.mac3d_explicit import cavity3d_local_bcs

    bcs = cavity3d_local_bcs(cfg.nx, cfg.ny, lid_velocity)
    return jax.jit(make_stretched3d_explicit_step(
        cfg, mesh, x_faces, y_faces, z_faces, bcs
    ))


def make_sphere3d_stretched_explicit_step(
    cfg: StretchedMAC3DConfig,
    mesh: Mesh,
    x_faces,
    y_faces,
    z_faces,
    v_inf: float = 1.0,
    ibm_ramp_steps: int = 0,
):
    """Explicit-comm stretched 3D MAC step for external flow past an
    immersed body (the ``sphere_stretched`` case, central scheme): call
    as ``step(tstate, cfl_scale, mask_u_t, mask_v_t, mask_w_t)`` with
    the trimmed, P(None, "y", "x")-sharded masks from
    ``mac3d_explicit.trim_face_masks3d``. The outflow mass balance is
    area-weighted by the stretched x-face areas (h_y⊗h_z)."""
    from cfdsim_tpu.parallel.mac3d_explicit import external_flow3d_local_bcs

    hy = np.diff(np.asarray(y_faces))
    hz = np.diff(np.asarray(z_faces))
    fw = hz[:, None] * hy[None, :]
    bcs = external_flow3d_local_bcs(
        cfg.nx, cfg.ny, cfg.nz, v_inf, face_weights=fw
    )
    return jax.jit(make_stretched3d_explicit_step(
        cfg, mesh, x_faces, y_faces, z_faces, bcs,
        use_ibm=True, ibm_ramp_steps=ibm_ramp_steps,
    ))


def make_sphere_ghost3d_stretched_explicit_step(
    cfg: StretchedMAC3DConfig, mesh: Mesh, x_faces, y_faces, z_faces,
    ghost, v_inf: float = 1.0, ibm_ramp_steps: int = 0,
):
    """Sharded stretched-3D ghost-cell sphere step (the
    ``sphere_stretched`` case with ``ibm_scheme="ghost"``): the
    host-built ``GhostIBM3D`` is partitioned per shard here (the
    nonuniform probe stencils are index-based, so the same partitioner
    serves both tiers). Returns ``(step, tables)``; call
    ``step(tstate, cfl_scale, tables)``."""
    from cfdsim_tpu.parallel.ibm_ghost_explicit import (
        partition_ghost_ibm3d,
        shard_ghost_tables,
    )
    from cfdsim_tpu.parallel.mac3d_explicit import external_flow3d_local_bcs

    hy = np.diff(np.asarray(y_faces))
    hz = np.diff(np.asarray(z_faces))
    fw = hz[:, None] * hy[None, :]
    bcs = external_flow3d_local_bcs(
        cfg.nx, cfg.ny, cfg.nz, v_inf, face_weights=fw
    )
    py, px = mesh.shape["y"], mesh.shape["x"]
    tables, width = partition_ghost_ibm3d(
        ghost, cfg.nx, cfg.ny, cfg.nz, py, px
    )
    tables = shard_ghost_tables(tables, mesh)
    step = jax.jit(make_stretched3d_explicit_step(
        cfg, mesh, x_faces, y_faces, z_faces, bcs,
        ghost_halo=width, ibm_ramp_steps=ibm_ramp_steps,
    ))
    return step, tables


def make_moving_body3d_stretched_explicit_step(
    cfg: StretchedMAC3DConfig, mesh: Mesh, x_faces, y_faces, z_faces,
    moving_body, ibm_ramp_steps: int = 0,
):
    """Explicit-comm stretched 3D MAC step for a moving body
    (ibm.MovingBody3D) in a quiescent free-slip box — the sharded twin
    of mac_stretched3d.make_step's moving_body (central scheme): masks
    from per-axis coordinate LUTs, volume-weighted psum'd forces.
    Completes the {2D,3D} x {uniform,stretched} sharded moving-body
    matrix."""
    from cfdsim_tpu.parallel.mac3d_explicit import free_slip3d_local_bcs

    bcs = free_slip3d_local_bcs(cfg.nx, cfg.ny)
    return jax.jit(make_stretched3d_explicit_step(
        cfg, mesh, x_faces, y_faces, z_faces, bcs,
        moving_body=moving_body, ibm_ramp_steps=ibm_ramp_steps,
    ))
