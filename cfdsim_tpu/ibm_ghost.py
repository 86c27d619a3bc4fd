"""Ghost-cell direct-forcing IBM — the sharp-interface wall treatment.

The volume-penalization masks (ibm.sphere_masks_faces, the JAX habitat
of the reference's IBM forcing v5.py:275-283) enforce no-slip on a
STAIRCASE surface smeared over one taper width: the effective radius is
R + O(h/2) and the first-cell velocity profile is pinned to zero across
the taper, so the wall shear — and with it the separation point on a
bluff body — carries an O(h) bias. The BENCHNOTES Re=3900 sphere ladder
quantifies the consequence: Cd +31% → +23% from 58 → 91 cells/D,
converging only ~1st-order in near-wall resolution because the laminar
boundary layer (δ ≈ D/√Re ≈ 1.5 cells) is set by the staircase.

This module is the second-order fix (Fadlun et al. 2000 / ghost-cell
direct forcing, Mittal & Iaccarino 2005 §4): instead of braking the
fluid over a smeared shell, faces just INSIDE the body ("ghost faces")
are assigned the linear reflection of the flow sampled along the
outward surface normal,

    u_ghost = -(R - d)/δ · u(x_probe),   x_probe = c + r̂ (R + δ),

so that linear interpolation between the probe and the ghost face puts
u = 0 exactly ON the sphere surface r = R — the wall lands at the
right place to second order regardless of the staircase. Faces deeper
inside are zeroed. Everything is precomputed on the host (distance
classification, probe trilinear stencils into the face arrays as
static flat-index gathers), so the per-step cost is two M-point
gather/scatter passes over ~surface-count faces — accelerator-friendly static
shapes, no data-dependent control flow.

Static geometry uses host-precomputed stencils (``sphere_ghost_ibm`` /
``cylinder_ghost_ibm``); MOVING bodies use the fully-on-device
``moving_ghost_forcing_*`` family below, which recomputes
classification, normals, and probe stencils elementwise each call from
``center`` (Galilean-validated; Dütsch KC=5 — BENCHNOTES).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class GhostFaceSet(NamedTuple):
    """Precomputed ghost-cell forcing data for ONE staggered component.

    solid: dense (nz', ny', nx') BOOL mask, True on faces strictly
        inside the body (zeroed); ghost faces are NOT in it. Kept
        boolean so the closed-over constant is 1 byte/face and never
        const-folds into a second f32 copy of the full-resolution
        (320×160×160) sphere.
    gz/gy/gx: (M,) int32 indices of the ghost faces.
    pidx: (M, 8) int32 flat indices of the trilinear probe corners.
    pw: (M, 8) f32 trilinear weights (rows sum to 1).
    scale: (M,) f32 reflection factor (R - d_ghost)/δ clipped to [0, 1]
        (the clip matters on stretched grids where a ghost face in a
        coarse region can sit deeper than the global δ — ADVICE r3).
    """

    solid: jnp.ndarray
    gz: jnp.ndarray
    gy: jnp.ndarray
    gx: jnp.ndarray
    pidx: jnp.ndarray
    pw: jnp.ndarray
    scale: jnp.ndarray


class GhostIBM3D(NamedTuple):
    u: GhostFaceSet
    v: GhostFaceSet
    w: GhostFaceSet


def _ghost_face_set(xs, ys, zs, center, radius: float,
                    delta: float) -> GhostFaceSet:
    """Classify one component's sample points (coordinate vectors xs,
    ys, zs — its own axis at faces, the other two at centers) and build
    the probe stencils. Host-side numpy, float64."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    zs = np.asarray(zs, np.float64)
    cx, cy, cz = (float(c) for c in center)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    px, py, pz = X - cx, Y - cy, Z - cz
    d = np.sqrt(px * px + py * py + pz * pz)
    inside = d <= radius
    # ghost = inside faces with a fluid face among the 6 axis neighbors
    # (edge-padded so domain boundaries never spawn ghosts; the body is
    # assumed interior to the domain)
    outside = ~inside
    near_fluid = np.zeros_like(inside)
    for ax in range(3):
        pad = [(1, 1) if a == ax else (0, 0) for a in range(3)]
        o = np.pad(outside, pad, mode="edge")
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(0, -2)
        hi[ax] = slice(2, None)
        near_fluid |= o[tuple(lo)] | o[tuple(hi)]
    ghost = inside & near_fluid
    solid = inside & ~near_fluid

    gz, gy, gx = np.nonzero(ghost)
    d_g = d[gz, gy, gx]
    # outward normal at each ghost face; d_g > 0 always (the exact
    # center is deep solid for any radius > the local spacing)
    inv = 1.0 / np.maximum(d_g, 1e-12)
    nxv = px[gz, gy, gx] * inv
    nyv = py[gz, gy, gx] * inv
    nzv = pz[gz, gy, gx] * inv
    qx = cx + nxv * (radius + delta)
    qy = cy + nyv * (radius + delta)
    qz = cz + nzv * (radius + delta)
    # Clip to [0, 1]: δ is GLOBAL (1.5·h_min), so on a stretched grid a
    # ghost face sitting in a coarser region can lie deeper than δ below
    # the surface; an unclipped (R-d)/δ > 1 amplifies the reflection and
    # can destabilize (ADVICE r3). Clipping saturates the mirror at the
    # full-reflection limit instead.
    scale = np.clip((radius - d_g) / delta, 0.0, 1.0)

    def locate(q, s):
        i = np.clip(np.searchsorted(s, q) - 1, 0, len(s) - 2)
        t = (q - s[i]) / (s[i + 1] - s[i])
        return i, np.clip(t, 0.0, 1.0)

    ix, tx = locate(qx, xs)
    iy, ty = locate(qy, ys)
    iz, tz = locate(qz, zs)
    ny_, nx_ = len(ys), len(xs)

    def flat(k, j, i):
        return (k * ny_ + j) * nx_ + i

    idx_cols, w_cols = [], []
    for a in (0, 1):
        wz = tz if a else 1.0 - tz
        for b in (0, 1):
            wy = ty if b else 1.0 - ty
            for c in (0, 1):
                wx = tx if c else 1.0 - tx
                idx_cols.append(flat(iz + a, iy + b, ix + c))
                w_cols.append(wz * wy * wx)
    return GhostFaceSet(
        solid=jnp.asarray(solid, jnp.bool_),
        gz=jnp.asarray(gz, jnp.int32),
        gy=jnp.asarray(gy, jnp.int32),
        gx=jnp.asarray(gx, jnp.int32),
        pidx=jnp.asarray(np.stack(idx_cols, axis=-1), jnp.int32),
        pw=jnp.asarray(np.stack(w_cols, axis=-1), jnp.float32),
        scale=jnp.asarray(scale, jnp.float32),
    )


def sphere_ghost_ibm(x_faces, y_faces, z_faces, center, radius: float,
                     probe_dist: float | None = None) -> GhostIBM3D:
    """Ghost-cell IBM stencils for a static sphere on the 3D staggered
    layout of an arbitrary tensor-product grid (uniform or stretched;
    same face-vector convention as ibm.sphere_masks_faces).

    ``probe_dist`` δ is the normal distance of the fluid sample outside
    the surface (default 1.5× the minimum spacing — outside the
    first-cell staircase, inside the resolved region). The reflection
    u_g = -(R-d)/δ·u(probe) places the no-slip wall exactly at r = R;
    combined with zeroing of the deeper interior this is the standard
    direct-forcing sharp-interface IBM."""
    xf = np.asarray(x_faces, np.float64)
    yf = np.asarray(y_faces, np.float64)
    zf = np.asarray(z_faces, np.float64)
    xc = 0.5 * (xf[:-1] + xf[1:])
    yc = 0.5 * (yf[:-1] + yf[1:])
    zc = 0.5 * (zf[:-1] + zf[1:])
    if probe_dist is None:
        probe_dist = 1.5 * float(
            min(np.diff(xf).min(), np.diff(yf).min(), np.diff(zf).min())
        )
    return GhostIBM3D(
        u=_ghost_face_set(xf, yc, zc, center, radius, probe_dist),
        v=_ghost_face_set(xc, yf, zc, center, radius, probe_dist),
        w=_ghost_face_set(xc, yc, zf, center, radius, probe_dist),
    )


class GhostFaceSet2D(NamedTuple):
    """2D analog of GhostFaceSet: (ny', nx') fields, bilinear probes."""

    solid: jnp.ndarray           # (ny', nx') bool
    gy: jnp.ndarray              # (M,) int32
    gx: jnp.ndarray
    pidx: jnp.ndarray            # (M, 4) int32 flat bilinear corners
    pw: jnp.ndarray              # (M, 4) f32
    scale: jnp.ndarray           # (M,) f32


class GhostIBM2D(NamedTuple):
    u: GhostFaceSet2D
    v: GhostFaceSet2D


def _ghost_face_set_2d(xs, ys, center, radius: float,
                       delta: float) -> GhostFaceSet2D:
    """2D classification + bilinear probe stencils; arrays are (ny, nx)
    row-major with x on the last axis (the repo's 2D convention)."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    cx, cy = float(center[0]), float(center[1])
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    px, py = X - cx, Y - cy
    d = np.sqrt(px * px + py * py)
    inside = d <= radius
    outside = ~inside
    near_fluid = np.zeros_like(inside)
    for ax in range(2):
        pad = [(1, 1) if a == ax else (0, 0) for a in range(2)]
        o = np.pad(outside, pad, mode="edge")
        lo = [slice(None)] * 2
        hi = [slice(None)] * 2
        lo[ax] = slice(0, -2)
        hi[ax] = slice(2, None)
        near_fluid |= o[tuple(lo)] | o[tuple(hi)]
    ghost = inside & near_fluid
    solid = inside & ~near_fluid

    gy, gx = np.nonzero(ghost)
    d_g = d[gy, gx]
    inv = 1.0 / np.maximum(d_g, 1e-12)
    nxv = px[gy, gx] * inv
    nyv = py[gy, gx] * inv
    qx = cx + nxv * (radius + delta)
    qy = cy + nyv * (radius + delta)
    scale = np.clip((radius - d_g) / delta, 0.0, 1.0)  # see 3D note

    def locate(q, s):
        i = np.clip(np.searchsorted(s, q) - 1, 0, len(s) - 2)
        t = (q - s[i]) / (s[i + 1] - s[i])
        return i, np.clip(t, 0.0, 1.0)

    ix, tx = locate(qx, xs)
    iy, ty = locate(qy, ys)
    nx_ = len(xs)
    idx_cols, w_cols = [], []
    for b in (0, 1):
        wy = ty if b else 1.0 - ty
        for c in (0, 1):
            wx = tx if c else 1.0 - tx
            idx_cols.append((iy + b) * nx_ + (ix + c))
            w_cols.append(wy * wx)
    return GhostFaceSet2D(
        solid=jnp.asarray(solid, jnp.bool_),
        gy=jnp.asarray(gy, jnp.int32),
        gx=jnp.asarray(gx, jnp.int32),
        pidx=jnp.asarray(np.stack(idx_cols, axis=-1), jnp.int32),
        pw=jnp.asarray(np.stack(w_cols, axis=-1), jnp.float32),
        scale=jnp.asarray(scale, jnp.float32),
    )


def cylinder_ghost_ibm(x_faces, y_faces, center, radius: float,
                       probe_dist: float | None = None) -> GhostIBM2D:
    """Ghost-cell IBM stencils for a static cylinder on the 2D MAC
    layout (u at (ny, nx+1) x-faces, v at (ny+1, nx) y-faces) of an
    arbitrary tensor-product grid — the 2D habitat of
    ``sphere_ghost_ibm``, fixing the sharp-mask drag bias the static
    cylinder rows carry (Cd +10-16% at 30 cells/D, BENCHNOTES
    "Moving-geometry IBM")."""
    xf = np.asarray(x_faces, np.float64)
    yf = np.asarray(y_faces, np.float64)
    xc = 0.5 * (xf[:-1] + xf[1:])
    yc = 0.5 * (yf[:-1] + yf[1:])
    if probe_dist is None:
        probe_dist = 1.5 * float(
            min(np.diff(xf).min(), np.diff(yf).min())
        )
    return GhostIBM2D(
        u=_ghost_face_set_2d(xf, yc, center, radius, probe_dist),
        v=_ghost_face_set_2d(xc, yf, center, radius, probe_dist),
    )


def apply_ghost_forcing_2d(field, gs: GhostFaceSet2D, strength,
                           sweeps: int = 2):
    """2D ``apply_ghost_forcing``: same contract, bilinear probes."""
    tgt = jnp.where(gs.solid, jnp.float32(0.0), field)
    for _ in range(sweeps):
        probe = jnp.sum(
            jnp.take(tgt.reshape(-1), gs.pidx, axis=0) * gs.pw, axis=-1
        )
        tgt = tgt.at[gs.gy, gs.gx].set(-gs.scale * probe)
    out = field - strength * (field - tgt)
    return out, field - out


def moving_ghost_forcing_2d(field, X, Y, x0: float, dx: float, y0: float,
                            dy: float, center, radius: float, delta: float,
                            u_b, strength, sweeps: int = 2):
    """Ghost-cell direct forcing for a MOVING body on a UNIFORM 2D face
    set, fully on device (the moving-body analog of
    ``apply_ghost_forcing_2d`` — classification, normals, and bilinear
    probe stencils recomputed elementwise each call from ``center``;
    closed-form floor-arithmetic corner lookup, so no host precompute
    and no data-dependent shapes).

    X/Y are the face-sample coordinate grids of ``field`` (the same
    arrays the moving-penalization mask rebuild closes over), (x0, y0)
    the coordinates of sample (0, 0) and (dx, dy) the uniform spacings.
    The wall condition is u(r=R) = u_b: ghosts take
    u_g = u_b − (R−d)/δ · (u(probe) − u_b), the solid interior is
    pinned to u_b. Returns (field_out, du) with the usual
    momentum-exchange accounting."""
    cx, cy = center
    px, py = X - cx, Y - cy
    d = jnp.sqrt(px * px + py * py)
    inside = d <= radius
    outside = ~inside
    o = jnp.pad(outside, 1, mode="edge")
    near = o[1:-1, :-2] | o[1:-1, 2:] | o[:-2, 1:-1] | o[2:, 1:-1]
    ghost = inside & near
    solid = inside & ~near

    inv = 1.0 / jnp.maximum(d, 1e-12)
    qx = cx + px * inv * (radius + delta)
    qy = cy + py * inv * (radius + delta)
    scale = jnp.clip((radius - d) / delta, 0.0, 1.0)

    ny_, nx_ = field.shape
    gx = jnp.clip((qx - x0) / dx, 0.0, nx_ - 1.001)
    gy = jnp.clip((qy - y0) / dy, 0.0, ny_ - 1.001)
    ix = jnp.floor(gx).astype(jnp.int32)
    tx = gx - ix
    iy = jnp.floor(gy).astype(jnp.int32)
    ty = gy - iy
    base = iy * nx_ + ix

    def gather(f):
        fl = f.reshape(-1)
        v00 = fl[base]
        v01 = fl[base + 1]
        v10 = fl[base + nx_]
        v11 = fl[base + nx_ + 1]
        return ((1.0 - ty) * ((1.0 - tx) * v00 + tx * v01)
                + ty * ((1.0 - tx) * v10 + tx * v11))

    tgt = jnp.where(solid, u_b, field)
    for _ in range(sweeps):
        probe = gather(tgt)
        u_g = u_b - scale * (probe - u_b)
        tgt = jnp.where(ghost, u_g, jnp.where(solid, u_b, field))
    out = field - strength * (field - tgt)
    return out, field - out


def moving_ghost_forcing_2d_nonuniform(field, X, Y, xs, ys, center,
                                       radius: float, delta: float, u_b,
                                       strength, sweeps: int = 2):
    """``moving_ghost_forcing_2d`` on a NONUNIFORM tensor-product face
    set: the probe cell is located with an on-device searchsorted into
    the 1D sample-coordinate vectors ``xs``/``ys`` (closed-over
    constants — fine under single-device jit; the shard_map
    closed-over-gather miscompile keeps this off the sharded paths).
    The stretched moving-body tier's habitat (Dütsch at 70 cells/D)."""
    cx, cy = center
    px, py = X - cx, Y - cy
    d = jnp.sqrt(px * px + py * py)
    inside = d <= radius
    outside = ~inside
    o = jnp.pad(outside, 1, mode="edge")
    near = o[1:-1, :-2] | o[1:-1, 2:] | o[:-2, 1:-1] | o[2:, 1:-1]
    ghost = inside & near
    solid = inside & ~near

    inv = 1.0 / jnp.maximum(d, 1e-12)
    qx = cx + px * inv * (radius + delta)
    qy = cy + py * inv * (radius + delta)
    scale = jnp.clip((radius - d) / delta, 0.0, 1.0)

    ny_, nx_ = field.shape
    xs_ = jnp.asarray(xs, jnp.float32)
    ys_ = jnp.asarray(ys, jnp.float32)
    ix = jnp.clip(jnp.searchsorted(xs_, qx, side="right") - 1, 0, nx_ - 2)
    iy = jnp.clip(jnp.searchsorted(ys_, qy, side="right") - 1, 0, ny_ - 2)
    x_lo = xs_[ix]
    y_lo = ys_[iy]
    tx = jnp.clip((qx - x_lo) / (xs_[ix + 1] - x_lo), 0.0, 1.0)
    ty = jnp.clip((qy - y_lo) / (ys_[iy + 1] - y_lo), 0.0, 1.0)
    base = iy * nx_ + ix

    def gather(f):
        fl = f.reshape(-1)
        v00 = fl[base]
        v01 = fl[base + 1]
        v10 = fl[base + nx_]
        v11 = fl[base + nx_ + 1]
        return ((1.0 - ty) * ((1.0 - tx) * v00 + tx * v01)
                + ty * ((1.0 - tx) * v10 + tx * v11))

    tgt = jnp.where(solid, u_b, field)
    for _ in range(sweeps):
        probe = gather(tgt)
        u_g = u_b - scale * (probe - u_b)
        tgt = jnp.where(ghost, u_g, jnp.where(solid, u_b, field))
    out = field - strength * (field - tgt)
    return out, field - out


def moving_ghost_forcing_3d(field, X, Y, Z, origin, spacing, center,
                            radius: float, delta: float, u_b, strength,
                            sweeps: int = 2):
    """3D ``moving_ghost_forcing_2d``: ghost-cell direct forcing for a
    MOVING sphere on a UNIFORM 3D face set, classification and
    trilinear probe stencils recomputed on device each call from
    ``center``. ``origin``/``spacing`` are the (x, y, z) coordinate of
    sample (0, 0, 0) and the uniform spacings of this face set (X/Y/Z
    its coordinate grids, the moving-penalization rebuild arrays)."""
    cx, cy, cz = center
    px, py, pz = X - cx, Y - cy, Z - cz
    d = jnp.sqrt(px * px + py * py + pz * pz)
    inside = d <= radius
    outside = ~inside
    o = jnp.pad(outside, 1, mode="edge")
    near = (
        o[1:-1, 1:-1, :-2] | o[1:-1, 1:-1, 2:]
        | o[1:-1, :-2, 1:-1] | o[1:-1, 2:, 1:-1]
        | o[:-2, 1:-1, 1:-1] | o[2:, 1:-1, 1:-1]
    )
    ghost = inside & near
    solid = inside & ~near

    inv = 1.0 / jnp.maximum(d, 1e-12)
    qx = cx + px * inv * (radius + delta)
    qy = cy + py * inv * (radius + delta)
    qz = cz + pz * inv * (radius + delta)
    scale = jnp.clip((radius - d) / delta, 0.0, 1.0)

    nz_, ny_, nx_ = field.shape
    x0, y0, z0 = origin
    dx, dy, dz = spacing
    gx = jnp.clip((qx - x0) / dx, 0.0, nx_ - 1.001)
    gy = jnp.clip((qy - y0) / dy, 0.0, ny_ - 1.001)
    gz = jnp.clip((qz - z0) / dz, 0.0, nz_ - 1.001)
    ix = jnp.floor(gx).astype(jnp.int32)
    tx = gx - ix
    iy = jnp.floor(gy).astype(jnp.int32)
    ty = gy - iy
    iz = jnp.floor(gz).astype(jnp.int32)
    tz = gz - iz
    base = (iz * ny_ + iy) * nx_ + ix
    sy, sz = nx_, ny_ * nx_

    def gather(f):
        fl = f.reshape(-1)

        def plane(b):
            return ((1.0 - ty) * ((1.0 - tx) * fl[b] + tx * fl[b + 1])
                    + ty * ((1.0 - tx) * fl[b + sy] + tx * fl[b + sy + 1]))

        return (1.0 - tz) * plane(base) + tz * plane(base + sz)

    tgt = jnp.where(solid, u_b, field)
    for _ in range(sweeps):
        probe = gather(tgt)
        u_g = u_b - scale * (probe - u_b)
        tgt = jnp.where(ghost, u_g, jnp.where(solid, u_b, field))
    out = field - strength * (field - tgt)
    return out, field - out


def moving_ghost_forcing_3d_nonuniform(field, X, Y, Z, xs, ys, zs,
                                       center, radius: float,
                                       delta: float, u_b, strength,
                                       sweeps: int = 2):
    """``moving_ghost_forcing_3d`` on a NONUNIFORM tensor-product face
    set (searchsorted probe lookup into the 1D coordinate vectors —
    the stretched-3D moving-body tier's habitat)."""
    cx, cy, cz = center
    px, py, pz = X - cx, Y - cy, Z - cz
    d = jnp.sqrt(px * px + py * py + pz * pz)
    inside = d <= radius
    outside = ~inside
    o = jnp.pad(outside, 1, mode="edge")
    near = (
        o[1:-1, 1:-1, :-2] | o[1:-1, 1:-1, 2:]
        | o[1:-1, :-2, 1:-1] | o[1:-1, 2:, 1:-1]
        | o[:-2, 1:-1, 1:-1] | o[2:, 1:-1, 1:-1]
    )
    ghost = inside & near
    solid = inside & ~near

    inv = 1.0 / jnp.maximum(d, 1e-12)
    qx = cx + px * inv * (radius + delta)
    qy = cy + py * inv * (radius + delta)
    qz = cz + pz * inv * (radius + delta)
    scale = jnp.clip((radius - d) / delta, 0.0, 1.0)

    nz_, ny_, nx_ = field.shape
    xs_ = jnp.asarray(xs, jnp.float32)
    ys_ = jnp.asarray(ys, jnp.float32)
    zs_ = jnp.asarray(zs, jnp.float32)
    ix = jnp.clip(jnp.searchsorted(xs_, qx, side="right") - 1, 0, nx_ - 2)
    iy = jnp.clip(jnp.searchsorted(ys_, qy, side="right") - 1, 0, ny_ - 2)
    iz = jnp.clip(jnp.searchsorted(zs_, qz, side="right") - 1, 0, nz_ - 2)
    tx = jnp.clip((qx - xs_[ix]) / (xs_[ix + 1] - xs_[ix]), 0.0, 1.0)
    ty = jnp.clip((qy - ys_[iy]) / (ys_[iy + 1] - ys_[iy]), 0.0, 1.0)
    tz = jnp.clip((qz - zs_[iz]) / (zs_[iz + 1] - zs_[iz]), 0.0, 1.0)
    base = (iz * ny_ + iy) * nx_ + ix
    sy, sz = nx_, ny_ * nx_

    def gather(f):
        fl = f.reshape(-1)

        def plane(b):
            return ((1.0 - ty) * ((1.0 - tx) * fl[b] + tx * fl[b + 1])
                    + ty * ((1.0 - tx) * fl[b + sy] + tx * fl[b + sy + 1]))

        return (1.0 - tz) * plane(base) + tz * plane(base + sz)

    tgt = jnp.where(solid, u_b, field)
    for _ in range(sweeps):
        probe = gather(tgt)
        u_g = u_b - scale * (probe - u_b)
        tgt = jnp.where(ghost, u_g, jnp.where(solid, u_b, field))
    out = field - strength * (field - tgt)
    return out, field - out


def sphere_ghost_cells(x_faces, y_faces, z_faces, center, radius: float,
                       probe_dist: float | None = None) -> GhostFaceSet:
    """Cell-centered ghost stencils for a Dirichlet scalar on the same
    sphere (the θ habitat of ``sphere_ghost_ibm`` — an isothermal body
    in models/transport3d.py). Apply to the SHIFTED field θ - θ_body:
    the homogeneous reflection then places θ = θ_body exactly on r = R,
    replacing the cell-mask penalization's staircase (the source of the
    Nusselt over-report that grows with Re — BENCHNOTES forced-
    convection table)."""
    xf = np.asarray(x_faces, np.float64)
    yf = np.asarray(y_faces, np.float64)
    zf = np.asarray(z_faces, np.float64)
    xc = 0.5 * (xf[:-1] + xf[1:])
    yc = 0.5 * (yf[:-1] + yf[1:])
    zc = 0.5 * (zf[:-1] + zf[1:])
    if probe_dist is None:
        probe_dist = 1.5 * float(
            min(np.diff(xf).min(), np.diff(yf).min(), np.diff(zf).min())
        )
    return _ghost_face_set(xc, yc, zc, center, radius, probe_dist)


def apply_ghost_forcing(field, gs: GhostFaceSet, strength,
                        sweeps: int = 2):
    """One direct-forcing application on a single component field:
    returns (field_out, du) with du = field - field_out (the momentum
    the body removed — Σ du·V/dt is the force on the fluid, same
    accounting as the penalization sink in models/mac_stretched3d.py).

    The target field zeroes solid faces and installs the reflected
    ghost values; ``sweeps`` Jacobi passes let probe stencils whose
    corners touch other ghost faces converge (2 suffices: corner
    weights of in-body points are small by construction). ``strength``
    is the usual IBM ramp ∈ [0, 1]."""
    tgt = jnp.where(gs.solid, jnp.float32(0.0), field)
    for _ in range(sweeps):
        probe = jnp.sum(
            jnp.take(tgt.reshape(-1), gs.pidx, axis=0) * gs.pw, axis=-1
        )
        tgt = tgt.at[gs.gz, gs.gy, gs.gx].set(-gs.scale * probe)
    out = field - strength * (field - tgt)
    return out, field - out


__all__ = [
    "GhostFaceSet",
    "GhostFaceSet2D",
    "GhostIBM2D",
    "GhostIBM3D",
    "cylinder_ghost_ibm",
    "moving_ghost_forcing_2d",
    "moving_ghost_forcing_2d_nonuniform",
    "moving_ghost_forcing_3d",
    "moving_ghost_forcing_3d_nonuniform",
    "sphere_ghost_ibm",
    "sphere_ghost_cells",
    "apply_ghost_forcing",
    "apply_ghost_forcing_2d",
]
