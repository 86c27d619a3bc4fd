"""Immersed-boundary geometry: solid masks, smooth IBM forcing shells,
and potential-flow initialization.

JAX equivalents of the reference's mask builders
(``setup_boundary_masks`` v5.py:275-283, ``setup_wedge`` v1_shock.py:240-248,
cavity mask cavity_flow_v1.py:264-273) and ``initialize_potential_flow``
(v5.py:299-314). Masks are computed once with NumPy at setup time and
captured as constants by the jitted step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import jax.numpy as jnp

from cfdsim_tpu.grid import Grid


def cylinder_masks(grid: Grid, center: tuple[float, float], radius: float):
    """(solid_mask bool, ibm_mask float) for an embedded cylinder.

    The IBM mask is 1 inside the body and decays as a Gaussian shell
    exp(−((r−R)/2dx)²) out to R+5dx (reference v5.py:275-283), giving the
    smooth penalization force profile.
    """
    X, Y = grid.meshgrid()
    dist = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2)
    solid = dist <= radius
    sigma = 2.0 * grid.dx
    shell = np.exp(-(((dist - radius) / sigma) ** 2))
    ibm = np.where(dist < radius, 1.0, np.where(dist < radius + 5 * grid.dx, shell, 0.0))
    return jnp.asarray(solid), jnp.asarray(ibm, jnp.float32)


def _gaussian_shell(dist, radius, dx):
    sigma = 2.0 * dx
    shell = np.exp(-(((dist - radius) / sigma) ** 2))
    return np.where(
        dist < radius, 1.0, np.where(dist < radius + 5 * dx, shell, 0.0)
    )


def cylinder_masks_mac(grid: Grid, center: tuple[float, float],
                       radius: float, profile: str = "shell"):
    """Face-sampled IBM masks for the staggered (MAC) layout, at u-face
    locations (ny, nx+1) and v-face locations (ny+1, nx) of a
    cell-centered grid.

    ``profile="shell"`` (default): the reference's Gaussian shell
    (v5.py:275-283) — the validated shedding/Strouhal configuration, but
    the shell pads the body by ~2dx so its penalization force
    over-reports drag (Cd 2.04 vs the sharp 1.45 at Re=100, 20 cells/D
    — BENCHNOTES "Moving-geometry IBM"). ``profile="sharp"``: 1 inside
    with a half-cell taper — quantitative forces (Cd within ~7% of the
    unconfined literature), the 2D analog of ``sphere_masks_faces``."""
    nx, ny = grid.nx, grid.ny
    dx, dy = grid.dx, grid.dy
    xu = grid.x_min + np.arange(nx + 1) * dx
    yu = grid.y_min + (np.arange(ny) + 0.5) * dy
    Xu, Yu = np.meshgrid(xu, yu, indexing="xy")
    xv = grid.x_min + (np.arange(nx) + 0.5) * dx
    yv = grid.y_min + np.arange(ny + 1) * dy
    Xv, Yv = np.meshgrid(xv, yv, indexing="xy")
    du = np.sqrt((Xu - center[0]) ** 2 + (Yu - center[1]) ** 2)
    dv = np.sqrt((Xv - center[0]) ** 2 + (Yv - center[1]) ** 2)
    if profile == "sharp":
        def shape(d):
            return np.clip((radius + 0.5 * dx - d) / dx, 0.0, 1.0)
    elif profile == "shell":
        def shape(d):
            return _gaussian_shell(d, radius, dx)
    else:
        raise ValueError(f"unknown IBM mask profile {profile!r}")
    return (
        jnp.asarray(shape(du), jnp.float32),
        jnp.asarray(shape(dv), jnp.float32),
    )


def sphere_masks_faces(x_faces, y_faces, z_faces, center, radius: float,
                       profile: str = "sharp", width: float | None = None):
    """Face-sampled IBM masks for the 3D staggered layout on an arbitrary
    tensor-product grid given by the three face-coordinate vectors
    (uniform or stretched): u faces (nz, ny, nx+1), v faces
    (nz, ny+1, nx), w faces (nz+1, ny, nx).

    ``profile="sharp"`` (default): 1 inside r < R with a half-cell
    linear taper of width ``width`` (default: the minimum spacing across
    the three axes — the near-body resolution on a graded grid) — the
    effective radius is R + O(width/2), so the penalization momentum
    sink is a *quantitative* drag measurement (validated against
    Schiller–Naumann, examples/sphere_wake.py).
    ``profile="shell"``: the reference's Gaussian shell
    (``cylinder_masks_mac``, v5.py:275-283), which pads the body by
    ~2·width of parasitic forcing — smoother but only qualitative in
    force."""
    xf = np.asarray(x_faces, np.float64)
    yf = np.asarray(y_faces, np.float64)
    zf = np.asarray(z_faces, np.float64)
    xc = 0.5 * (xf[:-1] + xf[1:])
    yc = 0.5 * (yf[:-1] + yf[1:])
    zc = 0.5 * (zf[:-1] + zf[1:])
    if width is None:
        width = float(
            min(np.diff(xf).min(), np.diff(yf).min(), np.diff(zf).min())
        )
    cx, cy, cz = center

    def dist(xs, ys, zs):
        Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
        return np.sqrt((X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2)

    if profile == "sharp":
        def shape(d):
            return np.clip((radius + 0.5 * width - d) / width, 0.0, 1.0)
    elif profile == "shell":
        def shape(d):
            return _gaussian_shell(d, radius, width)
    else:
        raise ValueError(f"unknown IBM mask profile {profile!r}")

    return (
        jnp.asarray(shape(dist(xf, yc, zc)), jnp.float32),
        jnp.asarray(shape(dist(xc, yf, zc)), jnp.float32),
        jnp.asarray(shape(dist(xc, yc, zf)), jnp.float32),
    )


def sphere_mask_cells(x_faces, y_faces, z_faces, center, radius: float,
                      profile: str = "sharp", width: float | None = None):
    """Cell-centered sphere mask (nz, ny, nx) — the θ-penalization mask
    for isothermal immersed bodies (models/transport3d.py); same
    profiles as ``sphere_masks_faces``."""
    xf = np.asarray(x_faces, np.float64)
    yf = np.asarray(y_faces, np.float64)
    zf = np.asarray(z_faces, np.float64)
    xc = 0.5 * (xf[:-1] + xf[1:])
    yc = 0.5 * (yf[:-1] + yf[1:])
    zc = 0.5 * (zf[:-1] + zf[1:])
    if width is None:
        width = float(
            min(np.diff(xf).min(), np.diff(yf).min(), np.diff(zf).min())
        )
    Z, Y, X = np.meshgrid(zc, yc, xc, indexing="ij")
    d = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2
                + (Z - center[2]) ** 2)
    if profile == "sharp":
        m = np.clip((radius + 0.5 * width - d) / width, 0.0, 1.0)
    elif profile == "shell":
        m = _gaussian_shell(d, radius, width)
    else:
        raise ValueError(f"unknown IBM mask profile {profile!r}")
    return jnp.asarray(m, jnp.float32)


def sphere_masks_mac3d(grid, center, radius: float, profile: str = "sharp"):
    """``sphere_masks_faces`` on a uniform cell-centered ``Grid3D``."""
    xf = grid.x_min + np.arange(grid.nx + 1) * grid.dx
    yf = grid.y_min + np.arange(grid.ny + 1) * grid.dy
    zf = grid.z_min + np.arange(grid.nz + 1) * grid.dz
    return sphere_masks_faces(
        xf, yf, zf, center, radius, profile=profile, width=grid.dx
    )


def potential_flow_sphere_faces(
    x_faces, y_faces, z_faces, center, radius: float, v_inf: float,
    mask_u, mask_v, mask_w, width: float | None = None,
):
    """Potential-flow initial condition around a sphere on 3D MAC faces
    of an arbitrary tensor-product grid (the 3D habitat of
    ``potential_flow_cylinder_mac``): velocity potential
    φ = V·x·(1 + R³/2r³), so u = V(1 + R³/2r³ − 3R³x²/2r⁵) and
    v,w = −3VR³·x·{y,z}/2r⁵ (x,y,z body-relative). Near/inside the body
    the field is blended to the IBM no-slip state exactly as the 2D
    version (reference init v5.py:299-314); the blend length scales
    with ``width`` (default: the minimum grid spacing)."""
    xf = np.asarray(x_faces, np.float64)
    yf = np.asarray(y_faces, np.float64)
    zf = np.asarray(z_faces, np.float64)
    xc = 0.5 * (xf[:-1] + xf[1:])
    yc = 0.5 * (yf[:-1] + yf[1:])
    zc = 0.5 * (zf[:-1] + zf[1:])
    if width is None:
        width = float(
            min(np.diff(xf).min(), np.diff(yf).min(), np.diff(zf).min())
        )
    cx, cy, cz = center

    def fields(xs, ys, zs):
        Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
        X, Y, Z = X - cx, Y - cy, Z - cz
        r = np.maximum(np.sqrt(X**2 + Y**2 + Z**2), 1e-10)
        fac = radius**3 / (2.0 * r**3)
        u = v_inf * (1.0 + fac - 3.0 * fac * X * X / r**2)
        v = -3.0 * v_inf * fac * X * Y / r**2
        w = -3.0 * v_inf * fac * X * Z / r**2
        blend = np.minimum(1.0, ((r - radius) / (4.0 * width)) ** 2)
        near = r <= radius + 4.0 * width
        u = np.where(near, v_inf * blend, u)
        v = np.where(near, 0.0, v)
        w = np.where(near, 0.0, w)
        return u, v, w

    u0, _, _ = fields(xf, yc, zc)
    _, v0, _ = fields(xc, yf, zc)
    _, _, w0 = fields(xc, yc, zf)
    u0 = u0 * (1.0 - np.asarray(mask_u))
    v0 = v0 * (1.0 - np.asarray(mask_v))
    w0 = w0 * (1.0 - np.asarray(mask_w))
    return (
        jnp.asarray(u0, jnp.float32),
        jnp.asarray(v0, jnp.float32),
        jnp.asarray(w0, jnp.float32),
    )


def potential_flow_sphere_mac3d(
    grid, center, radius: float, v_inf: float, mask_u, mask_v, mask_w
):
    """``potential_flow_sphere_faces`` on a uniform cell-centered
    ``Grid3D``."""
    xf = grid.x_min + np.arange(grid.nx + 1) * grid.dx
    yf = grid.y_min + np.arange(grid.ny + 1) * grid.dy
    zf = grid.z_min + np.arange(grid.nz + 1) * grid.dz
    return potential_flow_sphere_faces(
        xf, yf, zf, center, radius, v_inf, mask_u, mask_v, mask_w,
        width=grid.dx,
    )


def potential_flow_cylinder_mac(
    grid: Grid, center: tuple[float, float], radius: float, v_inf: float,
    mask_u, mask_v,
):
    """Potential-flow initial condition on MAC faces (face-sampled version
    of ``potential_flow_cylinder``, reference v5.py:299-314)."""
    nx, ny = grid.nx, grid.ny
    dx, dy = grid.dx, grid.dy

    def fields(X, Y):
        r = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2)
        th = np.arctan2(Y - center[1], X - center[0])
        fac = (radius / np.maximum(r, 1e-10)) ** 2
        u = v_inf * (1.0 - fac * np.cos(2.0 * th))
        v = -v_inf * fac * np.sin(2.0 * th)
        blend = np.minimum(1.0, ((r - radius) / (4.0 * dx)) ** 2)
        near = r <= radius + 4.0 * dx
        u = np.where(near, v_inf * blend, u)
        v = np.where(near, 0.0, v)
        return u, v

    xu = grid.x_min + np.arange(nx + 1) * dx
    yu = grid.y_min + (np.arange(ny) + 0.5) * dy
    Xu, Yu = np.meshgrid(xu, yu, indexing="xy")
    u0, _ = fields(Xu, Yu)
    xv = grid.x_min + (np.arange(nx) + 0.5) * dx
    yv = grid.y_min + np.arange(ny + 1) * dy
    Xv, Yv = np.meshgrid(xv, yv, indexing="xy")
    _, v0 = fields(Xv, Yv)
    u0 = u0 * (1.0 - np.asarray(mask_u))
    v0 = v0 * (1.0 - np.asarray(mask_v))
    return jnp.asarray(u0, jnp.float32), jnp.asarray(v0, jnp.float32)


def apply_ibm(u, v, ibm_mask, strength):
    """Penalize velocity inside/near the body: q *= (1 − mask·strength).

    Parity: reference ``apply_ibm_fast`` v5.py:228-237; ``strength`` ramps
    0→1 over the initial steps (v5.py:406).
    """
    damp = 1.0 - ibm_mask * strength
    return u * damp, v * damp


class MovingBody(NamedTuple):
    """Time-dependent rigid circular body for the moving-IBM
    penalization (mac.make_step ``moving_body``): the sharp face masks
    are rebuilt ON DEVICE each step from the closed-over face
    coordinates (elementwise — no gathers), and the penalization drives
    the fluid toward the body VELOCITY instead of rest:
    u ← u − s·m·(u − u_b). The reported force is the momentum the body
    exchanges with the fluid, Σ Δu·dA/dt.

    ``center(t) -> (cx, cy)`` and ``velocity(t) -> (ub, vb)`` are traced
    functions of simulation time (use jnp ops)."""

    center: Callable
    velocity: Callable
    radius: float


def oscillating_cylinder(center, radius: float, amplitude: float,
                         period: float, axis: int = 0) -> MovingBody:
    """In-line (axis=0) or transverse (axis=1) harmonic oscillation:
    x_c(t) = x0 + A·sin(2πt/T), the classic Dütsch/KC configuration
    (KC = 2πA/D, Re_max = 2πA·D/(T·ν))."""
    import jax.numpy as _jnp

    x0, y0 = center
    om = 2.0 * np.pi / period

    def c(t):
        d = amplitude * _jnp.sin(om * t)
        return (x0 + d, y0) if axis == 0 else (x0, y0 + d)

    def vel(t):
        s = amplitude * om * _jnp.cos(om * t)
        return (s, _jnp.zeros_like(s)) if axis == 0 else (
            _jnp.zeros_like(s), s)

    return MovingBody(center=c, velocity=vel, radius=radius)


class MovingBody3D(NamedTuple):
    """3D analog of ``MovingBody`` (mac3d.make_step ``moving_body``):
    ``center(t) -> (cx, cy, cz)``, ``velocity(t) -> (ub, vb, wb)``."""

    center: Callable
    velocity: Callable
    radius: float


def oscillating_sphere(center, radius: float, amplitude: float,
                       period: float, axis: int = 0) -> MovingBody3D:
    """Harmonically oscillating sphere along one axis (x/y/z), the 3D
    habitat of ``oscillating_cylinder``."""
    import jax.numpy as _jnp

    c0 = tuple(float(c) for c in center)
    om = 2.0 * np.pi / period

    def c(t):
        d = amplitude * _jnp.sin(om * t)
        out = list(c0)
        out[axis] = c0[axis] + d
        return tuple(out)

    def vel(t):
        s = amplitude * om * _jnp.cos(om * t)
        z = _jnp.zeros_like(s)
        out = [z, z, z]
        out[axis] = s
        return tuple(out)

    return MovingBody3D(center=c, velocity=vel, radius=radius)


def translating_body(center0, velocity, radius: float) -> MovingBody:
    """Constant-velocity rigid body (the Galilean-invariance harness:
    a cylinder translating through still fluid must see the same drag
    as a fixed cylinder in a uniform stream)."""
    x0, y0 = center0
    ub, vb = velocity

    def c(t):
        return (x0 + ub * t, y0 + vb * t)

    def vel(t):
        import jax.numpy as _jnp

        z = _jnp.zeros_like(t)
        return (z + ub, z + vb)

    return MovingBody(center=c, velocity=vel, radius=radius)


def ibm_ramp(step, ramp_steps: int):
    """Force-strength ramp min(1, step/ramp_steps); 1 if no ramp."""
    if ramp_steps <= 0:
        return jnp.float32(1.0)
    return jnp.minimum(1.0, step.astype(jnp.float32) / ramp_steps)


def potential_flow_cylinder(
    grid: Grid, center: tuple[float, float], radius: float, v_inf: float, ibm_mask
):
    """Initial condition: ideal potential flow around a cylinder, blended to
    rest inside the IBM shell (reference ``initialize_potential_flow``
    v5.py:299-314).
    """
    X, Y = grid.meshgrid()
    dx = grid.dx
    r = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2)
    theta = np.arctan2(Y - center[1], X - center[0])
    mask = np.asarray(ibm_mask)
    factor = (radius / np.maximum(r, 1e-10)) ** 2
    u_far = v_inf * (1.0 - factor * np.cos(2.0 * theta)) * (1.0 - mask)
    v_far = -v_inf * factor * np.sin(2.0 * theta) * (1.0 - mask)
    blend = np.minimum(1.0, ((r - radius) / (4.0 * dx)) ** 2)
    u_near = v_inf * blend * (1.0 - mask)
    far = r > radius + 4.0 * dx
    u0 = np.where(far, u_far, u_near)
    v0 = np.where(far, v_far, 0.0)
    return jnp.asarray(u0, jnp.float32), jnp.asarray(v0, jnp.float32)


def wedge_mask(grid: Grid, wedge_angle: float, wedge_start_x: float):
    """Boolean mask of a wedge rising at ``wedge_angle`` from
    ``wedge_start_x`` along the bottom wall (reference v1_shock.py:240-248).
    Returns an (ny, nx) mask in this framework's row-major (y, x) layout.
    """
    X, Y = grid.meshgrid()
    wedge_y = np.tan(wedge_angle) * (X - wedge_start_x)
    return jnp.asarray((X >= wedge_start_x) & (Y <= wedge_y))


def slip_wall_ghost_map(
    grid: Grid,
    depth,
    normal_x,
    normal_y,
    solid_mask=None,
    band: float = 2.5,
):
    """Precompute a mirror-ghost interpolation map for a slip wall
    (ghost-cell immersed boundary, Forrer & Jeltsch style).

    ``depth`` is the penetration depth into the solid (>0 inside, any value
    outside), ``normal_x/y`` the unit surface normal pointing *into the
    fluid* — all (ny, nx) NumPy arrays evaluated analytically at setup
    time. Ghost cells are solid cells within ``band``·h of the surface;
    each gets the state at its mirror point x + 2·depth·n̂, sampled
    bilinearly from the fluid, with the normal velocity component reflected
    (see ``apply_slip_wall_ghosts``).

    This replaces the reference's zero-momentum solid treatment
    (v1_shock.py:312-313), whose staircase wall deflects the flow by less
    than the geometric angle and biases the oblique-shock angle low.
    Returns a dict of trace-time constant arrays.
    """
    X, Y = grid.meshgrid()
    ny, nx = X.shape
    h = min(grid.dx, grid.dy)
    inside = depth > 0.0 if solid_mask is None else np.asarray(solid_mask)
    ghost = inside & (depth <= band * h)
    gi, gj = np.nonzero(ghost)
    d = depth[gi, gj]
    nxg = normal_x[gi, gj]
    nyg = normal_y[gi, gj]
    # image point: at least 0.75h into the fluid so the bilinear stencil is
    # dominated by true fluid cells (a too-shallow image resamples the ghost
    # band itself and the feedback destabilizes coarse grids)
    d_img = np.maximum(d, 0.75 * h)
    xm = X[gi, gj] + (d + d_img) * nxg
    ym = Y[gi, gj] + (d + d_img) * nyg

    xc = grid.x_coords()
    yc = grid.y_coords()
    j0 = np.clip(np.searchsorted(xc, xm) - 1, 0, nx - 2)
    i0 = np.clip(np.searchsorted(yc, ym) - 1, 0, ny - 2)
    wx = np.clip((xm - xc[j0]) / (xc[j0 + 1] - xc[j0]), 0.0, 1.0)
    wy = np.clip((ym - yc[i0]) / (yc[i0 + 1] - yc[i0]), 0.0, 1.0)

    # zero the weights of stencil corners that fall inside the solid and
    # renormalize (nearest-fluid fallback keeps the sum positive; for a
    # plane with d_img >= 0.75h at least one corner is always fluid)
    w = np.stack(
        [(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx]
    )
    corners = np.stack([
        inside[i0, j0], inside[i0, j0 + 1],
        inside[i0 + 1, j0], inside[i0 + 1, j0 + 1],
    ])
    w = np.where(corners, 0.0, w)
    wsum = w.sum(axis=0)
    degenerate = wsum <= 1e-12
    if np.any(degenerate):  # all four corners solid: keep plain bilinear
        w[:, degenerate] = np.stack(
            [(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx]
        )[:, degenerate]
        wsum = w.sum(axis=0)
    w = w / wsum

    def flat(i, j):
        return (i * nx + j).astype(np.int32)

    return {
        "gi": jnp.asarray(gi.astype(np.int32)),
        "gj": jnp.asarray(gj.astype(np.int32)),
        "idx00": jnp.asarray(flat(i0, j0)),
        "idx01": jnp.asarray(flat(i0, j0 + 1)),
        "idx10": jnp.asarray(flat(i0 + 1, j0)),
        "idx11": jnp.asarray(flat(i0 + 1, j0 + 1)),
        "w00": jnp.asarray(w[0].astype(np.float32)),
        "w01": jnp.asarray(w[1].astype(np.float32)),
        "w10": jnp.asarray(w[2].astype(np.float32)),
        "w11": jnp.asarray(w[3].astype(np.float32)),
        "nx": jnp.asarray(nxg.astype(np.float32)),
        "ny": jnp.asarray(nyg.astype(np.float32)),
    }


def apply_slip_wall_ghosts(U, gm: dict, gamma: float, eps: float = 1e-8,
                           max_val: float = 1e3):
    """Write mirror-ghost states into the near-surface solid cells of a
    conserved-state array U (4, ny, nx): sample (ρ, u, v, p) at each ghost's
    mirror point, reflect the velocity across the wall (v → v − 2(v·n̂)n̂,
    slip condition), copy ρ and p (zero normal gradients)."""
    from cfdsim_tpu.solvers.riemann import cons_to_prim, prim_to_cons

    rho, u, v, p = cons_to_prim(U, gamma, eps, max_val)

    def samp(q):
        qf = q.reshape(-1)
        return (
            gm["w00"] * qf[gm["idx00"]]
            + gm["w01"] * qf[gm["idx01"]]
            + gm["w10"] * qf[gm["idx10"]]
            + gm["w11"] * qf[gm["idx11"]]
        )

    rm, um, vm, pm = samp(rho), samp(u), samp(v), samp(p)
    vn = um * gm["nx"] + vm * gm["ny"]
    ur = um - 2.0 * vn * gm["nx"]
    vr = vm - 2.0 * vn * gm["ny"]
    Ug = prim_to_cons(rm, ur, vr, pm, gamma)
    return U.at[:, gm["gi"], gm["gj"]].set(Ug)


def wedge_slip_ghost_map(grid: Grid, wedge_angle: float, wedge_start_x: float,
                         band: float = 2.5):
    """Slip-wall ghost map for the planar wedge surface
    y = (x − x0)·tanθ, x ≥ x0 (the geometry of v1_shock.py:240-248)."""
    X, Y = grid.meshgrid()
    s, c = np.sin(wedge_angle), np.cos(wedge_angle)
    depth = (X - wedge_start_x) * s - Y * c  # >0 inside the wedge
    solid = np.asarray(wedge_mask(grid, wedge_angle, wedge_start_x))
    normal_x = np.full_like(X, -s)
    normal_y = np.full_like(X, c)
    return slip_wall_ghost_map(grid, depth, normal_x, normal_y,
                               solid_mask=solid, band=band)


def cavity_mask(grid: Grid, x_start: float, length: float, depth: float):
    """Smoothed mask for the open-cavity geometry: 1 inside the cavity
    below the shear layer, Gaussian-smoothed edge above it (σ = 3dx),
    parity with reference cavity_flow_v1.py:264-273.

    Note the supersonic-cavity convention: the "cavity" region marks cells
    whose state is pinned to quiescent fluid each step.
    """
    X, Y = grid.meshgrid()
    inside = (X >= x_start) & (X <= x_start + length) & (Y <= depth)
    mask = inside.astype(np.float64)
    sigma = 3.0 * grid.dx
    above = (~inside) & (X >= x_start) & (X <= x_start + length) & (Y > depth)
    dist_y = Y - depth
    shell = np.exp(-((dist_y / sigma) ** 2))
    mask = np.where(above & (dist_y < 3.0 * sigma), shell, mask)
    return jnp.asarray(mask, jnp.float32)
