"""Named case registry — the config/flag system.

The reference configures each solver with a per-script dataclass and no CLI
(SURVEY.md §5); here each named case ("cavity", "channel", "cylinder",
"wedge", "cavity_supersonic", "kolmogorov", "kolmogorov_ps", "transport",
…) is a builder that
returns a ready-to-run bundle: static config, jitted step function, and
initial state — preserving the reference's scene/state API (u, v, p arrays,
dt/dx/nu params) per BASELINE.json.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax.numpy as jnp
import numpy as np

from cfdsim_tpu import boundary
from cfdsim_tpu.grid import Grid
from cfdsim_tpu.ibm import (
    cylinder_masks,
    cylinder_masks_mac,
    potential_flow_cylinder,
)
from cfdsim_tpu.models.incompressible import (
    IncompressibleConfig,
    init_state,
    make_step,
)
from cfdsim_tpu.solvers.poisson import PoissonConfig


@dataclasses.dataclass
class Case:
    """A runnable bundle: ``step(state, cfl_scale) -> (state, metrics)``."""

    name: str
    cfg: Any
    step: Callable
    state: Any
    grid: Grid
    extras: dict = dataclasses.field(default_factory=dict)


def _poisson_spec(poisson):
    """Accept a PoissonConfig or a CLI-friendly "method[:iters[:omega]]"
    string (e.g. "mg:2", "rbsor:100:1.7", "dct")."""
    if poisson is None or isinstance(poisson, PoissonConfig):
        return poisson
    parts = str(poisson).split(":")
    kw = {"method": parts[0]}
    if len(parts) > 1:
        kw["iters"] = int(parts[1])
    if len(parts) > 2:
        kw["omega"] = float(parts[2])
    return PoissonConfig(**kw)


def lid_cavity(
    n: int = 128,
    Re: float = 100.0,
    lid_velocity: float = 1.0,
    poisson: Optional[PoissonConfig] = None,
    scheme: str = "central",
    cfl: float = 0.5,
    **cfg_overrides,
) -> Case:
    """2D lid-driven cavity (BASELINE.json config 1; the Ghia benchmark)."""
    grid = Grid(nx=n, ny=n)
    # exact DCT projection: faster than any iterative budget and, unlike
    # a warm-started iterative solve, leaves no residual pressure error to
    # feed back into the momentum field
    pois = _poisson_spec(poisson) or PoissonConfig(method="dct")
    cfg = IncompressibleConfig(
        grid=grid,
        nu=lid_velocity / Re,
        scheme=scheme,
        poisson=pois,
        cfl_target=cfl,
        dt_max=0.5 * min(grid.dx, grid.dy) / max(lid_velocity, 1e-10),
        max_velocity=5.0 * lid_velocity,
        **cfg_overrides,
    )
    bc = boundary.lid_cavity_bcs(lid_velocity)
    step = make_step(cfg, bc)
    state = init_state(cfg)
    return Case("cavity", cfg, step, state, grid)


def lid_cavity_mac(
    n: int = 128,
    Re: float = 100.0,
    lid_velocity: float = 1.0,
    poisson: Optional[PoissonConfig] = None,
    scheme: str = "central",
    cfl: float = 0.5,
    **cfg_overrides,
) -> Case:
    """Lid-driven cavity on the staggered (MAC) grid — the accuracy tier:
    exactly divergence-free projection (models/mac.py), the path to the
    BASELINE Ghia target. Same physics as ``lid_cavity``."""
    from cfdsim_tpu.models import mac

    grid = Grid(nx=n, ny=n, centering="cell")
    pois = _poisson_spec(poisson) or PoissonConfig(method="dct")
    cfg = mac.MACConfig(
        grid=grid,
        nu=lid_velocity / Re,
        scheme=scheme,
        poisson=pois,
        cfl_target=cfl,
        dt_max=0.5 * min(grid.dx, grid.dy) / max(lid_velocity, 1e-10),
        max_velocity=5.0 * lid_velocity,
        **cfg_overrides,
    )
    bcs = mac.cavity_bcs(lid_velocity)
    kit = (mac.cavity_implicit_kit(grid, lid_velocity)
           if cfg.diffusion == "implicit" else None)
    step = mac.make_step(cfg, bcs, implicit_kit=kit)
    state = mac.init_state(cfg)
    return Case("cavity_mac", cfg, step, state, grid,
                {"lid_velocity": lid_velocity, "bcs": bcs})


def channel(
    nx: int = 512,
    ny: int = 128,
    Re: float = 100.0,
    u_in: float = 1.0,
    length: float = 4.0,
    height: float = 1.0,
    parabolic_inflow: bool = True,
    poisson: Optional[PoissonConfig] = None,
    **cfg_overrides,
) -> Case:
    """2D channel / Poiseuille flow with inflow-outflow and no-slip walls
    (BASELINE.json config 2)."""
    grid = Grid(nx=nx, ny=ny, x_max=length, y_max=height)
    # Re based on channel height
    nu = u_in * height / Re
    y = jnp.asarray(grid.y_coords(), jnp.float32)
    profile = None
    if parabolic_inflow:
        profile = 6.0 * u_in * (y / height) * (1.0 - y / height)
    pois = _poisson_spec(poisson) or PoissonConfig(method="dct")
    cfg = IncompressibleConfig(
        grid=grid,
        nu=nu,
        scheme="central",
        poisson=pois,
        cfl_target=0.4,
        dt_max=0.4 * min(grid.dx, grid.dy) / max(u_in, 1e-10),
        max_velocity=10.0 * u_in,
        **cfg_overrides,
    )
    bc = boundary.channel_bcs(u_in, profile)
    step = make_step(cfg, bc)
    state = init_state(cfg)
    return Case("channel", cfg, step, state, grid, {"profile": profile})


def cylinder(
    nx: int = 600,
    ny: int = 180,
    Re: float = 600.0,
    v_inf: float = 1.0,
    radius: float = 0.5,
    center: tuple[float, float] = (4.0, 2.0),
    domain: tuple[float, float] = (20.0, 4.0),
    scheme: str = "upwind",
    use_les: bool = False,
    smagorinsky_constant: float = 0.17,
    artificial_viscosity: float = 1e-3,
    poisson: Optional[PoissonConfig] = None,
    ref_parity: bool = False,
    **cfg_overrides,
) -> Case:
    """Flow past an immersed cylinder — the reference's flagship case
    (v5.py:616-650 defaults: 600×180 grid on a 20×4 domain, Re=600, SUPG,
    artificial viscosity 1e-3, IBM ramp + fixed-dt warmup over the first
    1000 steps, velocity clip at 5). ``ref_parity=True`` reproduces the
    reference's halved SUPG convection and masked rbsor Poisson exactly.

    Default scheme is monotone upwind: at this grid the cell Reynolds
    number is ~20, where full-strength central+SUPG convection (the
    mathematically corrected form of the reference's operator) is
    unstable — the reference only survives it because its halved
    convection term doubles the effective resolution margin. Upwind keeps
    the run healthy (div ~0.1, physical velocities) at Re=600."""
    grid = Grid(nx=nx, ny=ny, x_max=domain[0], y_max=domain[1])
    solid, ibm = cylinder_masks(grid, center, radius)
    poisson = _poisson_spec(poisson)
    if poisson is None:
        if ref_parity:
            # the reference's exact pressure budget (v5.py:64-65)
            poisson = PoissonConfig(
                method="rbsor", iters=1500, tol=1e-8, check_every=50,
                omega=1.7,
            )
        else:
            # exact projection: required for long-horizon stability once
            # vortex shedding is active (warm-started MG blows up ~t=40)
            poisson = PoissonConfig(method="dct")
    defaults = dict(
        adaptive_dt=True,
        cfl_target=0.1,
        dt_base=5e-5,
        dt_min=1e-6,
        dt_max=1e-4,
        warmup_steps=1000,
        warmup_dt=2e-5,
        ibm_ramp_steps=1000,
        max_velocity=5.0 * v_inf,
        cleanup_iters=2,
        masked_poisson=ref_parity,
    )
    defaults.update(cfg_overrides)
    cfg = IncompressibleConfig(
        grid=grid,
        nu=v_inf / Re,
        scheme=("supg_refparity" if ref_parity and scheme == "supg" else scheme),
        use_les=use_les,
        smagorinsky_constant=smagorinsky_constant,
        artificial_viscosity=artificial_viscosity,
        poisson=poisson,
        **defaults,
    )
    bc = boundary.cylinder_inflow_bcs(
        v_inf, grid.y_coords(), grid.y_max, perturb_amp=0.01, perturb_ramp_steps=1000
    )
    step = make_step(cfg, bc, solid_mask=solid, ibm_mask=ibm)
    u0, v0 = potential_flow_cylinder(grid, center, radius, v_inf, ibm)
    state = init_state(cfg, u0=u0, v0=v0)
    return Case(
        "cylinder", cfg, step, state, grid,
        {"solid_mask": solid, "ibm_mask": ibm, "center": center, "radius": radius},
    )


def cavity_stretched(
    n: int = 96,
    Re: float = 1000.0,
    lid_velocity: float = 1.0,
    beta: float = 1.5,
    scheme: str = "central",
    cfl: float = 0.5,
    **cfg_overrides,
) -> Case:
    """Lid-driven cavity on a tanh wall-clustered stretched MAC grid with
    the exact fast-diagonalization (dense matmul) pressure solve — the
    capability the reference's FEM path provided via gmsh refinement
    (v1.jl:24-97). Measured at Re=1000 vs the Botella–Peyret spectral
    benchmark: 2.6e-3 at 96² β=1.5 vs 1.26e-2 on the uniform 96² grid
    (~5× at matched cell count); 1.5e-3 at 128² β=1.5."""
    from cfdsim_tpu.models import mac
    from cfdsim_tpu.models import mac_stretched as ms

    xf = ms.wall_clustered_faces(n, 1.0, beta=beta)
    yf = ms.wall_clustered_faces(n, 1.0, beta=beta)
    h_min = float(min((xf[1:] - xf[:-1]).min(), (yf[1:] - yf[:-1]).min()))
    defaults = dict(
        cfl_target=cfl,
        dt_max=cfl * h_min / max(lid_velocity, 1e-10),
        max_velocity=5.0 * lid_velocity,
    )
    defaults.update(cfg_overrides)
    cfg = ms.StretchedMACConfig(nx=n, ny=n, nu=lid_velocity / Re,
                                scheme=scheme, **defaults)
    bcs = mac.cavity_bcs(lid_velocity)
    step = ms.make_step(cfg, bcs, xf, yf)
    state = ms.init_state(cfg)
    grid = Grid(nx=n, ny=n, centering="cell")  # nominal uniform descriptor
    return Case("cavity_stretched", cfg, step, state, grid,
                {"x_faces": xf, "y_faces": yf, "beta": beta,
                 "lid_velocity": lid_velocity, "bcs": bcs})


def cylinder_stretched(
    nx: int = 512,
    ny: int = 256,
    Re: float = 150.0,
    v_inf: float = 1.0,
    radius: float = 0.5,
    center: tuple[float, float] = (6.0, 4.0),
    domain: tuple[float, float] = (24.0, 8.0),
    scheme: str = "tvd",
    refine_strength: float = 3.0,
    refine_width: float = 1.5,
    wake_length: float = 6.0,
    ibm_ramp_steps: int = 200,
    perturb_ramp_steps: int = 200,
    **cfg_overrides,
) -> Case:
    """Cylinder flow on a stretched MAC grid: grid lines cluster around
    the body and the near wake (Gaussian refinement regions), so a 512×256
    grid resolves the cylinder like a much larger uniform one — the
    boundary-layer-refinement capability of the reference's gmsh mesh
    (v2.jl:62-134, h_near=0.02 → h_far=0.2)."""
    from cfdsim_tpu.models import mac
    from cfdsim_tpu.models import mac_stretched as ms

    import numpy as np

    xf = ms.stretched_faces(
        nx, domain[0],
        refine=[(center[0], refine_width, refine_strength),
                (center[0] + 0.5 * wake_length, wake_length, 0.5 * refine_strength)],
    )
    yf = ms.stretched_faces(
        ny, domain[1], refine=[(center[1], refine_width, refine_strength)]
    )
    h_min = float(min((xf[1:] - xf[:-1]).min(), (yf[1:] - yf[:-1]).min()))
    defaults = dict(
        cfl_target=0.4,
        dt_max=0.4 * h_min / max(v_inf, 1e-10),
        dt_min=1e-6,
        warmup_steps=ibm_ramp_steps,
        warmup_dt=min(5e-4, 0.1 * h_min / max(v_inf, 1e-10)),
        max_velocity=5.0 * v_inf,
    )
    defaults.update(cfg_overrides)
    cfg = ms.StretchedMACConfig(nx=nx, ny=ny, nu=v_inf * 2 * radius / Re,
                                scheme=scheme, **defaults)
    # face-sampled IBM masks at the stretched face locations
    xc = 0.5 * (xf[:-1] + xf[1:])
    yc = 0.5 * (yf[:-1] + yf[1:])
    h_near = float(np.diff(xf)[np.argmin(np.abs(xc - center[0]))])
    from cfdsim_tpu.ibm import _gaussian_shell

    Xu, Yu = np.meshgrid(xf, yc, indexing="xy")
    Xv, Yv = np.meshgrid(xc, yf, indexing="xy")
    du = np.sqrt((Xu - center[0]) ** 2 + (Yu - center[1]) ** 2)
    dv = np.sqrt((Xv - center[0]) ** 2 + (Yv - center[1]) ** 2)
    mask_u = jnp.asarray(_gaussian_shell(du, radius, h_near), jnp.float32)
    mask_v = jnp.asarray(_gaussian_shell(dv, radius, h_near), jnp.float32)

    bcs = mac.external_flow_bcs(
        v_inf, yc, domain[1], perturb_ramp_steps=perturb_ramp_steps
    )
    step = ms.make_step(cfg, bcs, xf, yf, ibm_mask_u=mask_u,
                        ibm_mask_v=mask_v, ibm_ramp_steps=ibm_ramp_steps)
    state = ms.init_state(cfg, u0=jnp.full((ny, nx + 1), v_inf, jnp.float32)
                          * (1.0 - mask_u))
    grid = Grid(nx=nx, ny=ny, x_max=domain[0], y_max=domain[1],
                centering="cell")
    return Case(
        "cylinder_stretched", cfg, step, state, grid,
        {"x_faces": xf, "y_faces": yf, "ibm_mask_u": mask_u,
         "ibm_mask_v": mask_v, "center": center, "radius": radius,
         "h_near": h_near, "v_inf": v_inf, "bcs": bcs},
    )


def cylinder_mac(
    nx: int = 720,
    ny: int = 240,
    Re: float = 150.0,
    v_inf: float = 1.0,
    radius: float = 0.5,
    center: tuple[float, float] = (6.0, 4.0),
    domain: tuple[float, float] = (24.0, 8.0),
    scheme: str = "tvd",
    poisson: Optional[PoissonConfig] = None,
    ibm_ramp_steps: int = 200,
    perturb_ramp_steps: int = 200,
    ibm_profile: str = "shell",
    ibm_scheme: str = "penalize",
    **cfg_overrides,
) -> Case:
    """Flow past a cylinder on the staggered (MAC) grid — the best-physics
    configuration: exactly divergence-free projection + TVD (van Leer
    MUSCL) convection + face-sampled Gaussian-shell IBM. Defaults target
    Strouhal-accurate shedding at low blockage (D/H = 12.5%, ~30 cells/D):
    measured St = 0.180 at Re=150 on 720×240 and 0.200 on 1200×400
    (empirical unconfined 0.18–0.20; see BENCHNOTES.md). The collocated
    ``cylinder`` case keeps the reference's exact geometry and quirks.
    ``ibm_profile="sharp"`` makes the penalization drag/lift
    quantitative (Cd within ~7% of the unconfined literature at 20
    cells/D); the default ``"shell"`` keeps the reference's Gaussian
    forcing — validated shedding, forces qualitative.
    ``ibm_scheme="ghost"``: sharp-interface ghost-cell direct forcing
    (ibm_ghost.cylinder_ghost_ibm) — no-slip exactly on r = R, removing
    the sharp mask's O(dx/2) effective-radius drag bias."""
    from cfdsim_tpu.models import mac

    grid = Grid(nx=nx, ny=ny, x_max=domain[0], y_max=domain[1],
                centering="cell")
    mask_u, mask_v = cylinder_masks_mac(grid, center, radius,
                                        profile=ibm_profile)
    pois = _poisson_spec(poisson) or PoissonConfig(method="dct")
    defaults = dict(
        cfl_target=0.4,
        dt_max=0.4 * grid.dy / max(v_inf, 1e-10),
        dt_min=1e-6,
        dt_base=1e-3,
        warmup_steps=ibm_ramp_steps,
        warmup_dt=min(5e-4, 0.1 * grid.dy / max(v_inf, 1e-10)),
        max_velocity=5.0 * v_inf,
    )
    defaults.update(cfg_overrides)
    cfg = mac.MACConfig(grid=grid, nu=v_inf * 2 * radius / Re, scheme=scheme,
                        poisson=pois, **defaults)
    y_face_centers = grid.y_min + (jnp.arange(ny) + 0.5) * grid.dy
    bcs = mac.external_flow_bcs(
        v_inf, y_face_centers, grid.y_max,
        perturb_ramp_steps=perturb_ramp_steps,
    )
    if ibm_scheme == "ghost":
        import numpy as _np

        from cfdsim_tpu.ibm_ghost import cylinder_ghost_ibm

        xf = grid.x_min + _np.arange(nx + 1) * grid.dx
        yf = grid.y_min + _np.arange(ny + 1) * grid.dy
        ibm_kwargs = dict(
            ibm_ghost=cylinder_ghost_ibm(xf, yf, center, radius)
        )
    elif ibm_scheme == "penalize":
        ibm_kwargs = dict(ibm_mask_u=mask_u, ibm_mask_v=mask_v)
    else:
        raise ValueError(f"unknown ibm_scheme {ibm_scheme!r}")
    step = mac.make_step(cfg, bcs, ibm_ramp_steps=ibm_ramp_steps,
                         **ibm_kwargs)
    from cfdsim_tpu.ibm import potential_flow_cylinder_mac

    u0, v0 = potential_flow_cylinder_mac(grid, center, radius, v_inf,
                                         mask_u, mask_v)
    state = mac.init_state(cfg, u0=u0, v0=v0)
    return Case(
        "cylinder_mac", cfg, step, state, grid,
        {"ibm_mask_u": mask_u, "ibm_mask_v": mask_v, "center": center,
         "radius": radius, "v_inf": v_inf, "bcs": bcs},
    )


def cylinder_oscillating(
    nx: int = 480,
    ny: int = 240,
    KC: float = 5.0,
    Re: float = 100.0,
    radius: float = 0.5,
    period: float = 5.0,
    domain: tuple[float, float] = (24.0, 12.0),
    center: tuple[float, float] = (12.0, 6.0),
    scheme: str = "tvd",
    poisson: Optional[PoissonConfig] = None,
    ibm_ramp_steps: int = 0,
    stretched: bool = False,
    refine_strength: float = 3.0,
    ibm_scheme: str = "penalize",
    **cfg_overrides,
) -> Case:
    """In-line oscillating cylinder in quiescent fluid — the
    moving-geometry IBM benchmark (Dütsch et al. 1998 configuration):
    x_c(t) = x0 + A·sin(2πt/T) with KC = 2πA/D and
    Re = U_max·D/ν, U_max = 2πA/T. The sharp face masks are rebuilt on
    device each step (ibm.MovingBody via mac.make_step moving_body);
    metrics carry the fluid↔body momentum exchange (fx, fy). Free-slip
    far-field box. Moving geometry is a capability the reference has no
    analog of (its IBM is static, v5.py:275-283). ``stretched=True``
    clusters the grid around the sweep region (the stretched tier's
    moving-body path) for resolution the uniform grid can't afford.
    ``ibm_scheme="ghost"``: moving sharp-interface ghost-cell forcing —
    the wall condition u(r=R) = u_b(t) imposed exactly, classification
    + probe stencils rebuilt on device each stage
    (ibm_ghost.moving_ghost_forcing_2d[_nonuniform])."""
    import numpy as np

    from cfdsim_tpu.ibm import oscillating_cylinder
    from cfdsim_tpu.models import mac

    D = 2 * radius
    A = KC * D / (2 * np.pi)
    u_max = 2 * np.pi * A / period
    nu = u_max * D / Re
    grid = Grid(nx=nx, ny=ny, x_max=domain[0], y_max=domain[1],
                centering="cell")
    pois = _poisson_spec(poisson) or PoissonConfig(method="dct")
    body = oscillating_cylinder(center, radius, A, period)
    bcs = mac.free_slip_bcs()
    extras = {"body": body, "amplitude": A, "period": period,
              "u_max": u_max, "center": center, "radius": radius,
              # Cd normalization by U_max: Cd(t) = coeff_scale·fx(t)
              "coeff_scale": 2.0 / (u_max**2 * D)}
    if ibm_scheme not in ("penalize", "ghost"):
        raise ValueError(f"unknown ibm_scheme {ibm_scheme!r}")
    if stretched:
        from cfdsim_tpu.models import mac_stretched as ms

        xf = ms.stretched_faces(
            nx, domain[0],
            refine=[(center[0], A + 2 * radius, refine_strength)],
        )
        yf = ms.stretched_faces(
            ny, domain[1],
            refine=[(center[1], 2.5 * radius, refine_strength)],
        )
        h_min = float(min(np.diff(xf).min(), np.diff(yf).min()))
        defaults = dict(
            cfl_target=0.4,
            dt_max=0.4 * h_min / max(u_max, 1e-10),
            dt_min=1e-6,
            max_velocity=5.0 * u_max,
        )
        defaults.update(cfg_overrides)
        scfg = ms.StretchedMACConfig(nx=nx, ny=ny, nu=nu, scheme=scheme,
                                     **defaults)
        step = ms.make_step(scfg, bcs, xf, yf, moving_body=body,
                            ibm_ramp_steps=ibm_ramp_steps,
                            moving_scheme=ibm_scheme)
        state = ms.init_state(scfg)
        extras.update({"x_faces": xf, "y_faces": yf, "h_min": h_min})
        return Case("cylinder_oscillating", scfg, step, state, grid,
                    extras)
    defaults = dict(
        cfl_target=0.4,
        dt_max=0.4 * grid.dy / max(u_max, 1e-10),
        dt_min=1e-6,
        max_velocity=5.0 * u_max,
    )
    defaults.update(cfg_overrides)
    cfg = mac.MACConfig(grid=grid, nu=nu, scheme=scheme, poisson=pois,
                        **defaults)
    step = mac.make_step(cfg, bcs, moving_body=body,
                         ibm_ramp_steps=ibm_ramp_steps,
                         moving_scheme=ibm_scheme)
    state = mac.init_state(cfg)
    return Case("cylinder_oscillating", cfg, step, state, grid, extras)


def wedge(
    nx: int = 400,
    ny: int = 200,
    mach: float = 2.0,
    wedge_angle_deg: float = 10.0,
    wedge_start_x: float = 0.5,
    domain: tuple[float, float] = (2.0, 1.0),
    flux: str = "hllc",
    cfl: float = 0.4,
    reconstruction: str = "none",
    wall_treatment: str = "zero_momentum",
    frame: str = "lab",
    **cfg_overrides,
) -> Case:
    """Supersonic flow over a wedge — oblique-shock benchmark (reference
    ``ShockwaveSolver`` v1_shock.py:225-328: M=2, 10° wedge, HLLC/Roe
    switchable via ``flux``). The reference's CFL=0.99 with an unsplit
    update exceeds the 2D stability bound; default here is 0.4.

    ``frame``:

    - ``"lab"`` — the reference geometry: embedded wedge, horizontal
      inflow. ``wall_treatment`` picks the solid model: ``"zero_momentum"``
      (reference parity, v1_shock.py:312-313) or ``"ghost"`` (mirror-ghost
      slip wall, ibm.slip_wall_ghost_map). Both carry an O(h) tip/staircase
      entropy layer that biases the measured shock angle high (≈+1.4°/+3.6°
      at 400×200, converging to the θ-β-M angle as h→0).
    - ``"wedge_aligned"`` — the exact-geometry variant: the frame is
      rotated by the wedge angle, so the wedge surface is the flat bottom
      grid line (slip wall for x ≥ wedge_start_x, pass-through outflow
      before it) and the freestream enters at −θ. Zero geometry error —
      this isolates the flux solver, nailing β to sub-degree at 400×200.
      Extras carry ``frame_angle`` for converting measured slopes:
      β = atan(slope) + θ.
    """
    import numpy as np

    from cfdsim_tpu import ibm
    from cfdsim_tpu.models import compressible as comp

    grid = Grid(nx=nx, ny=ny, x_max=domain[0], y_max=domain[1], centering="cell")
    cfg = comp.CompressibleConfig(
        grid=grid, flux=flux, cfl=cfl, reconstruction=reconstruction,
        **cfg_overrides,
    )
    theta = np.deg2rad(wedge_angle_deg)

    if frame == "wedge_aligned":
        a0 = (cfg.gamma * 1.0 / 1.0) ** 0.5
        uu = mach * a0 * np.cos(theta)
        vv = -mach * a0 * np.sin(theta)
        E = 1.0 / (1.0 * (cfg.gamma - 1.0)) + 0.5 * (uu * uu + vv * vv)
        U_inf = jnp.asarray([1.0, uu, vv, E], jnp.float32)
        xs_idx = int(np.searchsorted(grid.x_coords(), wedge_start_x))

        def bc(U, step, t):
            # freestream in from the left and the top (flow points down-right)
            U = U.at[:, :, 0].set(U_inf[:, None])
            U = U.at[:, -1, :].set(U_inf[:, None])
            # outflow at x_hi
            U = U.at[:, :, -1].set(U[:, :, -2])
            # bottom: pass-through (extrapolation) before the wedge tip,
            # reflecting slip wall from the tip on — the BC switch anchors
            # the oblique shock exactly at x = wedge_start_x
            wall = U[:, 1, :]
            wall = wall.at[2].mul(-1.0)
            free = U[:, 1, :]
            keep_wall = jnp.asarray(
                (np.arange(grid.nx) >= xs_idx)[None, :], U.dtype
            )
            U = U.at[:, 0, :].set(wall * keep_wall + free * (1.0 - keep_wall))
            return U

        step = comp.make_step(cfg, bc)
        state = comp.init_state(cfg, U_inf)
        return Case(
            "wedge", cfg, step, state, grid,
            {"U_inf": U_inf, "mach": mach, "wedge_angle_deg": wedge_angle_deg,
             "wedge_start_x": wedge_start_x, "frame_angle": wedge_angle_deg},
        )

    U_inf = comp.freestream(cfg, mach)
    solid = ibm.wedge_mask(grid, theta, wedge_start_x)
    ghost_map = None
    if wall_treatment == "ghost":
        ghost_map = ibm.wedge_slip_ghost_map(grid, theta, wedge_start_x)
    elif wall_treatment != "zero_momentum":
        raise ValueError(f"unknown wall_treatment {wall_treatment!r}")

    def bc(U, step, t):
        # supersonic inflow at x_lo (v1_shock.py:279-283)
        U = U.at[:, :, 0].set(U_inf[:, None])
        # extrapolation outflow at x_hi (:284)
        U = U.at[:, :, -1].set(U[:, :, -2])
        # reflecting bottom wall (v sign flip), extrapolating top (:285-289)
        U = U.at[0, 0, :].set(U[0, 1, :])
        U = U.at[1, 0, :].set(U[1, 1, :])
        U = U.at[2, 0, :].set(-U[2, 1, :])
        U = U.at[3, 0, :].set(U[3, 1, :])
        U = U.at[:, -1, :].set(U[:, -2, :])
        if ghost_map is not None:
            U = ibm.apply_slip_wall_ghosts(
                U, ghost_map, cfg.gamma, cfg.eps, cfg.max_val
            )
        return U

    step = comp.make_step(cfg, bc, zero_momentum_mask=solid)
    state = comp.init_state(cfg, U_inf)
    return Case(
        "wedge", cfg, step, state, grid,
        {"wedge_mask": solid, "U_inf": U_inf, "mach": mach,
         "wedge_angle_deg": wedge_angle_deg, "wedge_start_x": wedge_start_x},
    )


def cavity_supersonic(
    nx: int = 600,
    ny: int = 180,
    ng: int = 2,
    mach: float = 2.5,
    domain: tuple[float, float] = (2.0, 1.0),
    cavity_x: float = 0.5,
    cavity_length: float = 0.5,
    l_over_d: float = 2.0,
    flux: str = "rusanov",
    cfl: float = 0.3,
    artificial_viscosity: float = 1e-3,
    reconstruction: str = "muscl",
    real_geometry: bool = False,
    **cfg_overrides,
) -> Case:
    """Mach-2.5 flow over an open cavity (reference ``CavityFlowSolver``
    cavity_flow_v1.py:248-308: NG=2 ghost cells, Rusanov fluxes, minmod
    limiting, artificial viscosity, cavity region pinned to quiescent fluid
    each step per cavity_flow_v1.py:165-170).

    ``real_geometry=True`` replaces the reference's pinned-quiescent block
    with the actual solid: a plate at y ≤ depth with the cavity cut out
    between ``cavity_x`` and ``cavity_x + length`` (embedded solid via
    zero-momentum masking), so the recirculating cavity flow can develop —
    a beyond-reference capability."""
    from cfdsim_tpu import ibm
    from cfdsim_tpu.models import compressible as comp

    grid = Grid(
        nx=nx, ny=ny, ng=ng, x_max=domain[0], y_max=domain[1], centering="node"
    )
    cfg = comp.CompressibleConfig(
        grid=grid, flux=flux, cfl=cfl, reconstruction=reconstruction,
        artificial_viscosity=artificial_viscosity, max_val=100.0,
        **cfg_overrides,
    )
    U_inf = comp.freestream(cfg, mach)
    pin_state = jnp.asarray(
        [1.0, 0.0, 0.0, 1.0 / (cfg.gamma - 1.0)], jnp.float32
    )  # quiescent ρ_inf, p_inf block (cavity_flow_v1.py:166-170)
    mask = ibm.cavity_mask(grid, cavity_x, cavity_length, cavity_length / l_over_d)
    pin = mask > 0.5

    def bc(U, step, t):
        # inflow ghosts at x_lo, extrapolation at x_hi
        # (cavity_flow_v1.py:154-157, axes adapted to (ny, nx))
        U = U.at[:, :, :ng].set(U_inf[:, None, None])
        U = U.at[:, :, -ng:].set(U[:, :, -ng - 1 : -ng])
        # freestream top ghosts, reflecting bottom wall (:158-162)
        U = U.at[:, -ng:, :].set(U_inf[:, None, None])
        for k in range(ng):
            src = 2 * ng - 1 - k
            U = U.at[0, k, :].set(U[0, src, :])
            U = U.at[1, k, :].set(U[1, src, :])
            U = U.at[2, k, :].set(-U[2, src, :])
            U = U.at[3, k, :].set(U[3, src, :])
        return U

    if real_geometry:
        # actual solid plate with the cavity cut out: zero-momentum solid
        # everywhere below the plate surface except inside the cavity span
        import numpy as np

        X, Y = grid.meshgrid()
        depth = cavity_length / l_over_d
        solid = (Y <= depth) & ~(
            (X >= cavity_x) & (X <= cavity_x + cavity_length)
        )
        solid = jnp.asarray(solid)
        keep = 1.0 - solid.astype(jnp.float32)

        def bc_real(U, step_i, t):
            # standard ghosts, then kill momentum inside the plate (the
            # inflow ghost writes otherwise inject freestream below the lip)
            U = bc(U, step_i, t)
            U = U.at[1].mul(keep)
            U = U.at[2].mul(keep)
            return U

        step = comp.make_step(cfg, bc_real, zero_momentum_mask=solid)
        extras = {"solid_mask": solid, "U_inf": U_inf}
    else:
        step = comp.make_step(cfg, bc, pin_mask=pin, pin_state=pin_state)
        extras = {"cavity_mask": mask, "U_inf": U_inf, "pin_state": pin_state}
    state = comp.init_state(cfg, U_inf)
    state = state._replace(U=bc(state.U, state.step, state.t))
    return Case("cavity_supersonic", cfg, step, state, grid, extras)


def kolmogorov(
    ny: int = 360,
    aspect: float = 16.0 / 9.0,
    nu: float = 1e-3,
    dt: float = 0.01,
    forcing_wavenumber: int = 8,
    forcing_scale: float = 0.1,
    **cfg_overrides,
) -> Case:
    """Periodic Kolmogorov-forced turbulence via the spectral stable-fluids
    solver (reference plot.jl:14-24 defaults: 640×360, ν=1e-3, dt=0.01,
    sin(8πy) forcing)."""
    from cfdsim_tpu.models import spectral as spec

    cfg = spec.SpectralConfig(
        ny=ny, aspect=aspect, nu=nu, dt=dt,
        forcing_wavenumber=forcing_wavenumber, forcing_scale=forcing_scale,
        **cfg_overrides,
    )
    step = spec.make_step(cfg)
    state = spec.init_state(cfg)
    grid = Grid(nx=cfg.nx, ny=cfg.ny, x_max=cfg.lx, y_max=1.0, centering="cell")
    return Case("kolmogorov", cfg, step, state, grid)


def kolmogorov_ps(
    ny: int = 512,
    aspect: float = 1.0,
    nu: float = 1e-5,
    dt: float = 2e-3,
    forcing_wavenumber: int = 8,
    forcing_scale: float = 0.1,
    noise: float = 0.0,
    seed: int = 0,
    **cfg_overrides,
) -> Case:
    """Kolmogorov flow on the PSEUDO-SPECTRAL vorticity solver
    (models/spectral_ps.py) — the dissipation-free upgrade of the
    stable-fluids tier (same physics as ``kolmogorov``; forcing is per
    unit time here, not per step). ``noise`` seeds the instability."""
    from cfdsim_tpu.models import spectral_ps as ps

    cfg = ps.PseudoSpectralConfig(
        ny=ny, aspect=aspect, nu=nu, dt=dt,
        forcing_wavenumber=forcing_wavenumber, forcing_scale=forcing_scale,
        **cfg_overrides,
    )
    step = ps.make_step(cfg)
    state = ps.init_state(cfg, noise=noise, seed=seed)
    grid = Grid(nx=cfg.nx, ny=cfg.ny, x_max=cfg.lx, y_max=1.0, centering="cell")
    return Case("kolmogorov_ps", cfg, step, state, grid,
                {"velocities": lambda s: ps.velocities(cfg, s)})


def transport(
    n: int = 128,
    Re: float = 100.0,
    Pe: float = 100.0,
    scheme: str = "upwind",
    hot_lid: float = 1.0,
    **cavity_kwargs,
) -> Case:
    """Passive scalar (temperature/dye) carried by the lid-driven cavity
    flow (BASELINE.json config 3): θ=hot_lid on the moving lid, θ=0 on the
    other walls, diffusivity κ = U·L/Pe."""
    from cfdsim_tpu.models import transport as tr

    base = lid_cavity(n=n, Re=Re, **cavity_kwargs)

    def theta_bc(th):
        th = th.at[:, 0].set(0.0).at[:, -1].set(0.0).at[0, :].set(0.0)
        return th.at[-1, :].set(hot_lid)

    tcfg = tr.TransportConfig(grid=base.grid, kappa=1.0 / Pe, scheme=scheme)
    step = tr.make_coupled_step(base.step, tcfg, theta_bc)
    theta0 = theta_bc(base.grid.zeros())
    state = tr.init_coupled(base.state, theta0)
    return Case("transport", (base.cfg, tcfg), step, state, base.grid)


def cavity3d(
    n: int = 64,
    Re: float = 400.0,
    lid_velocity: float = 1.0,
    poisson=None,
    **cfg_overrides,
) -> Case:
    """3D lid-driven cavity (BASELINE.json config 5: 256³, multigrid
    Poisson, shardable over a device mesh via parallel.shard_state)."""
    from cfdsim_tpu.grid import Grid3D
    from cfdsim_tpu.models import incompressible3d as m3
    from cfdsim_tpu.solvers.poisson3d import Poisson3DConfig

    grid = Grid3D(nx=n, ny=n, nz=n)
    cfg = m3.Incompressible3DConfig(
        grid=grid,
        nu=lid_velocity / Re,
        poisson=poisson or Poisson3DConfig(method="mg", iters=2),
        max_velocity=5.0 * lid_velocity,
        **cfg_overrides,
    )
    bc = m3.lid_cavity3d_bcs(lid_velocity)
    step = m3.make_step(cfg, bc)
    state = m3.init_state(cfg)
    return Case("cavity3d", cfg, step, state, grid)


def cavity3d_mac(
    n: int = 64,
    Re: float = 400.0,
    lid_velocity: float = 1.0,
    poisson=None,
    **cfg_overrides,
) -> Case:
    """3D lid-driven cavity on the staggered MAC grid — exact 3D DCT
    projection (divergence-free to fp32 roundoff), the 3D member of the
    accuracy tier; same geometry as ``cavity3d`` (BASELINE config 5)."""
    from cfdsim_tpu.grid import Grid3D
    from cfdsim_tpu.models import mac3d
    from cfdsim_tpu.solvers.poisson3d import Poisson3DConfig

    # cell centering: the MAC arrays hold n CELLS per axis, so dx must be
    # 1/n for the cavity to be exactly [0,1]³ (node centering would make
    # the domain n/(n−1) wide — fixed round 2)
    grid = Grid3D(nx=n, ny=n, nz=n, centering="cell")
    cfg = mac3d.MAC3DConfig(
        grid=grid,
        nu=lid_velocity / Re,
        poisson=poisson or Poisson3DConfig(method="dct"),
        max_velocity=5.0 * lid_velocity,
        **cfg_overrides,
    )
    bcs = mac3d.cavity3d_bcs(lid_velocity)
    step = mac3d.make_step(cfg, bcs)
    state = mac3d.init_state(cfg)
    return Case("cavity3d_mac", cfg, step, state, grid, {"bcs": bcs})


def sphere_mac3d(
    nx: int = 192,
    ny: int = 96,
    nz: int = 96,
    Re: float = 100.0,
    v_inf: float = 1.0,
    radius: float = 0.5,
    center: tuple[float, float, float] = (4.0, 4.0, 4.0),
    domain: tuple[float, float, float] = (16.0, 8.0, 8.0),
    scheme: str = "tvd",
    poisson=None,
    ibm_ramp_steps: int = 200,
    ibm_profile: str = "sharp",
    ibm_scheme: str = "penalize",
    use_les: bool = False,
    perturb: float = 0.0,
    **cfg_overrides,
) -> Case:
    """Uniform flow past an immersed sphere on the 3D staggered MAC grid
    — the 3D habitat of the reference's flagship IBM capability
    (cylinder, v5.py:275-283/228-237): exact 3D DCT projection,
    face-sampled Gaussian-shell penalization, TVD (van Leer MUSCL)
    convection, potential-flow initialization. Defaults: D = 1 sphere in
    a (16D, 8D, 8D) box (1.2% area blockage) at 12 cells/D.

    Drag from the penalization momentum sink: Cd = fx/(½·v∞²·πR²) —
    ``extras["coeff_scale"]`` carries the scale. Published values:
    Cd ≈ 1.09 at Re=100, 0.77 at Re=200 (steady axisymmetric wake below
    Re≈210; Schiller–Naumann correlation in
    ``validation.sphere_drag_schiller_naumann``). ``ibm_profile="sharp"``
    (default) makes the force quantitative; ``"shell"`` selects the
    reference's Gaussian-shell forcing (smoother, force only
    qualitative — see ibm.sphere_masks_mac3d). ``perturb`` adds a static
    (nz, ny) inlet modulation 1 + ε·sin(2πy/Ly)·sin(2πz/Lz) — the
    symmetry-breaking trigger for the unsteady regime Re ≳ 280 (Johnson
    & Patel: hairpin shedding at St ≈ 0.137, Re=300)."""
    import numpy as np

    from cfdsim_tpu.grid import Grid3D
    from cfdsim_tpu.ibm import potential_flow_sphere_mac3d, sphere_masks_mac3d
    from cfdsim_tpu.models import mac3d
    from cfdsim_tpu.solvers.poisson3d import Poisson3DConfig

    grid = Grid3D(
        nx=nx, ny=ny, nz=nz,
        x_max=domain[0], y_max=domain[1], z_max=domain[2],
        centering="cell",
    )
    mask_u, mask_v, mask_w = sphere_masks_mac3d(
        grid, center, radius, profile=ibm_profile
    )
    if ibm_scheme == "ghost":
        from cfdsim_tpu.ibm_ghost import sphere_ghost_ibm

        xf = grid.x_min + np.arange(nx + 1) * grid.dx
        yf = grid.y_min + np.arange(ny + 1) * grid.dy
        zf = grid.z_min + np.arange(nz + 1) * grid.dz
        ghost = sphere_ghost_ibm(xf, yf, zf, center, radius)
        ibm_kwargs = dict(ibm_ghost=ghost)
    elif ibm_scheme == "penalize":
        ibm_kwargs = dict(
            ibm_mask_u=mask_u, ibm_mask_v=mask_v, ibm_mask_w=mask_w
        )
    else:
        raise ValueError(f"unknown ibm_scheme {ibm_scheme!r}")
    h = min(grid.dx, grid.dy, grid.dz)
    defaults = dict(
        cfl_target=0.4,
        dt_max=0.4 * h / max(v_inf, 1e-10),
        dt_min=1e-6,
        max_velocity=5.0 * v_inf,
        use_les=use_les,
    )
    defaults.update(cfg_overrides)
    cfg = mac3d.MAC3DConfig(
        grid=grid, nu=v_inf * 2 * radius / Re, scheme=scheme,
        poisson=poisson or Poisson3DConfig(method="dct"), **defaults
    )
    if perturb:
        yc = (np.arange(ny) + 0.5) * (domain[1] / ny)
        zc = (np.arange(nz) + 0.5) * (domain[2] / nz)
        Zc, Yc = np.meshgrid(zc, yc, indexing="ij")
        profile = jnp.asarray(
            1.0
            + perturb
            * np.sin(2 * np.pi * Yc / domain[1])
            * np.sin(2 * np.pi * Zc / domain[2]),
            jnp.float32,
        )
    else:
        profile = None
    bcs = mac3d.external_flow_bcs3d(v_inf, inlet_profile=profile)
    step = mac3d.make_step(
        cfg, bcs, ibm_ramp_steps=ibm_ramp_steps, **ibm_kwargs
    )
    u0, v0, w0 = potential_flow_sphere_mac3d(
        grid, center, radius, v_inf, mask_u, mask_v, mask_w
    )
    state = mac3d.init_state(cfg)._replace(u=u0, v=v0, w=w0)
    return Case(
        "sphere_mac3d", cfg, step, state, grid,
        {
            "ibm_masks": (mask_u, mask_v, mask_w),
            "center": center, "radius": radius, "v_inf": v_inf,
            "bcs": bcs,
            # Cd = coeff_scale·fx (force per unit density from metrics)
            "coeff_scale": 2.0 / (v_inf**2 * np.pi * radius**2),
            # host-built ghost tables for the sharded twin
            # (parallel.ibm_ghost_explicit.partition_ghost_ibm3d)
            **({"ibm_ghost": ibm_kwargs["ibm_ghost"]}
               if ibm_scheme == "ghost" else {}),
        },
    )


def sphere_stretched(
    nx: int = 192,
    ny: int = 96,
    nz: int = 96,
    Re: float = 100.0,
    v_inf: float = 1.0,
    radius: float = 0.5,
    center: tuple[float, float, float] = (4.0, 4.0, 4.0),
    domain: tuple[float, float, float] = (16.0, 8.0, 8.0),
    scheme: str = "tvd",
    refine_strength: float = 3.0,
    refine_width: float = 1.2,
    wake_length: float = 4.0,
    ibm_ramp_steps: int = 200,
    ibm_profile: str = "sharp",
    ibm_scheme: str = "penalize",
    perturb: float = 0.0,
    **cfg_overrides,
) -> Case:
    """Flow past a sphere on a body+wake-refined stretched 3D MAC grid —
    the boundary-layer tier for the sphere benchmarks: Gaussian grid
    clustering around the body (all three axes) and the near wake (x),
    exact 3D fast-diagonalization (dense matmul) projection, TVD
    convection, sharp-mask penalization with VOLUME-weighted force
    accounting and an AREA-weighted mass-consistent outflow. At the
    defaults the near-body spacing is ~3-4× finer than uniform
    ``sphere`` at equal cell count — the resolution that the Re ≳ 200
    drag bias and the Re=300 hairpin-shedding onset need
    (BENCHNOTES "3D IBM sphere tier").

    ``ibm_scheme="ghost"`` swaps the penalization masks for the
    ghost-cell direct-forcing wall treatment (ibm_ghost.py): no-slip
    placed exactly at r = R via mirror reflection along the surface
    normal — removes the staircase O(h/2) effective-radius bias that
    dominates the thin-boundary-layer drag error."""
    import numpy as np

    from cfdsim_tpu.grid import Grid3D
    from cfdsim_tpu.ibm import (
        potential_flow_sphere_faces,
        sphere_masks_faces,
    )
    from cfdsim_tpu.models import mac3d
    from cfdsim_tpu.models import mac_stretched3d as ms3
    from cfdsim_tpu.models.mac_stretched import stretched_faces

    xf = stretched_faces(
        nx, domain[0],
        refine=[(center[0], refine_width, refine_strength),
                (center[0] + 0.5 * wake_length, wake_length,
                 0.5 * refine_strength)],
    )
    yf = stretched_faces(
        ny, domain[1], refine=[(center[1], refine_width, refine_strength)]
    )
    zf = stretched_faces(
        nz, domain[2], refine=[(center[2], refine_width, refine_strength)]
    )
    h_min = float(min(np.diff(xf).min(), np.diff(yf).min(),
                      np.diff(zf).min()))
    defaults = dict(
        cfl_target=0.4,
        dt_max=0.4 * h_min / max(v_inf, 1e-10),
        dt_min=1e-6,
        max_velocity=5.0 * v_inf,
    )
    defaults.update(cfg_overrides)
    cfg = ms3.StretchedMAC3DConfig(
        nx=nx, ny=ny, nz=nz, nu=v_inf * 2 * radius / Re, scheme=scheme,
        **defaults,
    )
    masks = sphere_masks_faces(xf, yf, zf, center, radius,
                               profile=ibm_profile)
    if ibm_scheme == "ghost":
        from cfdsim_tpu.ibm_ghost import sphere_ghost_ibm

        ghost = sphere_ghost_ibm(xf, yf, zf, center, radius)
        ibm_kwargs = dict(ibm_ghost=ghost)
    elif ibm_scheme == "penalize":
        ibm_kwargs = dict(
            ibm_mask_u=masks[0], ibm_mask_v=masks[1], ibm_mask_w=masks[2]
        )
    else:
        raise ValueError(f"unknown ibm_scheme {ibm_scheme!r}")
    yc = 0.5 * (yf[:-1] + yf[1:])
    zc = 0.5 * (zf[:-1] + zf[1:])
    # x-face areas h_y⊗h_z for the area-weighted outflow mass balance
    fw = np.diff(zf)[:, None] * np.diff(yf)[None, :]
    if perturb:
        Zc, Yc = np.meshgrid(zc, yc, indexing="ij")
        profile = jnp.asarray(
            1.0
            + perturb
            * np.sin(2 * np.pi * Yc / domain[1])
            * np.sin(2 * np.pi * Zc / domain[2]),
            jnp.float32,
        )
    else:
        profile = None
    bcs = mac3d.external_flow_bcs3d(
        v_inf, inlet_profile=profile, face_weights=fw
    )
    step = ms3.make_step(
        cfg, bcs, xf, yf, zf, ibm_ramp_steps=ibm_ramp_steps, **ibm_kwargs
    )
    u0, v0, w0 = potential_flow_sphere_faces(
        xf, yf, zf, center, radius, v_inf, *masks
    )
    state = ms3.init_state(cfg)._replace(u=u0, v=v0, w=w0)
    grid = Grid3D(nx=nx, ny=ny, nz=nz, x_max=domain[0], y_max=domain[1],
                  z_max=domain[2], centering="cell")  # nominal descriptor
    return Case(
        "sphere_stretched", cfg, step, state, grid,
        {
            "x_faces": xf, "y_faces": yf, "z_faces": zf,
            "ibm_masks": masks, "center": center, "radius": radius,
            "v_inf": v_inf, "h_min": h_min, "bcs": bcs,
            "coeff_scale": 2.0 / (v_inf**2 * np.pi * radius**2),
            **({"ibm_ghost": ibm_kwargs["ibm_ghost"]}
               if ibm_scheme == "ghost" else {}),
        },
    )


def heated_sphere(
    nx: int = 192,
    ny: int = 96,
    nz: int = 96,
    Re: float = 100.0,
    Pr: float = 0.7,
    v_inf: float = 1.0,
    radius: float = 0.5,
    center: tuple[float, float, float] = (4.0, 4.0, 4.0),
    domain: tuple[float, float, float] = (16.0, 8.0, 8.0),
    scheme: str = "tvd",
    theta_scheme: str = "upwind",
    ibm_ramp_steps: int = 200,
    ibm_profile: str = "sharp",
    ibm_scheme: str = "penalize",
    **cfg_overrides,
) -> Case:
    """Forced convection from an isothermal sphere — 3D scalar transport
    coupled to the IBM external flow (models/transport3d.py): θ=1 body
    in a θ=0 stream, heat flux from the θ-penalization source, Nusselt
    number validated against Ranz–Marshall Nu = 2 + 0.6·Re^½·Pr^⅓
    (``validation.sphere_nusselt_ranz_marshall``; Nu(Re=100, Pr=0.7)
    ≈ 7.33). The reference's transport capability ceiling is 2D
    (beyond-reference tier). Metrics: fx/fy/fz body forces, q_body,
    nusselt, theta extrema.

    Resolution requirement (BENCHNOTES forced-convection table): on the
    uniform grid the Nusselt error grows with Re at fixed cells/D —
    +15.5% at Re=100 and +37% at Re=200 at 12 c/D (the thermal BL
    ~D·Re^-1/2·Pr^-1/3 outruns the grid); a warning is emitted below
    16 c/D at Re > 150. ``heated_sphere_stretched`` is the
    resolution-efficient habitat (+5%/+17% at the same cell count);
    its production config ``ibm_scheme="ghost", theta_scheme="tvd"``
    closes the residual scheme-order bias to a Re-independent −6.5%
    vs Ranz–Marshall (round-4 rows, BENCHNOTES)."""
    import numpy as np

    import warnings

    from cfdsim_tpu.grid import Grid3D
    from cfdsim_tpu.ibm import (
        potential_flow_sphere_mac3d,
        sphere_mask_cells,
        sphere_masks_mac3d,
    )
    from cfdsim_tpu.models import mac3d
    from cfdsim_tpu.models import transport3d as t3

    grid = Grid3D(
        nx=nx, ny=ny, nz=nz,
        x_max=domain[0], y_max=domain[1], z_max=domain[2],
        centering="cell",
    )
    mask_u, mask_v, mask_w = sphere_masks_mac3d(
        grid, center, radius, profile=ibm_profile
    )
    xf = grid.x_min + np.arange(nx + 1) * grid.dx
    yf = grid.y_min + np.arange(ny + 1) * grid.dy
    zf = grid.z_min + np.arange(nz + 1) * grid.dz
    mask_c = sphere_mask_cells(xf, yf, zf, center, radius,
                               profile=ibm_profile, width=grid.dx)
    if ibm_scheme == "ghost":
        from cfdsim_tpu.ibm_ghost import sphere_ghost_cells, sphere_ghost_ibm

        ibm_kwargs = dict(
            ibm_ghost=sphere_ghost_ibm(xf, yf, zf, center, radius),
            ibm_ghost_c=sphere_ghost_cells(xf, yf, zf, center, radius),
        )
    elif ibm_scheme == "penalize":
        ibm_kwargs = dict(
            ibm_mask_u=mask_u, ibm_mask_v=mask_v, ibm_mask_w=mask_w,
            ibm_mask_c=mask_c,
        )
    else:
        raise ValueError(f"unknown ibm_scheme {ibm_scheme!r}")
    h = min(grid.dx, grid.dy, grid.dz)
    cells_per_d = 2 * radius / max(grid.dx, grid.dy, grid.dz)
    if Re > 150.0 and cells_per_d < 16.0:
        warnings.warn(
            f"heated_sphere at Re={Re:g} with {cells_per_d:.0f} cells/D: "
            "the uniform grid under-resolves the thermal boundary layer "
            "(Nu over-reports ~+37% at Re=200, 12 c/D — BENCHNOTES); use "
            "heated_sphere_stretched or raise the resolution.",
            stacklevel=2,
        )
    defaults = dict(
        cfl_target=0.4,
        dt_max=0.4 * h / max(v_inf, 1e-10),
        max_velocity=5.0 * v_inf,
    )
    defaults.update(cfg_overrides)
    cfg = t3.Transport3DConfig(
        grid=grid, nu=v_inf * 2 * radius / Re, prandtl=Pr, scheme=scheme,
        theta_scheme=theta_scheme, body_diameter=2 * radius, **defaults
    )
    bcs = mac3d.external_flow_bcs3d(v_inf)
    step = t3.make_step(
        cfg, bcs, ibm_ramp_steps=ibm_ramp_steps, **ibm_kwargs
    )
    u0, v0, w0 = potential_flow_sphere_mac3d(
        grid, center, radius, v_inf, mask_u, mask_v, mask_w
    )
    state = t3.init_state(cfg, u0=u0, v0=v0, w0=w0)
    return Case(
        "heated_sphere", cfg, step, state, grid,
        {
            "ibm_masks": (mask_u, mask_v, mask_w, mask_c),
            "center": center, "radius": radius, "v_inf": v_inf,
            "bcs": bcs,
            "coeff_scale": 2.0 / (v_inf**2 * np.pi * radius**2),
            **({"ibm_ghost": ibm_kwargs["ibm_ghost"],
                "ibm_ghost_c": ibm_kwargs["ibm_ghost_c"]}
               if ibm_scheme == "ghost" else {}),
        },
    )


def heated_sphere_stretched(
    nx: int = 192,
    ny: int = 96,
    nz: int = 96,
    Re: float = 100.0,
    Pr: float = 0.7,
    v_inf: float = 1.0,
    radius: float = 0.5,
    center: tuple[float, float, float] = (4.0, 4.0, 4.0),
    domain: tuple[float, float, float] = (16.0, 8.0, 8.0),
    scheme: str = "tvd",
    theta_scheme: str = "upwind",
    refine_strength: float = 3.0,
    refine_width: float = 1.2,
    wake_length: float = 4.0,
    ibm_ramp_steps: int = 200,
    ibm_profile: str = "sharp",
    ibm_scheme: str = "penalize",
    **cfg_overrides,
) -> Case:
    """Forced convection from an isothermal sphere on the body+wake-
    refined stretched grid — the ``heated_sphere`` physics at
    ``sphere_stretched`` resolution (~30 cells/D near-body at the cell
    count that buys 12 uniform): composes the stretched momentum step
    with a metric-weighted θ update (transport3d.make_stretched_step).
    Nusselt vs Ranz–Marshall (BENCHNOTES heated-sphere table)."""
    import numpy as np

    from cfdsim_tpu.grid import Grid3D
    from cfdsim_tpu.ibm import (
        potential_flow_sphere_faces,
        sphere_mask_cells,
        sphere_masks_faces,
    )
    from cfdsim_tpu.models import mac3d
    from cfdsim_tpu.models import transport3d as t3
    from cfdsim_tpu.models.mac_stretched import stretched_faces

    xf = stretched_faces(
        nx, domain[0],
        refine=[(center[0], refine_width, refine_strength),
                (center[0] + 0.5 * wake_length, wake_length,
                 0.5 * refine_strength)],
    )
    yf = stretched_faces(
        ny, domain[1], refine=[(center[1], refine_width, refine_strength)]
    )
    zf = stretched_faces(
        nz, domain[2], refine=[(center[2], refine_width, refine_strength)]
    )
    h_min = float(min(np.diff(xf).min(), np.diff(yf).min(),
                      np.diff(zf).min()))
    masks = sphere_masks_faces(xf, yf, zf, center, radius,
                               profile=ibm_profile)
    mask_c = sphere_mask_cells(xf, yf, zf, center, radius,
                               profile=ibm_profile)
    if ibm_scheme == "ghost":
        from cfdsim_tpu.ibm_ghost import sphere_ghost_cells, sphere_ghost_ibm

        ibm_kwargs = dict(
            ibm_ghost=sphere_ghost_ibm(xf, yf, zf, center, radius),
            ibm_ghost_c=sphere_ghost_cells(xf, yf, zf, center, radius),
        )
    elif ibm_scheme == "penalize":
        ibm_kwargs = dict(
            ibm_mask_u=masks[0], ibm_mask_v=masks[1], ibm_mask_w=masks[2],
            ibm_mask_c=mask_c,
        )
    else:
        raise ValueError(f"unknown ibm_scheme {ibm_scheme!r}")
    grid = Grid3D(nx=nx, ny=ny, nz=nz, x_max=domain[0], y_max=domain[1],
                  z_max=domain[2], centering="cell")  # nominal descriptor
    defaults = dict(
        cfl_target=0.4,
        dt_max=0.4 * h_min / max(v_inf, 1e-10),
        max_velocity=5.0 * v_inf,
    )
    defaults.update(cfg_overrides)
    cfg = t3.Transport3DConfig(
        grid=grid, nu=v_inf * 2 * radius / Re, prandtl=Pr, scheme=scheme,
        theta_scheme=theta_scheme, body_diameter=2 * radius, **defaults
    )
    fw = np.diff(zf)[:, None] * np.diff(yf)[None, :]
    bcs = mac3d.external_flow_bcs3d(v_inf, face_weights=fw)
    step = t3.make_stretched_step(
        cfg, bcs, xf, yf, zf, ibm_ramp_steps=ibm_ramp_steps, **ibm_kwargs
    )
    u0, v0, w0 = potential_flow_sphere_faces(
        xf, yf, zf, center, radius, v_inf, *masks
    )
    state = t3.init_state(cfg, u0=u0, v0=v0, w0=w0)
    return Case(
        "heated_sphere_stretched", cfg, step, state, grid,
        {
            "x_faces": xf, "y_faces": yf, "z_faces": zf,
            "ibm_masks": (*masks, mask_c), "center": center,
            "radius": radius, "v_inf": v_inf, "h_min": h_min,
            "bcs": bcs,
            "coeff_scale": 2.0 / (v_inf**2 * np.pi * radius**2),
            **({"ibm_ghost": ibm_kwargs["ibm_ghost"],
                "ibm_ghost_c": ibm_kwargs["ibm_ghost_c"]}
               if ibm_scheme == "ghost" else {}),
        },
    )


def cavity3d_stretched(
    n: int = 48,
    Re: float = 400.0,
    lid_velocity: float = 1.0,
    beta: float = 1.5,
    **cfg_overrides,
) -> Case:
    """3D lid-driven cavity on a tanh wall-clustered stretched MAC grid
    with the exact 3D fast-diagonalization (dense matmul) pressure solve —
    the 3D member of the stretched tier (cavity_stretched is 2D); lid at
    z_hi moving in +x as in cavity3d (BASELINE config 5)."""
    from cfdsim_tpu.grid import Grid3D
    from cfdsim_tpu.models import mac_stretched3d as ms3
    from cfdsim_tpu.models.mac_stretched import wall_clustered_faces

    xf = wall_clustered_faces(n, 1.0, beta=beta)
    yf = wall_clustered_faces(n, 1.0, beta=beta)
    zf = wall_clustered_faces(n, 1.0, beta=beta)
    h_min = float((xf[1:] - xf[:-1]).min())
    defaults = dict(
        cfl_target=0.4,
        dt_max=0.4 * h_min / max(lid_velocity, 1e-10),
        max_velocity=5.0 * lid_velocity,
    )
    defaults.update(cfg_overrides)
    cfg = ms3.StretchedMAC3DConfig(
        nx=n, ny=n, nz=n, nu=lid_velocity / Re, **defaults
    )
    bcs = ms3.cavity3d_bcs(lid_velocity)
    step = ms3.make_step(cfg, bcs, xf, yf, zf)
    state = ms3.init_state(cfg)
    grid = Grid3D(nx=n, ny=n, nz=n)  # nominal uniform descriptor
    return Case("cavity3d_stretched", cfg, step, state, grid,
                {"x_faces": xf, "y_faces": yf, "z_faces": zf, "beta": beta,
                 "lid_velocity": lid_velocity, "bcs": bcs})


def heated_cavity(
    n: int = 64,
    Ra: float = 1e4,
    Pr: float = 0.71,
    theta_scheme: str = "central",
    **cfg_overrides,
) -> Case:
    """Differentially heated square cavity (Boussinesq natural convection,
    MAC tier): hot wall θ=1 at x=0, cold at x=1, adiabatic top/bottom.
    Validated against the de Vahl Davis (1983) benchmark — average
    hot-wall Nusselt Nu = 1.118 (Ra=10³) / 2.243 (Ra=10⁴), matched to
    <0.5% at 64² (BENCHNOTES). A capability the reference never had."""
    from cfdsim_tpu.models import boussinesq as bq

    grid = Grid(nx=n, ny=n, centering="cell")
    cfg = bq.BoussinesqConfig(
        grid=grid, rayleigh=Ra, prandtl=Pr, theta_scheme=theta_scheme,
        **cfg_overrides,
    )
    step = bq.make_step(cfg)
    state = bq.init_state(cfg)
    return Case("heated_cavity", cfg, step, state, grid,
                {"Ra": Ra, "Pr": Pr})


def rayleigh_benard(
    ny: int = 48,
    aspect: float = 2.0,
    Ra: float = 3000.0,
    Pr: float = 0.71,
    perturb: float = 1e-3,
    seed: int = 0,
    **cfg_overrides,
) -> Case:
    """Rayleigh–Bénard convection: heated from below in an aspect-ratio
    box with adiabatic side walls. Linear-stability validation: the
    conducting state is stable below the critical Rayleigh number
    Ra_c = 1708 (rigid-rigid) and convection rolls grow above it
    (tests/test_boussinesq.py brackets the onset). ``perturb`` seeds the
    instability with a small random θ disturbance."""
    import numpy as np

    from cfdsim_tpu.models import boussinesq as bq

    nx = int(round(ny * aspect))
    grid = Grid(nx=nx, ny=ny, x_max=aspect, y_max=1.0, centering="cell")
    cfg = bq.BoussinesqConfig(
        grid=grid, rayleigh=Ra, prandtl=Pr, heated_axis="y", **cfg_overrides
    )
    step = bq.make_step(cfg)
    rng = np.random.default_rng(seed)
    yc = (np.arange(ny, dtype=np.float32) + 0.5) / ny
    conducting = (1.0 - yc)[:, None] * np.ones((ny, nx), np.float32)
    theta0 = conducting + perturb * rng.standard_normal((ny, nx)).astype(
        np.float32
    )
    state = bq.init_state(cfg, theta0=theta0)
    return Case("rayleigh_benard", cfg, step, state, grid,
                {"Ra": Ra, "Pr": Pr, "aspect": aspect})


def heated_cube(
    n: int = 48,
    Ra: float = 1e4,
    Pr: float = 0.71,
    theta_scheme: str = "central",
    **cfg_overrides,
) -> Case:
    """Differentially heated cube (3D Boussinesq natural convection on the
    mac3d tier): hot x=0 wall, cold x=1, adiabatic elsewhere, gravity −z.
    Validated against the Tric, Labrosse & Betrouni (2000) spectral cube
    benchmark: Nu = 2.054 (Ra=10⁴) / 4.337 (Ra=10⁵) — matched to <1%
    (BENCHNOTES)."""
    from cfdsim_tpu.grid import Grid3D
    from cfdsim_tpu.models import boussinesq3d as b3

    grid = Grid3D(nx=n, ny=n, nz=n, centering="cell")
    cfg = b3.Boussinesq3DConfig(
        grid=grid, rayleigh=Ra, prandtl=Pr, theta_scheme=theta_scheme,
        **cfg_overrides,
    )
    step = b3.make_step(cfg)
    state = b3.init_state(cfg)
    return Case("heated_cube", cfg, step, state, grid, {"Ra": Ra, "Pr": Pr})


def blast3d(
    n: int = 64,
    gamma: float = 1.4,
    p_ratio: float = 10.0,
    r0: float = 0.15,
    flux: str = "hllc",
    reconstruction: str = "muscl",
    cfl: float = 0.3,
    **cfg_overrides,
) -> Case:
    """3D spherical blast in a closed reflective box — the 3D compressible
    demo (the reference's shock family is 2D only): a high-pressure sphere
    of radius ``r0`` at the box center drives an expanding spherical shock.
    Axis-isotropy of the dimension-split solver is testable by comparing
    the three axis profiles through the center."""
    import numpy as np

    from cfdsim_tpu.grid import Grid3D
    from cfdsim_tpu.models import compressible3d as c3

    grid = Grid3D(nx=n, ny=n, nz=n)
    cfg = c3.Compressible3DConfig(
        grid=grid, gamma=gamma, flux=flux, reconstruction=reconstruction,
        cfl=cfl, **cfg_overrides,
    )
    h = 1.0 / n
    c = (np.arange(n) + 0.5) * h
    Z, Y, X = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Z - 0.5) ** 2)
    p0 = np.where(r <= r0, p_ratio, 1.0).astype(np.float32)
    rho0 = np.ones_like(p0)
    zero = np.zeros_like(p0)
    U0 = c3.prim_to_cons_3d(
        jnp.asarray(rho0), jnp.asarray(zero), jnp.asarray(zero),
        jnp.asarray(zero), jnp.asarray(p0), gamma,
    )

    def bc(U, step, t):
        # reflective on all six faces: copy the adjacent interior layer
        # and flip the normal momentum
        for arr_axis, mom in ((1, 3), (2, 2), (3, 1)):  # z,y,x → ρw,ρv,ρu
            lo_src = jax.lax.slice_in_dim(U, 1, 2, axis=arr_axis)
            hi_src = jax.lax.slice_in_dim(
                U, U.shape[arr_axis] - 2, U.shape[arr_axis] - 1, axis=arr_axis
            )
            lo = lo_src.at[mom].mul(-1.0)
            hi = hi_src.at[mom].mul(-1.0)
            mid = jax.lax.slice_in_dim(
                U, 1, U.shape[arr_axis] - 1, axis=arr_axis
            )
            U = jnp.concatenate([lo, mid, hi], axis=arr_axis)
        return U

    import jax

    step = c3.make_step(cfg, bc)
    state = c3.init_state(cfg, U0)
    return Case("blast3d", cfg, step, state, grid, {"r0": r0, "p_ratio": p_ratio})


def cylinder_fem(
    re: float = 100.0,
    space: str = "p1p1",
    h_far: float = 0.2,
    h_near: float = 0.02,
    dt: float = 0.05,
    v_inf: float = 1.0,
    tau_h=None,
    wake_refine: bool = False,
    gmres_tol: float = 1e-5,
    perturb: float = 0.03,
    theta: float = 1.0,
    precision: str = "fp32",
    scheme: str = "monolithic",
    pp_tol: float = 1e-6,
    rotational: float = 0.0,
    supg: float = 0.0,
    stab: str = "bp",
    viz_shape: tuple = (200, 300),
    mesh=None,
):
    """Unstructured-FEM flow over a cylinder — the reference's Julia/
    Gridap family (v2.jl "efficient" configuration: domain [-L,8L]×
    [-2L,2L], D = L = 1 cylinder at (3L,0), uniform inlet V∞, no-slip
    walls/cylinder, h 0.02→0.2 grading, dt=0.05, semi-implicit P1-P1 +
    τ stabilization; ``space="p2p1"`` gives v1.jl's Taylor-Hood setup).
    ``wake_refine`` adds an h=2·h_near wake band (beyond-reference: the
    boundary-layer/wake resolution gmsh's pure distance grading lacks).
    Extras carry the mesh/spaces/ops/sampler for viz and force readout;
    metrics fx/fy are the reaction drag/lift per unit density
    (Cd = 2·fx / (V∞²·D)). ``scheme="projection"`` swaps the monolithic
    saddle-point solve for the segregated incremental pressure-
    correction step (``pp_tol``/``rotational`` tune it);
    ``stab="pspg"`` swaps the monolithic's τ∇p·∇q stabilization for
    the consistent residual (PSPG) form — no near-body pressure
    diffusion, so the monolithic Cd/St bias disappears (FEMConfig)."""
    from cfdsim_tpu.fem.mesh import cylinder_mesh
    from cfdsim_tpu.fem.sample import build_sampler
    from cfdsim_tpu.fem.spaces import build_spaces, dirichlet_values
    from cfdsim_tpu.fem.assembly import build_element_ops
    from cfdsim_tpu.models import fem as mfem

    if mesh is None:
        L = 1.0
        mesh = cylinder_mesh(
            h_far=h_far,
            h_near=h_near,
            x_span=(-L, 8 * L),
            y_span=(-2 * L, 2 * L),
            center=(3 * L, 0.0),
            radius=L / 2,
            wake_box=(3 * L, 7.5 * L, -1.0, 1.0) if wake_refine else None,
            h_wake=2 * h_near if wake_refine else None,
        )
    else:
        # external mesh (e.g. fem.msh_io.read_msh of the reference's gmsh
        # artifact): geometry must carry the fitted cylinder circle
        L = 2.0 * mesh.geometry["cylinder_radius"]
    cx, cy = mesh.geometry.get("cylinder_center", (3.0, 0.0))
    spaces = build_spaces(mesh, space)
    import jax.numpy as _jnp

    # fp64 needs jax_enable_x64 (CPU): removes the fp32 GMRES stagnation
    # floor (~1e-4 at >=10k tris) and the large-restart NaN fragility
    dtype = _jnp.float64 if precision == "fp64" else _jnp.float32
    ops = build_element_ops(spaces, dtype=dtype)
    nu = v_inf * L / re
    cfg = mfem.FEMConfig(
        nu=nu, dt=dt, space=space, v_inf=v_inf, tau_h=tau_h,
        gmres_tol=gmres_tol, theta=theta,
        pp_tol=pp_tol, rotational=rotational, supg=supg, stab=stab,
    )
    g = dirichlet_values(
        spaces,
        {
            "inlet": lambda x, y: (v_inf + 0 * x, 0 * y),
            "walls": lambda x, y: (0 * x, 0 * y),
            "cylinder": lambda x, y: (0 * x, 0 * y),
        },
    )
    # Stokes init: restart kept at 40 — fp32 batched Gram-Schmidt goes
    # NaN at restart>~80 on larger meshes (CLAUDE.md) — with extra block-
    # preconditioner sweeps instead; ~1e-4 init residual is washed out by
    # the transient. Non-finite solves fall back to the Dirichlet lift
    # (the reference's own fallback, v1.jl:195-198).
    stokes_cfg = dataclasses.replace(
        cfg, gmres_restart=40, gmres_maxiter=30, pc_sweeps=4
    )
    state = mfem.solve_stokes(ops, stokes_cfg, g)
    if not bool(jnp.isfinite(state.u).all()):
        state = state._replace(
            u=jnp.asarray(g, jnp.float32),
            p=jnp.zeros((ops.n_p,), jnp.float32),
        )
    if perturb:
        # symmetry-breaking wake seed (one-sided v bump behind the body)
        # so shedding onsets promptly instead of waiting on fp32 noise —
        # the reference leans on solver noise for the same role
        xp, yp = spaces.u_points[:, 0], spaces.u_points[:, 1]
        bump = perturb * np.exp(
            -(((xp - (cx + L)) / (0.7 * L)) ** 2
              + ((yp - cy) / (0.7 * L)) ** 2)
        )
        bump[spaces.dirichlet_mask] = 0.0
        state = state._replace(
            u=state.u.at[:, 1].add(jnp.asarray(bump, state.u.dtype))
        )
    if scheme == "projection":
        step = mfem.make_projection_step(
            ops, cfg, g, mesh.tags["outlet"],
            force_nodes=spaces.dirichlet_tag_nodes["cylinder"],
        )
        # seed the pressure-increment carry: enables the CG warm start
        state = state._replace(
            phi=jnp.zeros((ops.n_p,), dtype=state.p.dtype)
        )
    else:
        step = mfem.make_step(
            ops, cfg, g, force_nodes=spaces.dirichlet_tag_nodes["cylinder"]
        )
    ny, nx = viz_shape
    # the reference's 300×200 viz window (v2.jl:278-279), center-relative
    # so imported meshes with other domains frame the same wake region
    grid = Grid(nx=nx, ny=ny, x_min=cx - 3.5 * L, x_max=cx + 4 * L,
                y_min=cy - 1.5 * L, y_max=cy + 1.5 * L)
    sampler = build_sampler(spaces, grid.x_coords(), grid.y_coords())
    return Case(
        "cylinder_fem",
        cfg,
        step,
        state,
        grid,
        {
            "mesh": mesh,
            "spaces": spaces,
            "ops": ops,
            "sampler": sampler,
            "g": g,
            "re": re,
            "diameter": L,
        },
    )


def cavity_fem(
    n: int = 48,
    Re: float = 100.0,
    space: str = "p1p1",
    dt: float = 0.05,
    lid_velocity: float = 1.0,
    gmres_tol: float = 1e-5,
    theta: float = 1.0,
    stab: str = "bp",
    viz_shape: tuple = (128, 128),
):
    """Lid-driven cavity on the unstructured FEM tier — cross-validates
    the FEM discretization against the structured tiers on the same
    Ghia benchmark (`validation.ghia_error_profiles`). All four sides
    are velocity-Dirichlet (``build_spaces(dirichlet_tags=...)``; no
    do-nothing outlet), lid u=V on the top edge with zeroed corners
    (non-leaky); the enclosed pressure is defined only up to a constant
    — GMRES minimizes in the quotient space and the τ/PSPG continuity
    stabilization keeps the solve well-behaved. Monolithic scheme only
    (the projection scheme needs pressure-Dirichlet outflow nodes).
    Beyond-reference: the reference's FEM family only ran the cylinder
    channel (v2.jl)."""
    from cfdsim_tpu.fem.mesh import rectangle_mesh
    from cfdsim_tpu.fem.sample import build_sampler
    from cfdsim_tpu.fem.spaces import build_spaces, dirichlet_values
    from cfdsim_tpu.fem.assembly import build_element_ops
    from cfdsim_tpu.models import fem as mfem

    mesh = rectangle_mesh(n, n, crisscross=True)
    spaces = build_spaces(
        mesh, space, dirichlet_tags=("inlet", "outlet", "walls", "cylinder")
    )
    ops = build_element_ops(spaces)
    nu = lid_velocity / Re
    cfg = mfem.FEMConfig(
        nu=nu, dt=dt, space=space, v_inf=lid_velocity,
        gmres_tol=gmres_tol, theta=theta, stab=stab,
    )
    eps = 0.25 / n

    def lid(x, y):
        on_lid = (y > 1.0 - eps) & (x > eps) & (x < 1.0 - eps)
        return (lid_velocity * on_lid.astype(np.float64), 0.0 * y)

    zero = lambda x, y: (0.0 * x, 0.0 * y)
    g = dirichlet_values(
        spaces, {"walls": lid, "inlet": zero, "outlet": zero}
    )
    state = mfem.solve_stokes(
        ops,
        dataclasses.replace(cfg, gmres_restart=40, gmres_maxiter=30,
                            pc_sweeps=4),
        g,
    )
    if not bool(jnp.isfinite(state.u).all()):
        state = state._replace(
            u=jnp.asarray(g, jnp.float32),
            p=jnp.zeros((ops.n_p,), jnp.float32),
        )
    step = mfem.make_step(ops, cfg, g)
    ny, nx = viz_shape
    grid = Grid(nx=nx, ny=ny)
    sampler = build_sampler(spaces, grid.x_coords(), grid.y_coords())
    return Case(
        "cavity_fem",
        cfg,
        step,
        state,
        grid,
        {"mesh": mesh, "spaces": spaces, "ops": ops, "sampler": sampler,
         "g": g, "re": Re},
    )


def schafer_turek_fem(
    re: float = 100.0,
    space: str = "p1p1",
    h_near: float = 0.008,
    h_far: float = 0.04,
    dt: float = 0.0025,
    u_mean: float = 1.0,
    gmres_tol: float = 1e-5,
    theta: float = 1.0,
    wake_refine: bool = False,
    precision: str = "fp32",
    scheme: str = "monolithic",
    pp_tol: float = 1e-6,
    rotational: float = 0.0,
    supg: float = 0.0,
    stab: str = "bp",
    viz_shape: tuple = (120, 640),
):
    """Schäfer–Turek 2D-2 benchmark on the FEM tier: channel
    [0,2.2]×[0,0.41], D=0.1 cylinder at (0.2,0.2) (deliberately
    off-center — self-triggers shedding), parabolic inlet with
    Um=1.5·ū. Published targets at Re=ūD/ν=100: Cd≈3.22–3.24,
    Cl amplitude ≈ ±1.0, St≈0.295–0.305. A quantitative validation the
    reference's Gridap family (v1.jl/v2.jl) never ran; force
    coefficients are Cd = 2·fx/(ū²D), Cl = 2·fy/(ū²D).
    ``scheme="projection"`` swaps in the segregated incremental
    pressure-correction step (``pp_tol``/``rotational`` tune it);
    ``stab="pspg"`` gives the monolithic the consistent residual-based
    stabilization (removes the τ-damping Cd/St bias, FEMConfig);
    the steady 2D-1 variant of this benchmark is re=20, u_mean=0.2."""
    from cfdsim_tpu.fem.mesh import cylinder_mesh
    from cfdsim_tpu.fem.sample import build_sampler
    from cfdsim_tpu.fem.spaces import build_spaces, dirichlet_values
    from cfdsim_tpu.fem.assembly import build_element_ops
    from cfdsim_tpu.models import fem as mfem

    H, Lx, D = 0.41, 2.2, 0.1
    u_max = 1.5 * u_mean
    mesh = cylinder_mesh(
        h_far=h_far,
        h_near=h_near,
        x_span=(0.0, Lx),
        y_span=(0.0, H),
        center=(0.2, 0.2),
        radius=D / 2,
        grade=0.2,
        wake_box=(0.2, 1.4, 0.06, 0.35) if wake_refine else None,
        h_wake=2.0 * h_near if wake_refine else None,
    )
    spaces = build_spaces(mesh, space)
    import jax.numpy as _jnp

    # fp64 needs jax_enable_x64 (CPU): removes the fp32 GMRES stagnation
    # floor (~1e-4 at >=10k tris) and the large-restart NaN fragility
    dtype = _jnp.float64 if precision == "fp64" else _jnp.float32
    ops = build_element_ops(spaces, dtype=dtype)
    nu = u_mean * D / re
    cfg = mfem.FEMConfig(
        nu=nu, dt=dt, space=space, v_inf=u_max, gmres_tol=gmres_tol,
        theta=theta, pp_tol=pp_tol, rotational=rotational, supg=supg,
        stab=stab,
    )
    g = dirichlet_values(
        spaces,
        {
            "inlet": lambda x, y: (
                4.0 * u_max * y * (H - y) / H**2,
                0 * y,
            ),
            "walls": lambda x, y: (0 * x, 0 * y),
            "cylinder": lambda x, y: (0 * x, 0 * y),
        },
    )
    # Stokes init: restart kept at 40 — fp32 batched Gram-Schmidt goes
    # NaN at restart>~80 on larger meshes (CLAUDE.md) — with extra block-
    # preconditioner sweeps instead; ~1e-4 init residual is washed out by
    # the transient. Non-finite solves fall back to the Dirichlet lift
    # (the reference's own fallback, v1.jl:195-198).
    stokes_cfg = dataclasses.replace(
        cfg, gmres_restart=40, gmres_maxiter=30, pc_sweeps=4
    )
    state = mfem.solve_stokes(ops, stokes_cfg, g)
    if not bool(jnp.isfinite(state.u).all()):
        state = state._replace(
            u=jnp.asarray(g, jnp.float32),
            p=jnp.zeros((ops.n_p,), jnp.float32),
        )
    if scheme == "projection":
        step = mfem.make_projection_step(
            ops, cfg, g, mesh.tags["outlet"],
            force_nodes=spaces.dirichlet_tag_nodes["cylinder"],
        )
        # seed the pressure-increment carry: enables the CG warm start
        state = state._replace(
            phi=jnp.zeros((ops.n_p,), dtype=state.p.dtype)
        )
    else:
        step = mfem.make_step(
            ops, cfg, g, force_nodes=spaces.dirichlet_tag_nodes["cylinder"]
        )
    ny, nx = viz_shape
    grid = Grid(nx=nx, ny=ny, x_min=0.0, x_max=Lx, y_min=0.0, y_max=H)
    sampler = build_sampler(spaces, grid.x_coords(), grid.y_coords())
    return Case(
        "schafer_turek_fem",
        cfg,
        step,
        state,
        grid,
        {
            "mesh": mesh,
            "spaces": spaces,
            "ops": ops,
            "sampler": sampler,
            "g": g,
            "re": re,
            "diameter": D,
            "u_mean": u_mean,
            # coefficient scale: Cd = coeff_scale·fx
            "coeff_scale": 2.0 / (u_mean**2 * D),
        },
    )


CASES: dict[str, Callable[..., Case]] = {
    "cavity": lid_cavity,
    "cavity_mac": lid_cavity_mac,
    "cavity_stretched": cavity_stretched,
    "channel": channel,
    "cylinder": cylinder,
    "cylinder_mac": cylinder_mac,
    "cylinder_fem": cylinder_fem,
    "cavity_fem": cavity_fem,
    "schafer_turek_fem": schafer_turek_fem,
    "cylinder_stretched": cylinder_stretched,
    "cylinder_oscillating": cylinder_oscillating,
    "wedge": wedge,
    "cavity_supersonic": cavity_supersonic,
    "kolmogorov": kolmogorov,
    "kolmogorov_ps": kolmogorov_ps,
    "transport": transport,
    "cavity3d": cavity3d,
    "cavity3d_mac": cavity3d_mac,
    "cavity3d_stretched": cavity3d_stretched,
    "sphere": sphere_mac3d,
    "sphere_stretched": sphere_stretched,
    "heated_sphere": heated_sphere,
    "heated_sphere_stretched": heated_sphere_stretched,
    "heated_cavity": heated_cavity,
    "rayleigh_benard": rayleigh_benard,
    "heated_cube": heated_cube,
    "blast3d": blast3d,
}


def build(name: str, **kwargs) -> Case:
    """Build a named case; later modules register wedge/cavity_supersonic/
    kolmogorov/transport here."""
    try:
        builder = CASES[name]
    except KeyError:
        raise KeyError(f"unknown case {name!r}; available: {sorted(CASES)}")
    return builder(**kwargs)
