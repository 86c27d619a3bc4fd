"""Multi-chip staggered (MAC) solver tiers on a device mesh.

Runs the explicit shard_map steps for all three staggered tiers — 2D
uniform (exact distributed DCT projection), 2D wall-clustered stretched
(exact distributed fast-diagonalization), and 3D (z-local, distributed
3D DCT) — each verified against its single-device step, and reports the
post-projection divergence (fp32 roundoff across the mesh: the whole
point of the staggered tier survives sharding).

Run:  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
         python examples/sharded_mac_tiers.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def main(steps=20):
    from cfdsim_tpu.cases import cavity3d_mac, cavity_stretched, lid_cavity_mac
    from cfdsim_tpu.parallel import (
        make_cavity3d_mac_explicit_step,
        make_cavity_mac_explicit_step,
        make_cavity_stretched_explicit_step,
        make_grid_mesh,
        shard_trimmed_state,
        shard_trimmed_state3d,
        trim_state,
        trim_state3d,
    )
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    n_dev = len(jax.devices())
    mesh = make_grid_mesh(n_dev)
    print(f"mesh: {dict(mesh.shape)} on {jax.default_backend()}")

    def drive(name, case, step_ex, t0, compare):
        step_ref = jax.jit(case.step)
        r = case.state
        t = t0
        for _ in range(steps):
            t, m = step_ex(t, jnp.float32(1.0))
            r, _ = step_ref(r, jnp.float32(1.0))
        err = compare(t, r)
        print(f"{name:24s} max|Δ| vs single-device = {err:.2e}   "
              f"div_post = {float(m.div_post):.2e}   "
              f"devices = {len(t.u.sharding.device_set)}")

    case = lid_cavity_mac(n=64, Re=400.0, scheme="tvd",
                          poisson=PoissonConfig(method="dct"))
    drive(
        "2D MAC (DCT)", case,
        make_cavity_mac_explicit_step(case.cfg, mesh),
        shard_trimmed_state(trim_state(case.state), mesh),
        lambda t, r: float(jnp.abs(jnp.asarray(np.asarray(t.u))
                                   - r.u[:, :-1]).max()),
    )

    case = cavity_stretched(n=64, Re=400.0, beta=1.5)
    drive(
        "2D stretched (FDM)", case,
        make_cavity_stretched_explicit_step(
            case.cfg, mesh, case.extras["x_faces"], case.extras["y_faces"]
        ),
        shard_trimmed_state(trim_state(case.state), mesh),
        lambda t, r: float(jnp.abs(jnp.asarray(np.asarray(t.u))
                                   - r.u[:, :-1]).max()),
    )

    case = cavity3d_mac(n=16, Re=100.0)
    drive(
        "3D MAC (3D DCT)", case,
        make_cavity3d_mac_explicit_step(case.cfg, mesh),
        shard_trimmed_state3d(trim_state3d(case.state), mesh),
        lambda t, r: float(jnp.abs(jnp.asarray(np.asarray(t.u))
                                   - r.u[:, :, :-1]).max()),
    )


if __name__ == "__main__":
    main()
