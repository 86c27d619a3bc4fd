"""Multi-chip scaling demo on a virtual device mesh.

Runs the same cavity step single-device and sharded over an N-device 2D
mesh, verifies bitwise-equivalent physics, and reports per-configuration
timing. On several GPUs the mesh spans the cards and halo exchange rides
NVLink; on virtual CPU devices it demonstrates the API and the
correctness invariant.

Run:  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
         python examples/sharded_scaling.py
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def main(n=256, steps=20):
    from cfdsim_tpu.cases import lid_cavity
    from cfdsim_tpu.parallel import make_grid_mesh, make_sharded_step, shard_state

    n_dev = len(jax.devices())
    print(f"devices: {n_dev} × {jax.devices()[0].platform}")

    case = lid_cavity(n=n, Re=1000.0)

    def run(step_fn, state, label):
        f = jax.jit(lambda s: jax.lax.scan(
            lambda st, _: step_fn(st, jnp.float32(1.0)), s, None, length=steps))
        out, _ = f(state)
        float(out.t)
        t0 = time.perf_counter()
        out, _ = f(state)
        float(out.t)
        dt = time.perf_counter() - t0
        print(f"{label:24s} {steps} steps: {dt*1e3:8.1f} ms "
              f"({n*n*steps/dt/1e6:8.1f} Mcell-upd/s)")
        return out

    ref = run(case.step, case.state, "single-device")

    for nd in sorted({2, 4, n_dev} & set(range(1, n_dev + 1))):
        mesh = make_grid_mesh(nd)
        st = shard_state(case.state, mesh)
        step = make_sharded_step(case.step, mesh)
        out = run(step, st, f"mesh {mesh.shape['y']}x{mesh.shape['x']}")
        err = float(jnp.max(jnp.abs(out.u - ref.u)))
        print(f"{'':24s} max |Δu| vs single-device: {err:.2e}")


if __name__ == "__main__":
    main()
