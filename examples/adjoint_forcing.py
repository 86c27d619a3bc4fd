"""Adjoint inverse problem: recover a hidden body force from the flow.

The whole solver is one differentiable JAX function, so PDE-constrained
optimization is just `jax.grad` through the time loop — no hand-derived
adjoint code, checkpointed reverse-mode through every projection solve.
This driver demonstrates it end-to-end on the staggered (MAC) solver:

1. drive the free-slip [0,π]² box with a "hidden" Kolmogorov-type body
   force  f_u(y) = Σ_k c_k sin(k·y)  (true c = [1, 0, 0.5, 0]),
   run N steps, record the velocity field — the "observation";
2. from c = 0, minimize ‖u_N(c) − u_obs‖² with Adam, where
   each evaluation re-runs the full N-step simulation and reverse-mode
   differentiates through it (`lax.scan` + `jax.checkpoint` per step —
   memory stays O(1 step));
3. report the recovered coefficients.

The reference repository has no adjoint capability at all; this is the
kind of thing the JAX design gives for free (see also the
FEM tier's implicit-adjoint `custom_vjp` solve, models/fem.py).

Usage: python examples/adjoint_forcing.py [--n 48] [--steps 200]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(n=48, n_steps=200, iters=60, lr=0.1, verbose=True):
    import jax
    import jax.numpy as jnp

    from cfdsim_tpu.grid import Grid
    from cfdsim_tpu.models import mac
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    cfg = mac.MACConfig(
        grid=Grid(nx=n, ny=n, x_max=np.pi, y_max=np.pi, centering="cell"),
        nu=0.02,
        adaptive_dt=False,  # fixed dt: the control problem stays smooth
        dt_base=2e-3,
        poisson=PoissonConfig(method="dct"),
    )
    bcs = mac.free_slip_bcs()
    h = np.pi / n
    yu = (np.arange(n) + 0.5) * h  # u-face y coordinates
    modes = jnp.asarray(
        np.stack([np.sin((k + 1) * yu) for k in range(4)]),
        jnp.float32,
    )  # (4, ny)

    def simulate(coeffs):
        """N steps under forcing f_u(y) = Σ c_k sin((k+1) y); returns
        the final (u, v)."""
        fu = jnp.einsum("k,ky->y", coeffs, modes)[:, None] * jnp.ones(
            (n, n + 1), jnp.float32
        )
        fv = jnp.zeros((n + 1, n), jnp.float32)
        step = mac.make_step(cfg, bcs, forcing=(fu, fv))

        def body(s, _):
            s2, _ = step(s, jnp.float32(1.0))
            return s2, None

        s0 = mac.init_state(cfg)
        sN, _ = jax.lax.scan(jax.checkpoint(body), s0, None, length=n_steps)
        return sN.u, sN.v

    c_true = jnp.asarray([1.0, 0.0, 0.5, 0.0], jnp.float32)
    u_obs, v_obs = jax.jit(simulate)(c_true)

    @jax.jit
    @jax.value_and_grad
    def loss(c):
        u, v = simulate(c)
        return jnp.mean((u - u_obs) ** 2) + jnp.mean((v - v_obs) ** 2)

    import optax

    opt = optax.adam(lr)
    c = jnp.zeros(4, jnp.float32)
    opt_state = opt.init(c)
    t0 = time.perf_counter()
    for it in range(iters):
        val, g = loss(c)
        upd, opt_state = opt.update(g, opt_state)
        c = c + upd
        if verbose and (it % 10 == 0 or it == iters - 1):
            print(f"  iter {it:3d}  loss {float(val):.3e}  "
                  f"c = {np.asarray(c).round(4).tolist()}", flush=True)
    err = float(jnp.abs(c - c_true).max())
    if verbose:
        print(f"recovered c = {np.asarray(c).round(4).tolist()} "
              f"(true [1.0, 0.0, 0.5, 0.0]); max err {err:.2e}; "
              f"{iters} adjoint solves of {n_steps} steps in "
              f"{time.perf_counter() - t0:.1f} s")
    return err


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--iters", type=int, default=60)
    args = ap.parse_args()
    err = main(n=args.n, n_steps=args.steps, iters=args.iters)
    sys.exit(0 if err < 0.05 else 1)
