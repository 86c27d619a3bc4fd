"""Sharded stepping: GSPMD auto-partitioned full step + explicit
shard_map Poisson.

The production path jits the *same* single-device step function with
``NamedSharding(P("y","x"))`` on the state fields — XLA's SPMD partitioner
inserts the halo collective-permutes for every shifted-slice stencil (the
scaling-book recipe: pick a mesh, annotate shardings, let XLA insert
collectives). The explicit path (``make_sharded_poisson``) demonstrates
manual ``ppermute`` halo exchange with correct red-black ordering across
shards for the inner hot loop.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cfdsim_tpu.parallel.halo import (
    clamp_global_edges,
    global_parity,
    halo_exchange,
)


def _sharding_for(x, mesh: Mesh):
    """(y, x) decomposition for the trailing two axes; 3D fields keep the
    z axis replicated (BASELINE config 5's layout); scalars replicated."""
    if jnp.ndim(x) == 2:
        return NamedSharding(mesh, P("y", "x"))
    if jnp.ndim(x) == 3:
        return NamedSharding(mesh, P(None, "y", "x"))
    return NamedSharding(mesh, P())


def shard_state(state, mesh: Mesh):
    """Place every field of a state pytree on the mesh (2D/3D fields get
    spatial shardings; scalars are replicated)."""

    def place(x):
        x = jnp.asarray(x)
        return jax.device_put(x, _sharding_for(x, mesh))

    return jax.tree_util.tree_map(place, state)


def make_sharded_step(step_fn, mesh: Mesh):
    """Jit a ``step(state, cfl_scale) -> (state, metrics)`` function for a
    state placed on the mesh (via ``shard_state``) — jit propagates the
    committed input shardings and XLA's SPMD partitioner turns every
    shifted-slice stencil into local compute plus halo
    collective-permutes. Call as ``step(state, cfl_scale)``."""
    del mesh  # placement is carried by the state's committed shardings
    return jax.jit(step_fn)


def make_sharded_poisson(
    mesh: Mesh,
    dx: float,
    dy: float,
    iters: int,
    omega: float = 1.7,
):
    """Explicit distributed red-black SOR for the Neumann pressure problem:
    each full sweep performs two halo exchanges (one per color) so the
    black half reads freshly updated red values from neighboring shards —
    the exact Gauss–Seidel ordering of the single-device kernel, with
    ghost-cell swaps between devices instead of shared memory."""
    py = mesh.shape["y"]
    px = mesh.shape["x"]
    ax = 1.0 / (dx * dx)
    ay = 1.0 / (dy * dy)
    spec = P("y", "x")

    @partial(jax.shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=spec)
    def solve(phi_b, rhs_b):
        return rbsor_local(phi_b, rhs_b, py, px, ax, ay, iters, omega)

    return solve


def rbsor_local(phi_b, rhs_b, py: int, px: int, ax: float, ay: float,
                iters: int, omega: float, fluid_b=None):
    """Distributed red-black SOR body for use *inside* shard_map: one halo
    exchange per color half-sweep, clamped global edges (Neumann), colors
    by global parity. ``fluid_b`` (local bool block) freezes φ inside
    embedded solids (reference v5.py:213 masked semantics)."""
    denom_inv = 1.0 / (2.0 * (ax + ay))
    red = global_parity(phi_b.shape)
    black = jnp.logical_not(red)
    if fluid_b is not None:
        red = jnp.logical_and(red, fluid_b)
        black = jnp.logical_and(black, fluid_b)

    def half_sweep(phi, color):
        p = halo_exchange(phi, py, px, width=1)
        p = clamp_global_edges(p, width=1)
        nb = ax * (p[1:-1, 2:] + p[1:-1, :-2]) + ay * (
            p[2:, 1:-1] + p[:-2, 1:-1]
        )
        phi_star = (nb - rhs_b) * denom_inv
        return jnp.where(color, (1.0 - omega) * phi + omega * phi_star, phi)

    def sweep(_, phi):
        phi = half_sweep(phi, red)
        return half_sweep(phi, black)

    return lax.fori_loop(0, iters, sweep, phi_b)
