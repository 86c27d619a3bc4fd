"""Explicit halo exchange with ``shard_map`` + ``lax.ppermute``.

The reference's ghost-cell layout (NG=2, cavity_flow_v1.py:258-262) made
inter-chip: each device holds an (ny/py, nx/px) block of the field and
swaps edge lines with its mesh neighbors before applying a
stencil. Corner halos are covered by exchanging the already-y-padded block
along x. Non-periodic global boundaries receive zero halos from the
non-circular permutation, then get clamped (ghost = edge) for the Neumann
operator.

These primitives power the explicit sharded Poisson solve
(``cfdsim_tpu.parallel.sharded.make_sharded_poisson``); the full NS step
can alternatively ride GSPMD auto-partitioning (``make_sharded_step``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P


def _exchange_axis(block, axis_name: str, n_shards: int, axis: int, width: int = 1):
    """(lo_halo, hi_halo) lines received from the prev/next shard along
    ``axis``; zero-filled at the ends of the (non-circular) chain."""
    n = block.shape[axis]
    last = lax.slice_in_dim(block, n - width, n, axis=axis)
    first = lax.slice_in_dim(block, 0, width, axis=axis)
    if n_shards == 1:
        return jnp.zeros_like(last), jnp.zeros_like(first)
    fwd = [(i, i + 1) for i in range(n_shards - 1)]  # i sends to i+1
    bwd = [(i + 1, i) for i in range(n_shards - 1)]  # i+1 sends to i
    lo = lax.ppermute(last, axis_name, fwd)  # my lo halo = prev shard's last lines
    hi = lax.ppermute(first, axis_name, bwd)  # my hi halo = next shard's first lines
    return lo, hi


def halo_exchange(block, py: int, px: int, width: int = 1):
    """Pad a local (ny_l, nx_l) block with ``width`` halo lines on every
    side, filled from mesh neighbors (call inside shard_map over axes
    ("y", "x"))."""
    lo_y, hi_y = _exchange_axis(block, "y", py, axis=0, width=width)
    block = jnp.concatenate([lo_y, block, hi_y], axis=0)
    lo_x, hi_x = _exchange_axis(block, "x", px, axis=1, width=width)
    return jnp.concatenate([lo_x, block, hi_x], axis=1)


def clamp_global_edges(padded, width: int = 1):
    """Overwrite halo lines that lie outside the *global* domain with the
    adjacent edge line (ghost = edge), realizing the Neumann clamped-edge
    convention across the mesh. Must be called inside shard_map."""
    iy = lax.axis_index("y")
    ix = lax.axis_index("x")
    py = lax.axis_size("y")
    px = lax.axis_size("x")
    for w in range(width):
        top = width - 1 - w  # halo line index from the outside in
        bot = padded.shape[0] - width + w
        padded = padded.at[top, :].set(
            jnp.where(iy == 0, padded[width, :], padded[top, :])
        )
        padded = padded.at[bot, :].set(
            jnp.where(iy == py - 1, padded[padded.shape[0] - width - 1, :], padded[bot, :])
        )
        lft = width - 1 - w
        rgt = padded.shape[1] - width + w
        padded = padded.at[:, lft].set(
            jnp.where(ix == 0, padded[:, width], padded[:, lft])
        )
        padded = padded.at[:, rgt].set(
            jnp.where(ix == px - 1, padded[:, padded.shape[1] - width - 1], padded[:, rgt])
        )
    return padded


def global_parity(local_shape: tuple[int, int]):
    """Checkerboard parity mask (gi+gj) % 2 == 0 in *global* indices for a
    local block (inside shard_map)."""
    ny_l, nx_l = local_shape
    iy = lax.axis_index("y")
    ix = lax.axis_index("x")
    rows = iy * ny_l + jax.lax.broadcasted_iota(jnp.int32, (ny_l, nx_l), 0)
    cols = ix * nx_l + jax.lax.broadcasted_iota(jnp.int32, (ny_l, nx_l), 1)
    return ((rows + cols) % 2) == 0


def global_interior_mask(local_shape: tuple[int, int], width: int = 1):
    """1.0 on nodes at least ``width`` from the *global* boundary (inside
    shard_map) — restores the single-device ops' zero frame."""
    ny_l, nx_l = local_shape
    iy = lax.axis_index("y")
    ix = lax.axis_index("x")
    py = lax.axis_size("y")
    px = lax.axis_size("x")
    rows = iy * ny_l + jax.lax.broadcasted_iota(jnp.int32, (ny_l, nx_l), 0)
    cols = ix * nx_l + jax.lax.broadcasted_iota(jnp.int32, (ny_l, nx_l), 1)
    ny_g = py * ny_l
    nx_g = px * nx_l
    ok = (
        (rows >= width)
        & (rows < ny_g - width)
        & (cols >= width)
        & (cols < nx_g - width)
    )
    return ok


def make_sharded_stencil(op, mesh: Mesh, n_in: int = 1, width: int = 1):
    """Lift a single-device stencil op (zero-frame convention) to a sharded
    op over ``mesh``: halo-exchange each input, apply ``op`` on the padded
    blocks, crop, and zero the global frame so results match the unsharded
    op exactly."""
    py = mesh.shape["y"]
    px = mesh.shape["x"]
    spec = P("y", "x")

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=tuple(spec for _ in range(n_in)),
        out_specs=spec,
    )
    def sharded(*blocks):
        padded = [halo_exchange(b, py, px, width) for b in blocks]
        out = op(*padded)
        outs = out if isinstance(out, tuple) else (out,)
        mask = global_interior_mask(blocks[0].shape, width)
        cropped = tuple(
            jnp.where(mask, o[width:-width, width:-width], 0.0) for o in outs
        )
        return cropped if isinstance(out, tuple) else cropped[0]

    return sharded
