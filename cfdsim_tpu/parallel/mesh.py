"""Device mesh construction for 2D grid decomposition."""

from __future__ import annotations

import math

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _factor_2d(n: int) -> tuple[int, int]:
    """Split n devices into the most-square (py, px) factorization."""
    best = (1, n)
    for py in range(1, int(math.isqrt(n)) + 1):
        if n % py == 0:
            best = (py, n // py)
    return best


def make_grid_mesh(
    n_devices: int | None = None,
    topology: tuple[int, int] | None = None,
    devices=None,
) -> Mesh:
    """A 2D mesh with axes ("y", "x") for sharding (ny, nx) fields.

    The mesh follows the algorithm alone: the cards of one host are
    joined all to all (NVLink), so no device order is preferred.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    py, px = topology if topology is not None else _factor_2d(n)
    assert py * px == n, f"topology {py}x{px} != {n} devices"
    import numpy as np

    dev_array = np.asarray(devices).reshape(py, px)
    return Mesh(dev_array, axis_names=("y", "x"))


def field_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for an (ny, nx) field: rows over "y", columns over "x"."""
    return NamedSharding(mesh, P("y", "x"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bring-up: call once per host before building the mesh
    (``jax.distributed.initialize``; pass the coordinator address,
    process count and id — nothing detects a cluster here). After this,
    ``jax.devices()`` spans every host and ``make_grid_mesh`` lays shards
    out over all of them."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
