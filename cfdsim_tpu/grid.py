"""Structured uniform grids.

Replaces the reference's per-script ``setup_grid`` (meshgrid + linspace,
e.g. reference v5.py:269-273, v1_shock.py:234-238, cavity_flow_v1.py:258-262)
with one static, hashable ``Grid`` object that can be closed over by jitted
functions. Arrays are laid out (ny, nx) so the x axis is the contiguous one.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid:
    """A uniform 2D structured grid (node-centered by default).

    ``ng`` ghost layers extend the domain on every side (the reference's
    NG=2 ghost-cell layout, cavity_flow_v1.py:258-262). Interior shape is
    (ny, nx); padded shape is (ny + 2*ng, nx + 2*ng).
    """

    nx: int
    ny: int
    x_min: float = 0.0
    x_max: float = 1.0
    y_min: float = 0.0
    y_max: float = 1.0
    ng: int = 0
    # node: points at domain boundaries, dx = L/(n-1)  (reference v5.py:78)
    # cell: cell centers, dx = L/n                     (reference v1_shock.py:62)
    centering: str = "node"

    def __post_init__(self):
        assert self.centering in ("node", "cell")
        assert self.nx >= 4 and self.ny >= 4

    @cached_property
    def dx(self) -> float:
        n = self.nx - 1 if self.centering == "node" else self.nx
        return (self.x_max - self.x_min) / n

    @cached_property
    def dy(self) -> float:
        n = self.ny - 1 if self.centering == "node" else self.ny
        return (self.y_max - self.y_min) / n

    @property
    def shape(self) -> tuple[int, int]:
        """Padded array shape (ny_total, nx_total) including ghosts."""
        return (self.ny + 2 * self.ng, self.nx + 2 * self.ng)

    @property
    def interior(self) -> tuple[slice, slice]:
        """Slices selecting the physical interior of a padded array."""
        if self.ng == 0:
            return (slice(None), slice(None))
        return (slice(self.ng, -self.ng), slice(self.ng, -self.ng))

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny

    def x_coords(self) -> np.ndarray:
        """1D x coordinates, including ghost points if ng > 0."""
        if self.centering == "node":
            x0, x1 = self.x_min - self.ng * self.dx, self.x_max + self.ng * self.dx
            return np.linspace(x0, x1, self.nx + 2 * self.ng)
        # cell centers
        i = np.arange(-self.ng, self.nx + self.ng) + 0.5
        return self.x_min + i * self.dx

    def y_coords(self) -> np.ndarray:
        if self.centering == "node":
            y0, y1 = self.y_min - self.ng * self.dy, self.y_max + self.ng * self.dy
            return np.linspace(y0, y1, self.ny + 2 * self.ng)
        j = np.arange(-self.ng, self.ny + self.ng) + 0.5
        return self.y_min + j * self.dy

    def meshgrid(self) -> tuple[np.ndarray, np.ndarray]:
        """(X, Y) arrays of shape (ny_total, nx_total); row i = y, col j = x."""
        X, Y = np.meshgrid(self.x_coords(), self.y_coords(), indexing="xy")
        return X, Y

    def zeros(self, dtype=jnp.float32):
        return jnp.zeros(self.shape, dtype=dtype)

    def full(self, value, dtype=jnp.float32):
        return jnp.full(self.shape, value, dtype=dtype)

    def scaled(self, factor: int) -> "Grid":
        """A grid with nx, ny multiplied by ``factor`` (same domain)."""
        return dataclasses.replace(self, nx=self.nx * factor, ny=self.ny * factor)


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """A uniform 3D structured grid, layout (nz, ny, nx)."""

    nx: int
    ny: int
    nz: int
    x_min: float = 0.0
    x_max: float = 1.0
    y_min: float = 0.0
    y_max: float = 1.0
    z_min: float = 0.0
    z_max: float = 1.0
    centering: str = "node"

    @cached_property
    def dx(self) -> float:
        n = self.nx - 1 if self.centering == "node" else self.nx
        return (self.x_max - self.x_min) / n

    @cached_property
    def dy(self) -> float:
        n = self.ny - 1 if self.centering == "node" else self.ny
        return (self.y_max - self.y_min) / n

    @cached_property
    def dz(self) -> float:
        n = self.nz - 1 if self.centering == "node" else self.nz
        return (self.z_max - self.z_min) / n

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nz, self.ny, self.nx)

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny * self.nz

    def zeros(self, dtype=jnp.float32):
        return jnp.zeros(self.shape, dtype=dtype)
