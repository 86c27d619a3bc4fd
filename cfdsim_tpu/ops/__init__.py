"""Stencil and numerical operators (the reference's Numba kernel tier,
v5.py:96-257, rebuilt as XLA-fusable jnp ops)."""

from cfdsim_tpu.ops.stencil import (
    gradient,
    divergence,
    laplacian,
    laplacian_coeff,
    curl,
    interior_mask,
)
from cfdsim_tpu.ops.convection import (
    convection_upwind,
    convection_supg,
    convection_tvd,
    supg_tau,
)
from cfdsim_tpu.ops.les import smagorinsky_viscosity
from cfdsim_tpu.ops.limiters import minmod, superbee, minmod3

__all__ = [
    "gradient",
    "divergence",
    "laplacian",
    "laplacian_coeff",
    "curl",
    "interior_mask",
    "convection_upwind",
    "convection_supg",
    "convection_tvd",
    "supg_tau",
    "smagorinsky_viscosity",
    "minmod",
    "superbee",
    "minmod3",
]
