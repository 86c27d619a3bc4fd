"""Unstructured finite-element tier (the reference's Julia/Gridap family,
julia/flow_over_cylinder_fischer/) re-designed for XLA.

The reference shells out to the gmsh binary for meshing (v2.jl:131) and
uses Gridap's generic weak-form machinery per element; here meshing is a
host-side graded-Delaunay generator (``fem/mesh.py``) run once at setup,
and everything per-step is a batched, static-shape einsum pipeline over
all elements at once (``fem/assembly.py``): gather element DOFs →
quadrature-point einsum contractions (batched small matmuls)
→ ``segment_sum`` scatter — fully jittable, matrix-free operators fed to
GMRES. Both reference FE spaces exist: equal-order P1-P1 with
pressure-gradient stabilization (v2.jl:137-173) and Taylor-Hood P2-P1
(v1.jl:103-127).
"""

from cfdsim_tpu.fem.mesh import TriMesh, cylinder_mesh, rectangle_mesh
from cfdsim_tpu.fem.spaces import FESpaces, build_spaces, dirichlet_values
from cfdsim_tpu.fem.assembly import ElementOps, build_element_ops
from cfdsim_tpu.fem.sample import SampleTable, build_sampler, sample_fields

__all__ = [
    "TriMesh",
    "cylinder_mesh",
    "rectangle_mesh",
    "FESpaces",
    "build_spaces",
    "dirichlet_values",
    "ElementOps",
    "build_element_ops",
    "SampleTable",
    "build_sampler",
    "sample_fields",
]
