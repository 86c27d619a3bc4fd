"""Multi-chip parallelism: 2D spatial domain decomposition over a device
mesh (SURVEY.md §2.6 — the reference has no distributed compute at all;
this module is the multi-device scaling story).

Complementary paths:

- ``sharded``: GSPMD auto-partitioning — jit the *same* single-device step
  with ``NamedSharding(P("y", "x"))`` annotations and let XLA insert the
  halo collectives (the scaling-book recipe).
- ``halo`` + ``explicit``: explicit ``shard_map`` + ``lax.ppermute`` halo
  exchange with hand-placed collectives — the full collocated NS step,
  option-for-option equal to the single-device one (ghost-cell swaps =
  the reference's NG=2 ghost layout, cavity_flow_v1.py:258-262, made
  inter-chip).
- ``transforms``: pencil-decomposed distributed direct solvers via
  ``lax.all_to_all`` — exact DCT Poisson (2D/3D), DST Helmholtz, and
  stretched-grid fast-diagonalization (2D/3D).
- ``mac_explicit`` / ``mac_stretched_explicit`` / ``mac3d_explicit`` /
  ``mac_stretched3d_explicit`` / ``boussinesq_explicit``: the staggered
  tiers multi-chip on the trimmed face representation (XLA's SPMD
  partitioner miscompiles the uneven MAC shapes — see CLAUDE.md), each
  exact-equality-tested against its single-device step.
"""

from cfdsim_tpu.parallel.mesh import make_grid_mesh, field_sharding
from cfdsim_tpu.parallel.halo import halo_exchange
from cfdsim_tpu.parallel.sharded import shard_state, make_sharded_step
from cfdsim_tpu.parallel.mac_explicit import (
    make_cavity_mac_explicit_step,
    make_cylinder_mac_explicit_step,
    make_mac_explicit_step,
    trim_face_masks,
)
from cfdsim_tpu.parallel.mac_sharded import (
    shard_trimmed_state,
    trim_state,
    untrim_state,
)
from cfdsim_tpu.parallel.mac_stretched_explicit import (
    make_cavity_stretched_explicit_step,
    make_cylinder_stretched_explicit_step,
    make_stretched_mac_explicit_step,
)
from cfdsim_tpu.parallel.mac3d_explicit import (
    make_cavity3d_mac_explicit_step,
    shard_trimmed_state3d,
    trim_state3d,
    untrim_state3d,
)
from cfdsim_tpu.parallel.boussinesq_explicit import (
    make_heated_cavity_explicit_step,
)
from cfdsim_tpu.parallel.boussinesq3d_explicit import (
    make_heated_cube_explicit_step,
)
from cfdsim_tpu.parallel.mac_stretched3d_explicit import (
    make_cavity3d_stretched_explicit_step,
)
from cfdsim_tpu.parallel.transforms import (
    dct_poisson3d_local,
    dct_poisson_local,
    dst_helmholtz_local,
    make_fdm_poisson3d_local,
    make_fdm_poisson_local,
)

__all__ = [
    "make_grid_mesh",
    "field_sharding",
    "halo_exchange",
    "shard_state",
    "make_sharded_step",
    "make_mac_explicit_step",
    "make_cavity_mac_explicit_step",
    "make_cylinder_mac_explicit_step",
    "trim_face_masks",
    "trim_state",
    "untrim_state",
    "shard_trimmed_state",
    "dct_poisson_local",
    "dst_helmholtz_local",
    "make_fdm_poisson_local",
    "make_stretched_mac_explicit_step",
    "make_cavity_stretched_explicit_step",
    "make_cylinder_stretched_explicit_step",
    "make_cavity3d_mac_explicit_step",
    "make_cavity3d_stretched_explicit_step",
    "make_fdm_poisson3d_local",
    "make_heated_cavity_explicit_step",
    "make_heated_cube_explicit_step",
    "trim_state3d",
    "untrim_state3d",
    "shard_trimmed_state3d",
    "dct_poisson3d_local",
]
