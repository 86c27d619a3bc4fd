"""cfdsim_tpu — a structured-grid and unstructured CFD framework in JAX.

Built from scratch in JAX/XLA with the capabilities of the reference
repo ``Santhosh-Sathyamurthy/cfd-simulations`` (see SURVEY.md):

- incompressible Navier–Stokes via Chorin projection (SUPG stabilization,
  Smagorinsky LES, immersed-boundary obstacles)            [models.incompressible]
- compressible Euler finite volume (Rusanov / HLLC / Roe fluxes,
  minmod / superbee limiting, ghost cells)                 [models.compressible]
- periodic spectral "stable fluids" solver (Kolmogorov)    [models.spectral]
- pressure-Poisson solvers: Jacobi, red-black SOR,
  geometric multigrid, FFT/DCT direct                      [solvers.poisson]
- adaptive CFL time stepping, health monitoring, CFL back-off [runner]
- HDF5 snapshot I/O with resume                            [io_]
- frames → MP4/GIF visualization pipeline                  [viz]
- multi-device grid sharding with halo exchange           [parallel]

Everything in the hot path is a pure jitted function over pytree state;
N steps run as one ``lax.scan`` chunk, the host only sees reduced metrics.
"""

__version__ = "0.1.0"

from cfdsim_tpu.grid import Grid
from cfdsim_tpu import ops
from cfdsim_tpu import solvers

__all__ = ["Grid", "ops", "solvers", "__version__"]
