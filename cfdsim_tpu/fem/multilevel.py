"""Two-level aggregation preconditioner for the FEM pressure solves.

The projection scheme's pressure-increment Poisson (models/fem.py
``make_projection_step``) is the classic multilevel candidate: a plain
Jacobi-CG needs O(1/h) iterations (measured: ~300 at 10.7k triangles,
the dominant step cost once the momentum solve is warm), while a
two-level aggregation preconditioner takes the same solve to ~10-20
iterations (measured 34x/17x fewer for the V-cycle/additive variants).

Design (accelerator-first): the setup is a one-time host-side numpy pass —
greedy graph aggregation (Vanek phase 1+2) of the pressure nodes,
Galerkin coarse operator K_c = P^T K P accumulated in scipy sparse,
re-aggregated until the coarse size is bounded, then densified and
inverted once in fp64. At apply time everything is jit-friendly and
static-shaped: restriction is one ``segment_sum``, the coarse solve is
one dense (n_c, n_c) matmul (matmul work), prolongation is one gather —
no sparse kernels, no data-dependent control flow. The gather runs in
the replicated Krylov region (outside any shard_map body), so the
multi-chip path (parallel/fem_explicit.py) reuses it unchanged.

The reference has no counterpart (its Gridap family LU-factorizes the
coupled matrix per step, julia/flow_over_cylinder_fischer/v2.jl:216-222);
this is the "unstructured multigrid" rung planned in BENCHNOTES
("Solver-scaling boundary").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cfdsim_tpu.fem.assembly import ElementOps


class CoarseLevel(NamedTuple):
    """Aggregation two-level hierarchy (device-resident, closed over by
    the jitted pc).

    agg : (n_p,) int32 — aggregate id per pressure node; excluded
        (pressure-Dirichlet) nodes carry ``n_c`` and route to a zero
        dummy row, so restriction drops them and prolongation returns 0.
    Kc_inv : (n_c, n_c) dense inverse of the Galerkin coarse operator.
    """

    agg: jax.Array
    Kc_inv: jax.Array


def _aggregate_graph(indptr, indices, excluded):
    """One round of greedy aggregation (Vanek phases 1+2) on a CSR
    graph. Returns (agg, n_agg) with agg = -1 on excluded nodes."""
    n = len(indptr) - 1
    agg = -np.ones(n, dtype=np.int64)
    agg[excluded] = -2
    n_agg = 0
    # phase 1: seed an aggregate only where the whole neighborhood is
    # still free (keeps aggregates round)
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        free = agg[nbrs] == -1
        if len(nbrs) > 0 and not free.all():
            continue
        agg[i] = n_agg
        agg[nbrs[free]] = n_agg
        n_agg += 1
    # phase 2: attach leftovers to any aggregated neighbor
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        cand = agg[nbrs]
        cand = cand[cand >= 0]
        if len(cand):
            agg[i] = cand[0]
        else:
            agg[i] = n_agg
            n_agg += 1
    agg[agg == -2] = -1
    return agg, n_agg


def pressure_laplacian_elements(ops: ElementOps) -> np.ndarray:
    """Per-element pressure-Laplacian matrices ∫∇N_l·∇N_m (nt, 3, 3)
    in fp64 on host — the projection Poisson's element contribution."""
    Gp = np.asarray(ops.Gp, np.float64)
    wq = np.asarray(ops.wq, np.float64)
    return np.einsum("eq,eqlc,eqmc->elm", wq, Gp, Gp)


def schur_proxy_elements(ops: ElementOps, nu: float,
                         kp_scale: np.ndarray) -> np.ndarray:
    """Per-element Cahouet-Chabard Schur-proxy matrices
    (1/ν)∫N_lN_m + kp_e·∫∇N_l·∇N_m (nt, 3, 3) — the monolithic block
    preconditioner's pressure operator (models/fem.py operator_diag)."""
    Np_ = np.asarray(ops.Np, np.float64)
    wq = np.asarray(ops.wq, np.float64)
    Me = np.einsum("eq,ql,qm->elm", wq, Np_, Np_)
    Ke = pressure_laplacian_elements(ops)
    kp = np.asarray(kp_scale, np.float64)
    return Me / float(nu) + kp[:, None, None] * Ke


def build_coarse(
    elem_p: np.ndarray,
    Ke: np.ndarray,
    n_p: int,
    excluded_nodes=(),
    max_coarse: int = 4096,
    dtype=jnp.float32,
) -> CoarseLevel:
    """Build the two-level hierarchy from element matrices.

    ``Ke`` (nt, nloc, nloc) fp64 element contributions of the fine SPD
    operator; ``excluded_nodes`` are Dirichlet rows (the operator is the
    identity there — they stay out of the coarse space). Aggregation
    repeats on the coarse graph until ≤ ``max_coarse`` unknowns remain,
    then the coarse operator is inverted densely in fp64.
    """
    import scipy.sparse as sp

    elem_p = np.asarray(elem_p)
    nloc = elem_p.shape[1]
    rows = np.repeat(elem_p, nloc, axis=1).ravel()
    cols = np.tile(elem_p, (1, nloc)).ravel()
    K = sp.coo_matrix(
        (np.asarray(Ke, np.float64).ravel(), (rows, cols)),
        shape=(n_p, n_p),
    ).tocsr()

    excluded = np.zeros(n_p, dtype=bool)
    if len(excluded_nodes):
        excluded[np.asarray(excluded_nodes)] = True

    # level loop: aggregate, Galerkin-project, repeat while too large
    agg_total = None
    Kl = K
    excl_l = excluded
    while True:
        graph = Kl.tocsr()
        agg, n_agg = _aggregate_graph(graph.indptr, graph.indices, excl_l)
        if agg_total is None:
            agg_total = agg
        else:
            agg_total = np.where(agg_total >= 0, agg[agg_total], -1)
        keep = agg >= 0
        P = sp.coo_matrix(
            (np.ones(keep.sum()), (np.nonzero(keep)[0], agg[keep])),
            shape=(Kl.shape[0], n_agg),
        ).tocsr()
        Kl = (P.T @ Kl @ P).tocsr()
        excl_l = np.zeros(n_agg, dtype=bool)
        if n_agg <= max_coarse:
            break

    Kc = Kl.toarray()
    d = np.diag(Kc).copy()
    bad = d <= 0
    if bad.any():  # empty/degenerate aggregate — keep it inert
        Kc[np.diag_indices_from(Kc)] = np.where(bad, 1.0, d)
    Kc_inv = np.linalg.inv(Kc)
    n_c = Kc.shape[0]
    # excluded nodes route to the zero dummy row n_c
    agg_dev = np.where(agg_total >= 0, agg_total, n_c).astype(np.int32)
    return CoarseLevel(
        agg=jnp.asarray(agg_dev),
        Kc_inv=jnp.asarray(Kc_inv, dtype=dtype),
    )


def build_pressure_coarse(
    ops: ElementOps, p_out_nodes, max_coarse: int = 4096
) -> CoarseLevel:
    """Two-level hierarchy for the projection pressure Poisson K_p
    (P1-P1) — also the spectrally-equivalent preconditioner for the
    Taylor-Hood exact lumped Schur operator B P M_L⁻¹ Bᵀ."""
    return build_coarse(
        np.asarray(ops.elem_p),
        pressure_laplacian_elements(ops),
        ops.n_p,
        excluded_nodes=np.asarray(p_out_nodes),
        max_coarse=max_coarse,
        dtype=ops.wq.dtype,
    )


def coarse_correct(level: CoarseLevel, r):
    """z_c-lift of a fine residual: P K_c⁻¹ Pᵀ r (one segment_sum, one
    dense matmul, one gather; excluded rows in/out are zero)."""
    n_c = level.Kc_inv.shape[0]
    rc = jax.ops.segment_sum(r, level.agg, num_segments=n_c + 1)[:n_c]
    zc = level.Kc_inv @ rc
    return jnp.concatenate([zc, jnp.zeros((1,), zc.dtype)])[level.agg]


def make_pressure_pc(level: CoarseLevel, inv_diag, Ap=None,
                     kind: str = "2level", omega: float = 0.7):
    """Preconditioner callable for the pressure CG.

    kind = "2level": additive D⁻¹ + P K_c⁻¹ Pᵀ (SPD, one extra
    segment_sum+matmul+gather per iteration, no operator applications —
    the default; measured 308 → 18 Jacobi→2level iterations at 10.7k
    triangles). "2level_v": symmetric V(1,1) with ω-damped Jacobi
    smoothing (fewest iterations — 9 in the same measurement — but two
    ``Ap`` applications per pc apply; wins when the matvec is cheap
    relative to the Krylov epilogue). "jacobi": plain diagonal.
    """
    if kind == "jacobi" or level is None:
        return lambda r: inv_diag * r
    if kind == "2level":
        return lambda r: inv_diag * r + coarse_correct(level, r)
    if kind == "2level_v":
        if Ap is None:
            raise ValueError("2level_v needs the operator Ap")

        def M(r):
            z = omega * inv_diag * r
            z = z + coarse_correct(level, r - Ap(z))
            return z + omega * inv_diag * (r - Ap(z))

        return M
    raise ValueError(f"unknown pressure pc kind: {kind!r}")
