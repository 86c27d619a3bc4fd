"""First-call autotuned dispatch for the exact Neumann Poisson solve.

The exact clamped-edge solve has several implementations whose speed
depends on the device: FFT-based DCTs (per-axis, single 2D FFT,
half-length split FFTs, half-FFT packing) and the dense matmul
fast-diagonalization.  Hand-picking one does not survive a hardware
change, so ``best_dct_variant`` times all variants on the live device at
first use per (device kind, shape) and caches the winner — in-process
and on disk (~/.cache/cfdsim_tpu/autotune.json, override dir with
CFDSIM_AUTOTUNE_CACHE; force a variant with CFDSIM_DCT_VARIANT).  A
variant that raises is recorded with its error, not skipped silently.

Timing: each candidate is jitted as a ``lax.scan`` chain of K solves,
each run ends in ``jax.block_until_ready``, and the per-solve time is
the slope between two chain lengths, so the per-call dispatch constant
cancels.  All variants solve the same problem exactly (same nullspace
convention), so the dispatch never changes semantics — only speed.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

_MEM: dict[str, dict] = {}  # key -> record (see _store)
_VARIANTS = ("rfft", "rfft2", "rfft_split", "packed", "matmul")
# deeper radix-2 peels (internal FFT length n/4, n/8) only make sense
# where the base FFT is superlinear — past the 2048 cliff
_DEEP_VARIANTS = ("rfft_split4", "rfft_split8")


def _variants_for(shape) -> tuple[str, ...]:
    if min(shape) >= 4096:
        return _VARIANTS + _DEEP_VARIANTS
    return _VARIANTS


def _cache_path() -> Path:
    base = os.environ.get("CFDSIM_AUTOTUNE_CACHE")
    if base:
        return Path(base) / "autotune.json"
    return Path.home() / ".cache" / "cfdsim_tpu" / "autotune.json"


def _load_disk() -> dict:
    try:
        return json.loads(_cache_path().read_text())
    except (OSError, ValueError):
        return {}


def _store(key: str, record: dict) -> None:
    """Keep ``record`` ({"variant", "ms", and where present "errors" and
    "fallback_upper_bound"}) in process and on disk."""
    _MEM[key] = record
    path = _cache_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        data = _load_disk()
        data[key] = record
        path.write_text(json.dumps(data, indent=1, sort_keys=True))
    except OSError:
        pass  # read-only home: in-process cache still applies


@functools.lru_cache(maxsize=None)
def matmul_dct_solver(m: int, n: int, dx: float, dy: float):
    """Uniform-spacing fast-diagonalization solver: the clamped-edge FD
    operator in the DCT eigenbasis as 4 dense matmuls (the uniform
    special case of solvers/fdm.make_fdm_solver; same mean-free
    nullspace convention as the FFT DCT solvers).  The eigenbasis is the
    analytic DCT-II cosine basis — O(n²) to build vs the numeric eig's
    O(n³), which takes minutes at 4096²."""
    from cfdsim_tpu.solvers.fdm import make_fdm_solver, uniform_neumann_eigs

    # the solver is cached, so its tables must be concrete arrays even
    # when the first call comes from inside a jit trace
    with jax.ensure_compile_time_eval():
        return make_fdm_solver(
            np.full(n, dx), np.full(m, dy),
            eigs=(uniform_neumann_eigs(n, dx), uniform_neumann_eigs(m, dy)))


def _candidate(variant: str, shape, dx: float, dy: float):
    from cfdsim_tpu.solvers.poisson import solve_poisson_neumann_dct

    if variant == "matmul":
        solver = matmul_dct_solver(shape[0], shape[1], dx, dy)
        return lambda rhs: solver(rhs)
    return lambda rhs: solve_poisson_neumann_dct(rhs, dx, dy,
                                                 variant=variant)


def _time_marginal(fn, rhs, k_short: int = 2, k_long: int = 10,
                   reps: int = 3) -> tuple[float, bool]:
    """Marginal seconds per solve from the slope between two jitted scan
    chains (the per-call dispatch constant cancels in the difference),
    and whether the value is the constant-inclusive fallback."""

    def chain(k):
        def body(r, _):
            p = fn(r)
            # keep the chain non-constant-foldable and bounded
            return p - jnp.mean(p), None

        return jax.jit(lambda r: jax.lax.scan(body, r, None, length=k)[0])

    f_s = chain(k_short)
    f_l = chain(k_long)
    jax.block_until_ready(f_s(rhs))  # compile + warm
    jax.block_until_ready(f_l(rhs))

    def once(f):
        t0 = time.perf_counter()
        jax.block_until_ready(f(rhs))
        return time.perf_counter() - t0

    # A min-of-mins marginal is corruptible both ways (t_long < t_short
    # inverts it; a lucky t_long against an unlucky t_short makes a
    # too-fast winner), so pair each (t_long, t_short) measurement
    # back-to-back and take the MEDIAN of the positive paired marginals.
    marginals = []
    for _ in range(3 * reps):
        t_l, t_s = once(f_l), once(f_s)
        if t_l > t_s:
            marginals.append((t_l - t_s) / (k_long - k_short))
        if len(marginals) >= reps:
            break
    if marginals:
        return float(np.median(marginals)), False
    # every pairing inverted: fall back to the long-chain average — a
    # conservative upper bound (it still carries the per-call dispatch
    # constant) flagged to the caller so the winner selection and the
    # cached timings record it
    return t_l / k_long, True


def measure_dct_variants(shape, dx: float,
                         dy: float) -> tuple[dict, list, dict]:
    """Time every exact variant on the live device → ({variant: ms},
    [variants whose timing is a constant-inclusive upper bound],
    {variant: error message} for the variants that raised)."""
    rng = np.random.default_rng(0)
    rhs = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    rhs = rhs - jnp.mean(rhs)
    out, fallback, errors = {}, [], {}
    for v in _variants_for(shape):
        try:
            t, is_ub = _time_marginal(_candidate(v, shape, dx, dy), rhs)
        except Exception as e:  # a variant this device cannot run
            errors[v] = f"{type(e).__name__}: {e}"[:500]
            logging.getLogger("cfdsim_tpu").warning(
                "DCT variant %s failed at %s: %s", v, shape, errors[v])
            continue
        out[v] = t * 1e3
        if is_ub:
            fallback.append(v)
    return out, fallback, errors


def _key(shape) -> str:
    # keyed by the device kind: two GPUs of one backend can pick
    # different winners
    kind = jax.devices()[0].device_kind
    return f"{kind}|dct2d|{shape[0]}x{shape[1]}"


def tuning_record(shape) -> dict | None:
    """The cached record for ``shape`` on this device kind ({"variant",
    "ms", and where present "errors" and "fallback_upper_bound"}), or
    None. Never runs device code — safe to call from inside a jit
    trace."""
    key = _key(shape)
    if key in _MEM:
        return _MEM[key]
    disk = _load_disk().get(key)
    if isinstance(disk, dict) and disk.get("variant") in (
            _VARIANTS + _DEEP_VARIANTS):
        _MEM[key] = disk
        return disk
    return None


def cached_dct_variant(shape) -> str | None:
    """Cache-only lookup (env force > in-process > disk); None on miss."""
    forced = os.environ.get("CFDSIM_DCT_VARIANT")
    if forced:
        return forced
    rec = tuning_record(shape)
    return rec["variant"] if rec else None


def best_dct_variant(shape, dx: float, dy: float) -> str:
    """The fastest exact DCT-solve variant for this (device kind, shape):
    cached in process and on disk; measured once on a miss.

    Timing launches its own jitted chains, which cannot run from inside
    an outer jit trace.  Inside a trace this returns the cached winner or
    the rfft default — eager callers (model ``make_step`` factories,
    bench.py) resolve and cache BEFORE tracing via
    ``resolve_poisson_config``."""
    hit = cached_dct_variant(shape)
    if hit:
        return hit
    # trace_state_clean is a private jax path that can move on upgrade
    # (ADVICE r3): if it's gone, assume we might be inside a trace and
    # return the documented in-trace default rather than ImportError.
    try:
        from jax._src import core as _core

        in_trace = not _core.trace_state_clean()
    except Exception:
        return "rfft"
    if in_trace:  # inside jit tracing: no timing
        return "rfft"
    timings, fallback, errors = measure_dct_variants(shape, dx, dy)
    # constant-inclusive fallback timings must not beat clean marginals:
    # prefer the fastest cleanly-measured variant when one exists.
    clean = {k: v for k, v in timings.items() if k not in fallback}
    pool = clean or timings
    winner = min(pool, key=pool.get) if pool else "rfft"
    record = {"variant": winner,
              "ms": {k: round(v, 4) for k, v in timings.items()}}
    if errors:
        record["errors"] = errors
    if fallback:
        record["fallback_upper_bound"] = sorted(fallback)
    _store(_key(shape), record)
    return winner


def resolve_poisson_config(pois, shape, dx: float, dy: float):
    """Eagerly pin ``dct_variant="auto"`` to the measured winner at step
    BUILD time (outside jit) so the traced solve never needs to tune.
    Returns ``pois`` unchanged when no resolution is needed."""
    import dataclasses

    if (pois is not None and getattr(pois, "method", None) == "dct"
            and getattr(pois, "dct_variant", None) == "auto"):
        return dataclasses.replace(
            pois, dct_variant=best_dct_variant(shape, dx, dy))
    return pois
