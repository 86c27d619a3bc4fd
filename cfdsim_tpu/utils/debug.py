"""Numerical sanitizers and debug instrumentation.

The JAX answer to SURVEY.md §5 "race detection / sanitizers": the
reference's only guards are in-loop NaN checks and value clipping
(v5.py:600-602, cavity_flow_v1.py:206-215). Under XLA, determinism is free
and data races are impossible by construction; what remains is numerical
health, covered three ways:

- ``enable_nan_checks()``: global jax debug_nans mode (errors at the op
  that first produces a NaN — the sanitizer for development runs);
- ``nan_watch(step_fn, name)``: wraps a step function with an on-device
  finiteness reduction and a host callback that reports the first
  offending step without stopping the run;
- ``checked(step_fn)``: a ``checkify``'d step that returns an error pytree
  alongside the result, for callers that want errors as data.
"""

from __future__ import annotations

import logging
from typing import Callable

import jax
import jax.numpy as jnp

log = logging.getLogger("cfdsim_tpu.debug")


def enable_nan_checks(enable: bool = True) -> None:
    """Make every jitted op fail loudly at the first NaN it produces."""
    jax.config.update("jax_debug_nans", enable)


def _tree_finite(tree) -> jax.Array:
    leaves = [
        jnp.all(jnp.isfinite(x))
        for x in jax.tree_util.tree_leaves(tree)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
    ]
    return jnp.stack(leaves).all() if leaves else jnp.bool_(True)


def nan_watch(step_fn: Callable, name: str = "step") -> Callable:
    """Wrap ``step(state, *args) -> (state, metrics)`` with a non-finite
    watchdog: when any float leaf of the new state goes non-finite, a host
    callback logs the step index (the run continues — pair with the
    runner's health monitor to stop)."""

    def report(step_idx, ok):
        if not ok:
            log.error("%s: non-finite state detected at step %s", name, step_idx)

    def wrapped(state, *args):
        new_state, metrics = step_fn(state, *args)
        ok = _tree_finite(new_state)
        jax.debug.callback(report, new_state.step, ok)
        return new_state, metrics

    return wrapped


def checked(step_fn: Callable) -> Callable:
    """checkify the step: returns ``(error, (state, metrics))``; call
    ``error.throw()`` on the host to surface NaN/div-by-zero checks."""
    from jax.experimental import checkify

    return checkify.checkify(
        step_fn, errors=checkify.float_checks
    )
