"""Simulation driver: chunked on-device stepping with host-side control.

The reference's ``main()`` while-loops (v5.py:615-698,
cavity_flow_v1.py:457-527) rebuilt accelerator-first: the hot loop runs entirely on
device as jitted ``lax.scan`` chunks; between chunks the host reads only
reduced metric scalars to do health checks, CFL back-off, snapshots,
progress and the wall-clock kill switch. Fields cross to the host only at
snapshot boundaries.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cfdsim_tpu.monitor import check_metrics
from cfdsim_tpu.utils.profiling import PerfTracker


@dataclasses.dataclass
class RunnerConfig:
    """Host-loop configuration (the reference's driver knobs:
    save_interval v5.py:72, health cadence v5.py:657, CFL back-off
    cavity_flow_v1.py:481-488, wall-clock kill cavity_flow_v1.py:503)."""

    t_final: float = 1.0
    max_steps: int = 10_000_000
    chunk_steps: int = 50
    snapshot_interval: int = 0  # steps between snapshots; 0 = off
    health_check: bool = True
    max_velocity: float = 1e3
    # The reference uses 2.0 (v5.py:611) for its scheme; with this
    # framework's collocated approximate projection an active vortex
    # street runs at ~2.2 while genuine instabilities sit at 8+, so the
    # default splits the difference.
    div_threshold: float = 5.0
    warmup_div_threshold: float = 20.0
    warmup_steps: int = 1000
    on_unhealthy: str = "stop"  # "stop" (v5) | "backoff" (cavity CFL*0.8)
    cfl_backoff: float = 0.8
    cfl_scale_min: float = 0.1
    wall_clock_limit_s: float = 0.0  # 0 = unlimited
    log_every_chunks: int = 10
    progress: bool = False  # tqdm bar keyed on simulated time (v5.py:651)
    log_memory: bool = False  # psutil RSS in the periodic log (v5.py:665-667)


class Simulation:
    """Drives ``step_fn(state, cfl_scale) -> (state, metrics)`` to t_final."""

    def __init__(
        self,
        step_fn: Callable,
        state,
        cfg: RunnerConfig,
        n_cells: int,
        snapshot_fn: Optional[Callable] = None,
        logger: Optional[logging.Logger] = None,
        health_fn: Optional[Callable] = None,
    ):
        # health_fn(metrics_host, step) -> HealthReport overrides the
        # default incompressible check (use monitor.check_compressible for
        # the FV module)
        self.health_fn = health_fn
        self.cfg = cfg
        self.state = state
        self.snapshot_fn = snapshot_fn
        self.log = logger or logging.getLogger("cfdsim_tpu")
        self.perf = PerfTracker(n_cells=n_cells)
        self.cfl_scale = 1.0
        self.metrics_history: list = []
        self.stopped_reason = ""

        def chunk(state, cfl_scale):
            def body(s, _):
                return step_fn(s, cfl_scale)

            return jax.lax.scan(body, state, None, length=cfg.chunk_steps)

        self._chunk = jax.jit(chunk)

    def run(self):
        cfg = self.cfg
        t_start = time.perf_counter()
        step = int(self.state.step)
        next_snapshot = step
        if self.snapshot_fn and cfg.snapshot_interval > 0:
            self.snapshot_fn(self.state, step, float(self.state.t))
            next_snapshot = step + cfg.snapshot_interval

        pbar = None
        if cfg.progress:
            try:
                from tqdm import tqdm

                pbar = tqdm(total=cfg.t_final, desc="Simulation", unit="time",
                            initial=float(self.state.t))
            except ImportError:
                pass

        chunk_idx = 0
        while True:
            t_now = float(self.state.t)
            if t_now >= cfg.t_final or step >= cfg.max_steps:
                break
            if cfg.wall_clock_limit_s > 0 and (
                time.perf_counter() - t_start > cfg.wall_clock_limit_s
            ):
                self.stopped_reason = "wall-clock limit"
                self.log.warning("Wall-clock limit reached; stopping.")
                break

            self.state, metrics = self._chunk(
                self.state, jnp.float32(self.cfl_scale)
            )
            step += cfg.chunk_steps
            self.perf.add_steps(cfg.chunk_steps)
            chunk_idx += 1
            if pbar is not None:
                pbar.update(min(float(self.state.t), cfg.t_final) - pbar.n)

            # host-side control: health, back-off, snapshots, logging
            m_host = jax.device_get(metrics)
            hist = {
                "step": step,
                "t": float(self.state.t),
                "dt": float(np.asarray(m_host.dt)[-1]),
                "energy": float(np.asarray(m_host.energy)[-1]),
                "max_vel": float(np.max(np.asarray(m_host.max_vel))),
            }
            if hasattr(m_host, "div_post"):
                hist["div_post"] = float(np.max(np.asarray(m_host.div_post)))
            self.metrics_history.append(hist)
            if cfg.health_check:
                if self.health_fn is not None:
                    report = self.health_fn(m_host, step)
                else:
                    report = check_metrics(
                        m_host,
                        cfg.max_velocity,
                        cfg.div_threshold,
                        cfg.warmup_div_threshold,
                        cfg.warmup_steps,
                        step,
                    )
                if not report.ok:
                    if cfg.on_unhealthy == "backoff":
                        self.cfl_scale *= cfg.cfl_backoff
                        self.log.warning(
                            "Unhealthy (%s): reducing CFL scale to %.3f",
                            report.reason,
                            self.cfl_scale,
                        )
                        if self.cfl_scale < cfg.cfl_scale_min:
                            self.stopped_reason = (
                                f"minimum CFL reached after {report.reason}"
                            )
                            self.log.error("%s; stopping.", self.stopped_reason)
                            break
                    else:
                        self.stopped_reason = f"unhealthy: {report.reason}"
                        self.log.error(
                            "Simulation unstable (%s); stopping.", report.reason
                        )
                        break

            if self.snapshot_fn and cfg.snapshot_interval > 0 and step >= next_snapshot:
                self.snapshot_fn(self.state, step, float(self.state.t))
                next_snapshot += cfg.snapshot_interval

            if cfg.log_every_chunks and chunk_idx % cfg.log_every_chunks == 0:
                h = self.metrics_history[-1]
                self.log.info(
                    "step %d t=%.4f dt=%.2e div=%.3e E=%.4f speed=%.1f steps/s",
                    step,
                    h["t"],
                    h["dt"],
                    h.get("div_post", float("nan")),
                    h["energy"],
                    self.perf.steps_per_sec,
                )
                if cfg.log_memory:
                    try:
                        import psutil

                        rss = psutil.Process().memory_info().rss / 1e6
                        self.log.info("host memory usage: %.1f MB", rss)
                    except ImportError:
                        pass

        if pbar is not None:
            pbar.close()
        report = self.perf.report()
        report["stopped_reason"] = self.stopped_reason
        report["final_time"] = float(self.state.t)
        report["final_step"] = int(self.state.step)
        if "device_peak_bytes" in report:
            self.log.info(
                "device memory: peak %.1f MB / limit %.1f MB, "
                "%d live arrays (%.1f MB)",
                report["device_peak_bytes"] / 1e6,
                report.get("device_bytes_limit", 0) / 1e6,
                report.get("live_arrays", 0),
                report.get("live_array_bytes", 0) / 1e6,
            )
        self.log.info("Performance report: %s", report)
        return self.state, report


def run_on_device(step_fn, state, t_final: float, max_steps: int = 10_000_000,
                  cfl_scale: float = 1.0):
    """Fast path: the *entire* run as one jitted ``lax.while_loop`` — zero
    host round-trips until completion (the SURVEY.md §7 idiom: "N steps is
    one fori_loop; host sees data only at snapshot boundaries"). No
    in-flight health intervention or snapshots; check the returned metrics
    afterwards. Returns (state, last_metrics)."""

    @jax.jit
    def run(state, cfl):
        def cond(carry):
            s, _ = carry
            return jnp.logical_and(s.t < t_final, s.step < max_steps)

        def body(carry):
            s, _ = carry
            return step_fn(s, cfl)

        _, metrics0 = step_fn(state, cfl)  # shape template (traced once)
        return jax.lax.while_loop(cond, body, (state, metrics0))

    return run(state, jnp.float32(cfl_scale))
