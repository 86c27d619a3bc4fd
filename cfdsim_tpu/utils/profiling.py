"""Performance tracking: steps/sec, cell-updates/sec, ETA, final report.

Replaces the reference's tqdm + ad-hoc timing prints (v5.py:651-694,
cavity_flow_v1.py:493-527) with a small tracker whose first-class metric is
cell-updates/sec (the BASELINE.json north-star unit). Optional
``jax.profiler`` trace capture for deep dives, and the reduction of
such a trace to per-kernel device time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
import time


def device_memory_stats(device=None) -> dict:
    """Device-memory figures for the perf report / runner log.

    The reference self-reports process memory in its banner and
    per-snapshot logs (v5.py:84-92, :665-667, psutil); on an accelerator
    the figure that matters is the *device* allocator's peak —
    ``device.memory_stats()`` where the backend exposes it (the GPU
    does).  Always includes the live-array census from
    ``jax.live_arrays()`` (works on every backend).

    Returns a dict of ints; allocator keys are absent on backends that
    do not expose ``memory_stats`` (e.g. XLA CPU).
    """
    import jax

    dev = device if device is not None else jax.local_devices()[0]
    out: dict = {}
    try:
        ms = dev.memory_stats() or {}
    except Exception:
        ms = {}
    for out_key, in_key in (
        ("device_bytes_in_use", "bytes_in_use"),
        ("device_peak_bytes", "peak_bytes_in_use"),
        ("device_bytes_limit", "bytes_limit"),
        ("device_largest_alloc", "largest_alloc_size"),
    ):
        if in_key in ms:
            out[out_key] = int(ms[in_key])
    live = [a for a in jax.live_arrays() if dev in getattr(a, "devices", lambda: set())()]
    out["live_arrays"] = len(live)
    out["live_array_bytes"] = int(sum(a.nbytes for a in live))
    return out


@dataclasses.dataclass
class PerfTracker:
    n_cells: int
    _t0: float = dataclasses.field(default_factory=time.perf_counter)
    steps: int = 0

    def add_steps(self, n: int):
        self.steps += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def steps_per_sec(self) -> float:
        e = self.elapsed
        return self.steps / e if e > 0 else 0.0

    @property
    def cell_updates_per_sec(self) -> float:
        return self.steps_per_sec * self.n_cells

    def eta(self, frac_done: float) -> float:
        if frac_done <= 0:
            return float("inf")
        return self.elapsed * (1.0 - frac_done) / frac_done

    def report(self, include_memory: bool = True) -> dict:
        """Final performance report (reference v5.py:688-694) plus the
        device-memory census (v5.py:84-92's psutil banner, done for the
        accelerator allocator instead — see :func:`device_memory_stats`)."""
        out = {
            "total_steps": self.steps,
            "wall_time_s": round(self.elapsed, 3),
            "steps_per_sec": round(self.steps_per_sec, 2),
            "cell_updates_per_sec": self.cell_updates_per_sec,
        }
        if include_memory:
            try:
                out.update(device_memory_stats())
            except Exception:  # no jax backend initialised — perf only
                pass
        return out


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Capture a jax.profiler trace around a block (no-op if dir is None)."""
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


_FUSION = re.compile(r"^\s*(?:ROOT )?%([\w.\-]+) = .* fusion\(.*calls=%([\w.\-]+)")
_COMPUTATION = re.compile(r"^(?:ENTRY )?%([\w.\-]+) (\(.*\) -> .*) \{$")
_SHAPE = re.compile(r"\b(pred|s8|u8|s16|u16|bf16|f16|s32|u32|f32|s64|u64|f64|c64|c128)\[([\d,]*)\]")
_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
          "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
          "c64": 8, "c128": 16}


def _shape_bytes(text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE.findall(text):
        n = 1
        for d in filter(None, dims.split(",")):
            n *= int(d)
        total += n * _BYTES[dtype]
    return total


def kernel_key(name: str) -> str:
    """A fusion's HLO name and its GPU kernel name normalised alike
    (XLA turns ``loop_add_fusion.3`` into kernel ``loop_add_fusion_3``)."""
    return re.sub(r"[.\-]", "_", name)


def scope_fusions(hlo_text: str, scope: str) -> dict:
    """Fusions of a compiled module (``compiled.as_text()``) that hold an
    operation under ``jax.named_scope(scope)`` → {kernel_key: bytes}.
    The bytes are the fused computation's parameters plus its result,
    from their shapes: what the kernel moves if it reads each operand
    whole once."""
    in_scope, signature, comp = set(), {}, None
    tag = f"/{scope}/"
    for line in hlo_text.splitlines():
        m = _COMPUTATION.match(line)
        if m:
            comp = m.group(1)
            signature[comp] = _shape_bytes(m.group(2))
        elif comp and tag in line:
            in_scope.add(comp)
    out = {}
    for line in hlo_text.splitlines():
        m = _FUSION.match(line)
        if m and m.group(2) in in_scope:
            out[kernel_key(m.group(1))] = signature.get(m.group(2), 0)
    return out


def device_kernel_times(trace_dir: str,
                        plane_prefix: str = "/device:GPU") -> dict:
    """Total device nanoseconds per kernel in the newest profiler trace
    under ``trace_dir`` → {kernel_key: ns}. A kernel is named by its
    ``hlo_op`` stat where the trace has one, else by the event name."""
    from pathlib import Path

    from jax.profiler import ProfileData

    paths = sorted(Path(trace_dir).rglob("*.xplane.pb"),
                   key=lambda q: q.stat().st_mtime)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = ProfileData.from_file(str(paths[-1]))
    out: dict = collections.defaultdict(float)
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                name = next((v for k, v in ev.stats if k == "hlo_op"),
                            ev.name)
                out[kernel_key(str(name))] += ev.duration_ns
    return dict(out)
