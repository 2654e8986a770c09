"""Profiling helpers: jax.profiler traces + phase timers.

The reference's only observability is wall-clock logs (generator.py:130,159;
train.py:156-165). Here: a context manager that captures a TensorBoard-viewable
device trace when supported, a lightweight phase timer whose results land in
the metric logger, and the reduction of a trace to device time per named
scope (``jax.named_scope`` names carried in the compiled ops' metadata).
"""

from __future__ import annotations

import contextlib
import glob
import logging
import os
import re
import time
from collections import defaultdict
from typing import Dict, Iterable, Optional, Sequence

log = logging.getLogger(__name__)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Capture a jax.profiler trace into ``log_dir`` (no-op if None or the
    profiler cannot start)."""
    if not log_dir:
        yield
        return
    import jax

    try:
        jax.profiler.start_trace(log_dir)
    except Exception as e:  # e.g. a trace already running in this process
        log.warning("jax profiler unavailable: %s", e)
        yield
        return
    try:
        yield
    finally:
        try:
            jax.profiler.stop_trace()
        except Exception:
            pass


class PhaseTimer:
    """Accumulates wall-clock per named phase; ``summary()`` feeds wandb/logs."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        out = {}
        for k, v in self.totals.items():
            out[f"time/{k}_total_s"] = v
            out[f"time/{k}_mean_ms"] = 1000.0 * v / max(self.counts[k], 1)
        return out

    def reset(self):
        self.totals.clear()
        self.counts.clear()


_HLO_COMPUTATION = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_HLO_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def _kernel_key(name: str) -> str:
    # XLA names a fusion's kernel after the instruction, '.' turned to '_'
    return name.replace(".", "_")


def hlo_op_scopes(hlo_text: str, scopes: Sequence[str]) -> Dict[str, str]:
    """{HLO instruction name: first of ``scopes`` in its metadata op_name}
    over a compiled module's text (``compiled.as_text()``). A fusion without
    metadata takes the scope most common inside the computation it calls.
    Keys are normalized as kernel names ('.' -> '_'); instructions outside
    every scope are left out."""

    def scope_of(op_name: str) -> Optional[str]:
        path = "/" + op_name + "/"
        return next((sc for sc in scopes if f"/{sc}/" in path), None)

    inner: Dict[str, list] = defaultdict(list)  # computation -> inner scopes
    calls: Dict[str, str] = {}
    out: Dict[str, str] = {}
    computation = None
    for line in hlo_text.splitlines():
        m = _HLO_INSTR.match(line)
        if not m:
            header = _HLO_COMPUTATION.match(line)
            if header:
                computation = header.group(1)
            continue
        op = _OP_NAME.search(line)
        scope = scope_of(op.group(1)) if op else None
        if scope is not None:
            out[_kernel_key(m.group(1))] = scope
            inner[computation].append(scope)
        called = _CALLS.search(line)
        if called:
            calls[_kernel_key(m.group(1))] = called.group(1)
    for name, computation in calls.items():
        if name not in out and inner.get(computation):
            found = inner[computation]
            out[name] = max(set(found), key=found.count)
    return out


def _busy_seconds(intervals: Iterable) -> float:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy * 1e-9


def scope_device_times(trace_dir: str, op_scopes: Dict[str, str],
                       plane_prefix: Optional[str] = None) -> Dict[str, float]:
    """Device seconds per scope in the newest trace under ``trace_dir``.

    Counts the events that carry an ``hlo_op`` stat on the device planes
    (``/device:GPU``; the host CPU plane when there is no GPU plane) — on
    the lines named ``Stream ...`` where a plane has them, so summary lines
    do not count twice — maps each through ``op_scopes``
    (:func:`hlo_op_scopes`) by its ``hlo_op``, else by its kernel name (a
    kernel replayed inside a CUDA graph carries ``hlo_op=command_buffer``),
    and sums durations; ops in no scope go to ``other`` — or to
    ``other_in_cuda_graph`` for graph-replayed library kernels (cuBLAS,
    cuDNN), whose op the trace does not name. ``__device_total__`` is the
    busy time: the union of all those events' intervals.
    """
    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                          "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    planes = list(data.planes)
    if plane_prefix is None:
        gpu = [p for p in planes if p.name.startswith("/device:GPU")]
        plane_prefix = "/device:GPU" if gpu else "/host:CPU"
    times: Dict[str, float] = defaultdict(float)
    intervals = []
    for plane in planes:
        if not plane.name.startswith(plane_prefix):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for event in line.events:
                stats = dict(event.stats)
                op = stats.get("hlo_op")
                if op is None:
                    continue
                scope = (op_scopes.get(_kernel_key(str(op)))
                         or op_scopes.get(_kernel_key(event.name))
                         or ("other_in_cuda_graph" if op == "command_buffer"
                             else "other"))
                times[scope] += event.duration_ns * 1e-9
                intervals.append((event.start_ns, event.start_ns + event.duration_ns))
    times["__device_total__"] = _busy_seconds(intervals)
    return dict(times)
