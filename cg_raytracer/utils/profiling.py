"""Profiling / tracing / metrics.

Reference capability: a single chrono wall-clock around ``renderRayTracing`` printed
to stdout (``src/main.cpp:792-796``).  Here (SURVEY §5 tracing row):
- stage timers with ``block_until_ready`` fencing (build / upload / render / grad),
- ``jax.profiler`` trace capture for xprof,
- derived throughput metrics (rays/s, rays/s/device, scaling efficiency).
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional

import jax


class StageTimer:
    """Accumulates named stage wall-times; device work is fenced per stage."""

    def __init__(self):
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                jax.block_until_ready(fence)
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{k}: {v * 1e3:.1f} ms ({v / total:.0%})"
                 for k, v in sorted(self.stages.items(), key=lambda kv: -kv[1])]
        return " | ".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Wrap a region in a jax.profiler trace (no-op when log_dir is None)."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def throughput_metrics(num_rays: int, seconds: float,
                       num_devices: Optional[int] = None) -> Dict[str, float]:
    m = {"rays": float(num_rays), "seconds": seconds,
         "rays_per_s": num_rays / seconds}
    if num_devices:
        m["rays_per_s_per_device"] = m["rays_per_s"] / num_devices
    return m


def scaling_efficiency(rays_per_s_n: float, rays_per_s_1: float, n: int) -> float:
    """Linear-scaling efficiency of an n-device run vs the 1-device run."""
    return rays_per_s_n / (rays_per_s_1 * n)


class JsonlLogger:
    """Structured per-step logging (stdout + optional JSONL file) — SURVEY §5
    metrics row: loss, grad norms, rays/s per step."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path else None

    def log(self, **fields):
        rec = json.dumps(fields)
        if self.echo:
            print(rec)
        if self._fh:
            self._fh.write(rec + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
