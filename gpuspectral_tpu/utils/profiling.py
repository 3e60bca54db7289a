"""Profiling / tracing (SURVEY.md §5.1 — the Tracy equivalent).

The reference instruments with Tracy: frame marks around Renderer::run and
CPU/GPU zones named after framegraph passes (Renderer.cpp:94,115,
FrameGraph.cpp:258, VulkanDriver.cpp:263).  Here the same roles map to:

  * `jax.profiler.trace(log_dir)` captures a full XLA/GPU trace viewable in
    TensorBoard / Perfetto (device kernels replace Tracy GPU zones),
  * `jax.named_scope` annotations in the integrator/engine use the
    reference's pass names ("Frame"), so traces line up with Tracy captures,
  * `stage_timer` gives coarse host-side wall-clock stage timing with JSONL
    output for environments without a trace viewer.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax

from .metrics import MetricsLogger


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a jax/XLA profiler trace if log_dir is given; no-op otherwise."""
    if not log_dir:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield


@contextlib.contextmanager
def stage(name: str, metrics: Optional[MetricsLogger] = None):
    """Named host-side stage: a jax.named_scope plus wall-clock logging."""
    t0 = time.time()
    with jax.named_scope(name):
        yield
    if metrics is not None:
        metrics.log(event="stage", stage=name, seconds=time.time() - t0)


class stage_timer:
    """Accumulating per-stage wall-clock timer (host side)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.time() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        return {
            name: dict(seconds=self.totals[name], calls=self.counts[name])
            for name in sorted(self.totals)
        }
