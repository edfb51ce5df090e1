"""Structured metrics & logging (SURVEY.md §5 observability plan).

The reference's observability is an imgui FPS overlay and cout markers
(`/root/reference/Caitlyn/main.cpp:272-274`, `Scene.h:490-501`).  Here:
build stats (node counts, SAH cost, duplication ratio), render stats
(rays/s, per-pass wall time, bounce occupancy from the integrator's
instrumented counters), emitted as structured records through the stdlib
logger or collected in-process."""

from __future__ import annotations

import json
import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger("caitlyn")


def bvh_build_stats(bvh) -> Dict[str, Any]:
    """Build-quality record for a FlatBVH (or SBVH gather-list tree)."""
    import numpy as np

    from caitlyn.accel.bvh import sah_cost

    leaf = bvh.is_leaf()
    counts = bvh.node_meta[leaf, 1]
    n_refs = int(counts.sum())
    return {
        "nodes": int(bvh.num_nodes),
        "leaves": int(leaf.sum()),
        "max_leaf_size": int(counts.max()) if len(counts) else 0,
        "mean_leaf_size": float(counts.mean()) if len(counts) else 0.0,
        "sah_cost": round(sah_cost(bvh), 3),
        "refs": n_refs,
        "duplication_ratio": round(n_refs / max(len(bvh.tri_order), 1), 4)
        if len(bvh.tri_order) != n_refs
        else 1.0,
    }


@dataclass
class StepTimer:
    """Wall-time per named pass, with a rays/s derived summary.

    Usage:
        timer = StepTimer()
        with timer.span("trace"):
            ...block_until_ready()
        timer.count("rays", n)
        logger.info("%s", timer.summary())
    """

    spans: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        yield
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def count(self, name: str, n: int):
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {k: round(v * 1e3, 3) for k, v in self.spans.items()}
        out.update(self.counts)
        total = sum(self.spans.values())
        if "rays" in self.counts and total > 0:
            out["rays_per_sec"] = round(self.counts["rays"] / total, 1)
        return out


def log_record(kind: str, record: Dict[str, Any]) -> None:
    """One structured JSON log line."""
    logger.info("%s %s", kind, json.dumps(record, sort_keys=True))


@contextmanager
def profile_trace(log_dir: Optional[str]):
    """jax.profiler trace wrapper — view with TensorBoard/Perfetto.
    No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
