"""Profiling & observability hooks.

The reference's entire observability story is Spark: RDD names in the web UI
(DataSet.scala:37,44) and log4j INFO lines for metrics (Model.scala:16;
SURVEY §5). The equivalents here:

  * :func:`trace` — context manager around ``jax.profiler`` emitting an
    XPlane trace viewable in TensorBoard/XProf (device + host timelines,
    per-op HLO breakdown).
  * :func:`annotate` — named scopes that show up both in traces and in HLO,
    for marking gather/interaction/update phases.
  * :class:`StepTimer` — wall-clock step stats that wait for the step's
    outputs with ``block_until_ready``.
  * :func:`enable_nan_checks` — dev-mode NaN trapping (the SPMD/jit-purity
    answer to race detectors; SURVEY §5 "race detection").
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, List, Optional

import jax
import numpy as np

log = logging.getLogger("sparkfm_tpu")


@contextlib.contextmanager
def trace(log_dir: str, host_tracer_level: int = 2):
    """Capture a profiler trace into ``log_dir`` (TensorBoard-compatible).

    Usage::

        with profiling.trace("/tmp/sparkfm-trace"):
            for _ in range(10):
                state, aux = step(state, batch)
            jax.block_until_ready(aux["loss"])
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", log_dir)


def annotate(name: str):
    """Named scope for traces/HLO: ``with annotate("gather"): ...``."""
    return jax.named_scope(name)


def enable_nan_checks(on: bool = True) -> None:
    """Trap NaNs at op granularity (slow; dev only)."""
    jax.config.update("jax_debug_nans", on)


class StepTimer:
    """Per-step wall timing with percentile stats.

    sync="block" waits for the step's outputs with block_until_ready;
    sync="none" measures dispatch only.
    """

    def __init__(self, sync: str = "block"):
        if sync not in ("block", "none"):
            raise ValueError(f"sync must be 'block' or 'none', got {sync!r}")
        self.sync = sync
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if self.sync == "block" and result is not None:
            jax.block_until_ready(result)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {"mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "steps": len(a)}


def log_metrics(step: int, metrics: Dict[str, float],
                logger: Optional[logging.Logger] = None) -> None:
    """Structured metric line: ``step=12 loss=0.41 auc=0.78`` (the
    reference logInfo's metrics as prose: Model.scala:16)."""
    (logger or log).info(
        "step=%d %s", step,
        " ".join(f"{k}={v:.6g}" for k, v in sorted(metrics.items())))
