"""Serving helpers: micro-batch coalescing for the score path.

A synchronous score call pays a fixed dispatch cost regardless of batch
size, so small requests are dominated by it and throughput grows with
the coalesced batch size (benchmarks/serving_latency.py measures the
curve). The serving rule that falls out: never score singles; queue
requests and flush them as one padded batch.

:class:`MicroBatcher` is that queue. It is the synchronous core a real
server loops around (collect until ``max_batch`` or a deadline, then
``flush``): requests accumulate on the host, one ``scores`` call runs
per flush, results map back per request. Batches pad to a bounded
LADDER of shapes (powers of two) so the jit cache stays small — same
discipline as the training ladder (ops.embedding.ladder_budget).

The reference has no serving story at all (its predict is a per-example
driver loop, FMModel.scala:34-55); this is new surface.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from sparkfm_tpu.config import FMConfig


def _pad_batch_size(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch (bounded jit
    cache: one compile per rung)."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


class MicroBatcher:
    """Coalesce scoring requests into one padded ``predict`` call
    (task-space outputs: raw score for regression, P(y=1) for
    classification — same contract as FMModel.predict).

    Args:
      params: FMParams (or DeepFMParams with ``model="deepfm"``).
      cfg: the matching FMConfig / DeepFMConfig.
      max_batch: flush cap; requests beyond it flush in chunks.
      use_plans: build a host dedup plan per flushed batch (pays for
        big plain-FM tables, same policy as FMModel.predict_dataset).

    Usage::

        mb = MicroBatcher(model.params, model.cfg)
        i = mb.submit(ids_a, vals_a)      # (L,) or (n_a, L)
        j = mb.submit(ids_b, vals_b)
        out = mb.flush()                  # one device call
        out[i], out[j]                    # per-request score arrays
    """

    def __init__(self, params, cfg, max_batch: int = 4096,
                 use_plans: Optional[bool] = None, model: str = "fm"):
        import jax

        self.params = params
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.model = model
        # Output space matches FMModel.predict / DeepFMModel.predict:
        # raw score for regression, P(y=1) for classification — a
        # server wants task-space outputs, and a raw/probability
        # mismatch between the batched and unbatched APIs is a trap.
        if model == "fm":
            base = cfg
            from sparkfm_tpu.models import fm as _fm
            self._score = jax.jit(
                lambda p, ids, vals, fids, plan: _fm.predict(
                    p, cfg, ids, vals, fids, plan=plan))
        elif model == "deepfm":
            base = cfg.fm
            from sparkfm_tpu.models import deepfm as _d
            self._score = jax.jit(
                lambda p, ids, vals, fids, plan: _d.predict(
                    p, cfg, ids, vals))
        else:
            raise ValueError(f"unknown model {model!r}")
        self._base: FMConfig = base
        if use_plans is None:
            use_plans = (model == "fm" and base.num_fields == 0
                         and base.num_features >= (1 << 16))
        self.use_plans = bool(use_plans)
        self._ids: List[np.ndarray] = []
        self._vals: List[np.ndarray] = []
        self._fids: List[Optional[np.ndarray]] = []
        self._sizes: List[int] = []

    def submit(self, ids, vals, field_ids=None) -> int:
        """Queue one request (a single example (L,) or a small batch
        (n, L)); returns its index for :meth:`flush`'s result list."""
        ids = np.atleast_2d(np.asarray(ids, np.int32))
        vals = np.atleast_2d(np.asarray(vals, np.float32))
        if ids.shape != vals.shape:
            raise ValueError(f"ids {ids.shape} != vals {vals.shape}")
        if field_ids is not None:
            field_ids = np.atleast_2d(np.asarray(field_ids, np.int32))
        # reject mixing at submit time: a mixed queue could only fail at
        # flush, wedging the batcher (every retry re-raises over the
        # same queue)
        if self._fids and (field_ids is None) != (self._fids[-1] is None):
            raise ValueError(
                "mixed submit: this request "
                + ("omits" if field_ids is None else "carries")
                + " field_ids while queued requests do the opposite — a "
                "queue must be all-FFM or all-plain")
        self._ids.append(ids)
        self._vals.append(vals)
        self._fids.append(field_ids)
        self._sizes.append(ids.shape[0])
        return len(self._sizes) - 1

    @property
    def pending(self) -> int:
        return int(sum(self._sizes))

    def flush(self) -> List[np.ndarray]:
        """Score everything queued in one call per ladder chunk; returns
        one score array per submit(), in submit order, queue cleared."""
        import jax.numpy as jnp

        if not self._sizes:
            return []
        ids = np.concatenate(self._ids, axis=0)
        vals = np.concatenate(self._vals, axis=0)
        fids = (np.concatenate(self._fids, axis=0)
                if self._fids and self._fids[0] is not None else None)
        sizes = list(self._sizes)
        self._ids, self._vals, self._fids, self._sizes = [], [], [], []

        outs = []
        for s0 in range(0, ids.shape[0], self.max_batch):
            chunk = ids[s0:s0 + self.max_batch]
            vchunk = vals[s0:s0 + self.max_batch]
            n = chunk.shape[0]
            b = _pad_batch_size(n, self.max_batch)
            if b > n:   # pad rows (val 0 -> exact no-ops), scores sliced off
                chunk = np.concatenate(
                    [chunk, np.zeros((b - n, chunk.shape[1]), np.int32)])
                vchunk = np.concatenate(
                    [vchunk, np.zeros((b - n, vchunk.shape[1]),
                                      np.float32)])
            plan = None
            if self.use_plans:
                from sparkfm_tpu.ops import embedding as E
                cap = E.auto_budget(chunk.size)
                # fill with the LAST row id (not 0): fill entries trail
                # the sorted uniques and the score gather
                # promises indices_are_sorted
                hp = E.host_dedup(chunk, cap,
                                  fill=self._base.num_features - 1)
                rung = E.ladder_budget(int(hp.count), cap=cap)
                if not bool(hp.overflow):   # overflow -> exact fallback
                    plan = E.DedupBatch(
                        uids=jnp.asarray(hp.uids[:rung]),
                        ranks=jnp.asarray(hp.ranks),
                        count=jnp.asarray(hp.count),
                        overflow=jnp.asarray(hp.overflow),
                        order=None, seg=None)
            fchunk = None
            if fids is not None:
                fchunk = fids[s0:s0 + self.max_batch]
                if b > fchunk.shape[0]:
                    fchunk = np.concatenate(
                        [fchunk, np.zeros((b - fchunk.shape[0],
                                           fchunk.shape[1]), np.int32)])
                fchunk = jnp.asarray(fchunk)
            s = self._score(self.params, jnp.asarray(chunk),
                            jnp.asarray(vchunk), fchunk, plan)
            outs.append(np.asarray(s)[:n])
        flat = np.concatenate(outs)
        res = []
        at = 0
        for n in sizes:
            res.append(flat[at:at + n])
            at += n
        return res
