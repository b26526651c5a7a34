"""Fixed-shape sparse batch representation + host-side batching.

XLA requires static shapes; the reference's per-example Breeze
SparseVectors of varying nnz (DataSet.scala:42-48) become padded CSR arrays:

    ids:  (B, L) int32  — active feature ids; padding slots hold id 0
    vals: (B, L) float32 — feature values; padding slots hold 0.0
    y:    (B,)   float32 — targets

A padded slot with val == 0 is an *exact* mathematical no-op for FM (both the
linear term and every interaction term multiply by x), so no mask is needed
on the forward path. L (`max_nnz`) is a per-dataset budget; examples with
more actives are truncated (with a warning) — choose L = dataset max to be
lossless.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SparseBatch:
    """One batch of examples in padded-CSR form (a JAX pytree)."""

    ids: jnp.ndarray                 # (B, L) int32
    vals: jnp.ndarray                # (B, L) float32
    y: jnp.ndarray                   # (B,) float32
    # Optional per-example validity (False = padding row in a tail batch).
    mask: Optional[jnp.ndarray] = None       # (B,) bool
    # Optional per-slot field ids for FFM.
    field_ids: Optional[jnp.ndarray] = None  # (B, L) int32
    # Optional host-precomputed dedup plan (ops.embedding.DedupBatch):
    # when present, the dedup/fused train steps skip the on-device sorts
    # (the input pipeline computes it overlapped with device compute).
    plan: Optional[object] = None

    @property
    def batch_size(self) -> int:
        return self.ids.shape[0]

    @property
    def max_nnz(self) -> int:
        return self.ids.shape[1]


@dataclasses.dataclass
class SparseDataset:
    """Whole dataset as padded-CSR numpy arrays on host.

    The host-side analog of the reference's DataSet (DataSet.scala:42-73);
    `num_features` is the true feature dimension (fixing the reference's
    DataSet.dimension-returns-row-count bug at DataSet.scala:70-72).
    """

    ids: np.ndarray                  # (N, L) int32
    vals: np.ndarray                 # (N, L) float32
    y: np.ndarray                    # (N,) float32
    num_features: int
    field_ids: Optional[np.ndarray] = None  # (N, L) int32

    @property
    def num_examples(self) -> int:
        return self.ids.shape[0]

    @property
    def max_nnz(self) -> int:
        return self.ids.shape[1]

    def slice(self, idx: np.ndarray) -> "SparseDataset":
        return SparseDataset(
            ids=self.ids[idx], vals=self.vals[idx], y=self.y[idx],
            num_features=self.num_features,
            field_ids=None if self.field_ids is None else self.field_ids[idx])


def pack_examples(rows: Sequence[tuple], num_features: int,
                  max_nnz: Optional[int] = None,
                  field_of_feature: Optional[np.ndarray] = None
                  ) -> SparseDataset:
    """Pack (label, indices, values) triples into a SparseDataset.

    Args:
      rows: sequence of (y, ids_array, vals_array).
      max_nnz: pad/truncate budget; default = max nnz over rows (lossless).
      field_of_feature: optional (F,) feature->field map to emit field_ids.
    """
    n = len(rows)
    if max_nnz is None:
        max_nnz = max((len(r[1]) for r in rows), default=1)
        max_nnz = max(max_nnz, 1)
    ids = np.zeros((n, max_nnz), np.int32)
    vals = np.zeros((n, max_nnz), np.float32)
    y = np.zeros((n,), np.float32)
    for i, (yi, idx, vls) in enumerate(rows):
        k = min(len(idx), max_nnz)
        ids[i, :k] = np.asarray(idx[:k], np.int32)
        vals[i, :k] = np.asarray(vls[:k], np.float32)
        y[i] = yi
    fids = None
    if field_of_feature is not None:
        fids = field_of_feature[ids].astype(np.int32)
    return SparseDataset(ids=ids, vals=vals, y=y, num_features=num_features,
                         field_ids=fids)


def batch_iterator(ds: SparseDataset, batch_size: int,
                   shuffle: bool = False, seed: int = 0,
                   drop_remainder: bool = False,
                   epoch: int = 0,
                   dedup_budget=None,
                   dedup_fill: Optional[int] = None) -> Iterator[SparseBatch]:
    """Yield fixed-shape SparseBatches; the tail batch is padded + masked.

    Deterministic shuffling keyed by (seed, epoch) — replacing the
    reference's unseeded randomSplit/iteration order (DataCollection.scala:42).

    With ``dedup_budget``/``dedup_fill`` set, each batch carries a
    host-computed dedup plan (see ops.embedding.host_dedup), which the
    dedup/fused train steps consume instead of sorting on device. Wrap the
    iterator in :func:`prefetch` so the plan computation overlaps device
    compute.

    ``dedup_budget="ladder"`` sizes each plan's unique budget to the
    batch's ACTUAL unique count rounded up to a coarse ladder rung
    (ops.embedding.ladder_budget) — overflow is impossible by
    construction and every unique-row cost in the step shrinks to fit.
    Rungs
    only ever grow within one iterator (monotonic), so a training run
    jit-compiles at most a handful of step variants instead of one per
    fluctuating count.
    """
    n = ds.num_examples
    order = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        rng.shuffle(order)
    ladder = dedup_budget == "ladder"
    if ladder:
        from sparkfm_tpu.ops import embedding as _E
        ladder_cap = _E.auto_budget(batch_size * ds.max_nnz)
        rung = 1
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        b = len(idx)
        if b < batch_size:
            if drop_remainder:
                return
            pad = np.zeros((batch_size - b,), np.int64)
            idx = np.concatenate([idx, pad])
        mask = np.zeros((batch_size,), bool)
        mask[:b] = True
        ids_np = ds.ids[idx]
        vals_np = ds.vals[idx] * mask[:, None]
        plan = None
        if dedup_budget is not None and dedup_fill is not None:
            from sparkfm_tpu.ops import embedding as _E
            if ladder:
                hp = _E.host_dedup(ids_np, ladder_cap, dedup_fill,
                                   vals=vals_np)
                rung = max(rung, _E.ladder_budget(int(hp.count),
                                                  cap=ladder_cap))
                hp = hp._replace(uids=hp.uids[:rung])
            else:
                hp = _E.host_dedup(ids_np, dedup_budget, dedup_fill,
                                   vals=vals_np)
            plan = _E.DedupBatch(
                uids=jnp.asarray(hp.uids), ranks=jnp.asarray(hp.ranks),
                count=jnp.asarray(hp.count),
                overflow=jnp.asarray(hp.overflow),
                order=jnp.asarray(hp.order), seg=jnp.asarray(hp.seg),
                svals=jnp.asarray(hp.svals), sex=jnp.asarray(hp.sex))
        yield SparseBatch(
            ids=jnp.asarray(ids_np),
            vals=jnp.asarray(vals_np),
            y=jnp.asarray(ds.y[idx] * mask),
            mask=jnp.asarray(mask),
            field_ids=(None if ds.field_ids is None
                       else jnp.asarray(ds.field_ids[idx])),
            plan=plan,
        )


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run a batch iterator in a background thread with a bounded queue.

    Overlaps host-side batch assembly (slicing, host->device transfer
    issue, dedup-plan computation) with device compute — the standard
    input-pipeline shape the reference gets implicitly from Spark's lazy
    RDD evaluation on executors.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:       # propagate into the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


def to_device_arrays(ds: SparseDataset):
    """Move the whole dataset to device (used by the ALS solver, which sweeps
    the full dataset rather than minibatches)."""
    out = {
        "ids": jnp.asarray(ds.ids),
        "vals": jnp.asarray(ds.vals),
        "y": jnp.asarray(ds.y),
    }
    if ds.field_ids is not None:
        out["field_ids"] = jnp.asarray(ds.field_ids)
    return out
