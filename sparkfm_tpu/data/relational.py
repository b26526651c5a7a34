"""Relational (block-structure) data path: batch-time gather composition.

The reference's BS extension (fm/bs/{Relation,RelationalData,Metadata}.scala,
after Rendle's *Scaling FMs to Relational Data*) avoids materializing the
joined design matrix by keeping relation tables separate and joining per
example. In the reference this is half-built: the data plumbing exists but
training on it hits a self-recursive overload (FMLearn.scala:14) and a
commented-out ALS path (ALS.scala:77-136).

This design makes the join a device gather (SURVEY §2.4): each
relation is a padded-CSR table resident in device memory, each example carries one row
key per relation, and inside the jitted train step the full feature list is
``concat(main_block, table.ids[keys] + offset, ...)`` — static shapes, pure
gather, no host join. The feature-space layout is identical to the
materialized path (:meth:`RelationVectorizer.transform`), so the two paths
score bit-identically and either can train the same model.

Rendle's BS-ALS caching trick (per-relation-row partial sums,
Relation.scala:23-31) is unnecessary here: the gather feeds the same
interaction as any batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sparkfm_tpu.data.batching import SparseBatch, SparseDataset


@dataclasses.dataclass(frozen=True)
class RelationTable:
    """One relation as a device-friendly padded-CSR block.

    Row k holds the relation-local features of key k; ids are relation-local
    (add ``offset`` for the global feature space). The last row (index
    ``num_keys``) is an all-zero null row used for missing joins — so every
    table has ``num_keys + 1`` physical rows.
    """

    ids: jnp.ndarray                  # (K+1, Lr) int32, relation-local
    vals: jnp.ndarray                 # (K+1, Lr) float32
    offset: int = 0                   # global feature-space offset (static)

    @property
    def num_rows(self) -> int:
        return self.ids.shape[0]

    @property
    def row_nnz(self) -> int:
        return self.ids.shape[1]


jax.tree_util.register_dataclass(RelationTable,
                                 data_fields=["ids", "vals"],
                                 meta_fields=["offset"])


@dataclasses.dataclass
class RelationalDataset:
    """Host-side dataset in block-structure form.

    main_ids/main_vals hold the direct (non-relation) feature blocks with
    global ids; ``keys[:, r]`` is each example's row in ``tables[r]`` (the
    null row for missing joins). The reference analog is RelationalData
    (RelationalData.scala:41-72), whose rows are join keys into Relations.
    """

    main_ids: np.ndarray              # (N, Lm) int32 global
    main_vals: np.ndarray             # (N, Lm) float32
    y: np.ndarray                     # (N,) float32
    keys: np.ndarray                  # (N, R) int32
    tables: Tuple[RelationTable, ...]
    num_features: int

    @property
    def num_examples(self) -> int:
        return self.main_ids.shape[0]

    @property
    def total_nnz_per_example(self) -> int:
        return (self.main_ids.shape[1]
                + sum(t.row_nnz for t in self.tables))

    def materialize(self) -> SparseDataset:
        """Expand to a flat SparseDataset (the reference's 'Method 1';
        RelationVectorizor.scala:11-12). Used for eval and parity tests."""
        parts_ids = [self.main_ids]
        parts_vals = [self.main_vals]
        for r, t in enumerate(self.tables):
            tid = np.asarray(t.ids)
            tval = np.asarray(t.vals)
            k = self.keys[:, r]
            parts_ids.append(tid[k] + t.offset)
            parts_vals.append(tval[k])
        return SparseDataset(
            ids=np.concatenate(parts_ids, axis=1).astype(np.int32),
            vals=np.concatenate(parts_vals, axis=1).astype(np.float32),
            y=self.y, num_features=self.num_features)

    def slice(self, idx: np.ndarray) -> "RelationalDataset":
        return RelationalDataset(
            main_ids=self.main_ids[idx], main_vals=self.main_vals[idx],
            y=self.y[idx], keys=self.keys[idx], tables=self.tables,
            num_features=self.num_features)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RelationalBatch:
    """One batch: direct features + per-relation row keys (a JAX pytree)."""

    main_ids: jnp.ndarray             # (B, Lm) int32
    main_vals: jnp.ndarray            # (B, Lm) float32
    y: jnp.ndarray                    # (B,) float32
    keys: jnp.ndarray                 # (B, R) int32
    mask: Optional[jnp.ndarray] = None  # (B,) bool


def compose_batch(batch: RelationalBatch,
                  tables: Sequence[RelationTable]) -> SparseBatch:
    """Device-side join: gather each relation row and concatenate blocks.

    Jit-traceable; output shapes are static: (B, Lm + sum Lr). Null rows
    contribute ids at their table offset with value 0 — inert everywhere
    (zero score contribution, zero gradient), same as ordinary padding.
    """
    ids_parts = [batch.main_ids]
    vals_parts = [batch.main_vals]
    for r, t in enumerate(tables):
        k = batch.keys[:, r]
        ids_parts.append(t.ids[k] + t.offset)
        vals_parts.append(t.vals[k])
    return SparseBatch(
        ids=jnp.concatenate(ids_parts, axis=1),
        vals=jnp.concatenate(vals_parts, axis=1),
        y=batch.y, mask=batch.mask)


def relational_batch_iterator(ds: RelationalDataset, batch_size: int,
                              shuffle: bool = False, seed: int = 0,
                              epoch: int = 0,
                              drop_remainder: bool = False
                              ) -> Iterator[RelationalBatch]:
    """Fixed-shape RelationalBatches; tail batch padded + masked.

    Padding rows point at the null row of every table (key = num_rows - 1).
    """
    n = ds.num_examples
    order = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        rng.shuffle(order)
    null_keys = np.asarray([t.num_rows - 1 for t in ds.tables], np.int32)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        b = len(idx)
        mask = np.zeros((batch_size,), bool)
        mask[:b] = True
        if b < batch_size:
            if drop_remainder:
                return
            pad = batch_size - b
            main_ids = np.concatenate(
                [ds.main_ids[idx],
                 np.zeros((pad, ds.main_ids.shape[1]), np.int32)])
            main_vals = np.concatenate(
                [ds.main_vals[idx],
                 np.zeros((pad, ds.main_vals.shape[1]), np.float32)])
            y = np.concatenate([ds.y[idx], np.zeros((pad,), np.float32)])
            keys = np.concatenate(
                [ds.keys[idx],
                 np.broadcast_to(null_keys, (pad, len(null_keys)))])
        else:
            main_ids, main_vals = ds.main_ids[idx], ds.main_vals[idx]
            y, keys = ds.y[idx], ds.keys[idx]
        yield RelationalBatch(
            main_ids=jnp.asarray(main_ids),
            main_vals=jnp.asarray(main_vals * mask[:len(main_vals), None]
                                  if b < batch_size else main_vals),
            y=jnp.asarray(y), keys=jnp.asarray(keys, jnp.int32),
            mask=jnp.asarray(mask))


def tables_to_device(tables: Sequence[RelationTable]) -> Tuple:
    """Move relation tables into device memory once, before the train loop."""
    return tuple(RelationTable(ids=jnp.asarray(t.ids),
                               vals=jnp.asarray(t.vals),
                               offset=t.offset) for t in tables)


def make_relational_train_step(cfg, sgd_cfg):
    """Jitted SGD step on block-structure batches.

    (state, RelationalBatch, tables) -> (state, aux). The join happens inside
    the step (compose_batch), so relation features are gathered in HBM and
    fused straight into the interaction kernel — this is the working
    replacement for the reference's dead relational training path
    (FMLearn.scala:14 self-recursion; ALS.scala:77-136 commented out).
    """
    from sparkfm_tpu.solvers import sgd as sgd_solver
    base = sgd_solver.make_train_step(cfg, sgd_cfg)

    def step(state, rbatch: RelationalBatch, tables):
        return base(state, compose_batch(rbatch, tables))

    return jax.jit(step, donate_argnums=(0,))


def make_relational_score_fn(cfg):
    """Jitted scoring on block-structure batches: (params, rbatch, tables)."""
    from sparkfm_tpu.models import fm as fm_model

    def score(params, rbatch: RelationalBatch, tables):
        full = compose_batch(rbatch, tables)
        return fm_model.scores(params, cfg, full.ids, full.vals)

    return jax.jit(score)
