"""Sparse embedding-table access paths.

A batch of B examples with L slots touches B*L table rows, but CTR-style
(power-law) batches reference far fewer distinct ids. The dedup path
sorts the batch ids once, compacts them to unique rows (a static budget
U), touches the big table only U times, and does all per-slot work
against a small (U, K) matrix:

  1. sort (ids, pos)
  2. seg_id = rank of each sorted slot's unique id    [cumsum]
  3. ranks in natural order = unsort seg_id by pos    [2nd sort]
  4. unique ids = stable compaction of boundaries     [3rd sort]
  5. rows_u = table[uids]                             [U big-table rows]
  6. per-slot rows = rows_u[ranks]                    [N small-table rows]
  7. backward: grads scatter-add into (U, K)
  8. update unique rows densely, write back with one
     scatter-set of U unique rows                     [U big-table rows]

For power-law batches U << N, so steps 5/8 — the only big-table traffic
— shrink by the dedup ratio. Overflowing ids beyond the U budget fall
back into a shared overflow slot whose updates are dropped (counted in
aux); budgets should be set so this is rare (auto mode sizes U from N).

The reference has no analog: its driver pulls the whole dataset and model
into JVM heaps (ALS.scala:34). This module replaces "how parameters are
touched at all".
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp


class DedupBatch(NamedTuple):
    """Deduplicated lookup plan for one batch of flat ids.

    uids:   (U,) int32 — unique ids, sorted; unused budget slots hold
            ``fill`` (pass the table's padded dummy row id).
    ranks:  same shape as the input ids — position of each slot's id in uids.
    count:  () int32 — number of distinct ids (may exceed U; see overflow).
    overflow: () bool — True if distinct ids exceeded the U budget. Slots
            whose id ranked >= U alias the last budget slot; with the fill
            row as a dummy this degrades gracefully (their gathers read the
            dummy row; their updates all land on it).
    order:  optional (N,) int32 — the id-sort permutation of flat slots
            (flat_ids[order] is non-decreasing). Both plan builders emit
            it for free (the sort happens anyway); it enables the hybrid
            accumulate (:func:`accumulate_to_unique_sorted`): permute slot
            grads once, then a streaming segment sum replaces the random
            scatter-add.
    seg:    optional (N,) int32 — dense rank of each *sorted* slot's id,
            clipped to [0, U) (== ranks.reshape(-1)[order]); sorted
            non-decreasing, step <= 1 — the ops/segsum.py contract.
    svals:  optional (N,) f32 — slot values in id-sorted order
            (= vals.flat[order]); host plans carry it so the hybrid
            sorted-backward step (solvers/sgd_hybrid.py) never permutes on
            device (free on the host, where `order` already exists).
    sex:    optional (N,) int32 — each sorted slot's example index
            (= order // L).
    """

    uids: jnp.ndarray
    ranks: jnp.ndarray
    count: jnp.ndarray
    overflow: jnp.ndarray
    order: Optional[jnp.ndarray] = None
    seg: Optional[jnp.ndarray] = None
    svals: Optional[jnp.ndarray] = None
    sex: Optional[jnp.ndarray] = None


def dedup_ids(ids: jnp.ndarray, budget: int, fill: int) -> DedupBatch:
    """Build a DedupBatch from (possibly multi-dim) int32 ids.

    Three cheap int32 sorts, no big-table access. ``budget`` is the static
    unique capacity U; ``fill`` is the dummy row id used for unused slots.
    """
    shape = ids.shape
    flat = ids.reshape(-1)
    n = flat.shape[0]
    pos = jax.lax.iota(jnp.int32, n)

    sid, spos = jax.lax.sort((flat, pos), num_keys=1)
    boundary = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sid[1:] != sid[:-1]])
    seg = jnp.cumsum(boundary.astype(jnp.int32)) - 1      # rank in sorted
    count = seg[-1] + 1
    overflow = count > budget
    seg_c = jnp.minimum(seg, budget - 1)

    # natural-order ranks: unsort seg_c by original position
    _, ranks = jax.lax.sort((spos, seg_c), num_keys=1)

    # compaction: stable sort by (not boundary) brings one representative of
    # each unique id to the front, in ascending id order (stability keeps
    # the within-group order; boundaries are the first of each run).
    nb = jnp.logical_not(boundary).astype(jnp.int32)
    _, uid_sorted = jax.lax.sort((nb, sid), num_keys=1, is_stable=True)
    take = min(budget, n)
    uids = uid_sorted[:take]
    if take < budget:
        uids = jnp.concatenate(
            [uids, jnp.full((budget - take,), fill, jnp.int32)])
    # blank out slots beyond count
    slot_idx = jax.lax.iota(jnp.int32, budget)
    uids = jnp.where(slot_idx < jnp.minimum(count, budget), uids, fill)

    return DedupBatch(uids=uids, ranks=ranks.reshape(shape), count=count,
                      overflow=overflow, order=spos, seg=seg_c)


def host_dedup(ids, budget: int, fill: int, vals=None) -> DedupBatch:
    """Numpy twin of :func:`dedup_ids` for the host input pipeline.

    Computing the plan on the host (overlapped with device compute by the
    prefetching batch iterator) removes the in-step sorts entirely.
    Semantics are identical; tests assert element equality with
    dedup_ids.

    With ``vals`` (same shape as ids), the plan additionally carries the
    id-sorted values ``svals`` and sorted example indices ``sex`` for the
    hybrid sorted-backward step.

    Routes to the native radix-sort builder (native/dedup_plan.cpp) when
    available: numpy's argsort + fancy-index passes are several times
    slower than the native builder at Criteo batch shapes and can
    throttle the prefetch pipeline. SPARKFM_NO_NATIVE=1 forces this
    numpy path (the semantics reference; parity pinned in
    tests/test_native_io.py).
    """
    import numpy as _np
    from sparkfm_tpu.data import native_io as _nio
    nat = _nio.dedup_plan_native(_np.asarray(ids), budget, fill,
                                 None if vals is None
                                 else _np.asarray(vals))
    if nat is not None:
        uids, ranks, count, overflow, order, seg, svals, sex = nat
        return DedupBatch(uids=uids, ranks=ranks, count=count,
                          overflow=overflow, order=order, seg=seg,
                          svals=svals, sex=sex)
    shape = ids.shape
    flat = _np.asarray(ids, _np.int32).reshape(-1)
    n = flat.shape[0]
    order = _np.argsort(flat, kind="stable")
    sid = flat[order]
    boundary = _np.empty(n, bool)
    boundary[0] = True
    boundary[1:] = sid[1:] != sid[:-1]
    seg = _np.cumsum(boundary, dtype=_np.int64) - 1
    count = int(seg[-1]) + 1
    overflow = count > budget
    seg_c = _np.minimum(seg, budget - 1).astype(_np.int32)
    ranks = _np.empty(n, _np.int32)
    ranks[order] = seg_c
    uids = _np.full((budget,), fill, _np.int32)
    m = min(count, budget)
    uids[:m] = sid[boundary][:m]
    svals = sex = None
    if vals is not None:
        svals = _np.asarray(vals, _np.float32).reshape(-1)[order]
        sex = (order // shape[-1]).astype(_np.int32)
    return DedupBatch(uids=uids, ranks=ranks.reshape(shape),
                      count=_np.int32(count),
                      overflow=_np.bool_(overflow),
                      order=order.astype(_np.int32), seg=seg_c,
                      svals=svals, sex=sex)


def stack_plans(ids, num_shards: int, budget: int, fill: int) -> DedupBatch:
    """Per-data-shard host dedup plans for a sharded batch, stacked.

    Splits the global (B, L) id block into ``num_shards`` equal row chunks,
    runs :func:`host_dedup` on each, and stacks:

      uids     (D, U)   — per-shard unique ids
      ranks    (B, L)   — per-shard ranks, concatenated like ids (so the
                          same P('data', None) spec shards both)
      count    (D,)
      overflow (D,)

    order/seg are dropped: the sharded step reduces with the local
    scatter-add, which only needs ranks. Used by
    parallel.sharded_sgd.make_sharded_train_step's unique exchange.
    """
    import numpy as _np
    b = ids.shape[0]
    assert b % num_shards == 0, (b, num_shards)
    chunk = b // num_shards
    uids, ranks, counts, over = [], [], [], []
    for d in range(num_shards):
        hp = host_dedup(ids[d * chunk:(d + 1) * chunk], budget, fill)
        uids.append(hp.uids)
        ranks.append(hp.ranks)
        counts.append(hp.count)
        over.append(hp.overflow)
    return DedupBatch(
        uids=_np.stack(uids), ranks=_np.concatenate(ranks, axis=0),
        count=_np.asarray(counts, _np.int32),
        overflow=_np.asarray(over, bool), order=None, seg=None)


def stack_hybrid_extras(ranks, vals, num_shards: int,
                        u_cap: int = 0) -> Tuple:
    """Per-data-shard sorted-backward extras for the GLOBAL exchange.

    Given the GLOBAL plan's ranks (B, L) and the batch vals, split into
    ``num_shards`` equal row chunks and, per shard, sort its slots by
    global rank so the analytic FM backward (ops/segsum.py::
    fm_grad_segsum) can run per shard on DENSE local ranks
    (parallel/sharded_sgd.py "global" exchange, hybrid branch):

      seg   (D, N_loc) — local dense ranks, sorted non-decreasing
      svals (D, N_loc) — slot values in that order
      sex   (D, N_loc) — shard-local example index per sorted slot
      gmap  (D, U_cap) — local unique -> GLOBAL rank (the scatter-add
                         map into the shared (U_g, 2k+2) accumulator);
                         unused budget entries point at 0 and carry
                         exact-zero rows, so they are harmless adds

    u_cap=0 sizes the stack to the ladder rung above the max per-shard
    unique count (uniform static shape across shards).
    """
    import numpy as _np
    b, l = ranks.shape
    assert b % num_shards == 0, (b, num_shards)
    chunk = b // num_shards
    per = []
    max_u = 1
    for d in range(num_shards):
        gr = _np.asarray(ranks[d * chunk:(d + 1) * chunk],
                         _np.int64).reshape(-1)
        order = _np.argsort(gr, kind="stable")
        sgr = gr[order]
        boundary = _np.empty(len(sgr), bool)
        boundary[0] = True
        boundary[1:] = sgr[1:] != sgr[:-1]
        seg = (_np.cumsum(boundary) - 1).astype(_np.int32)
        u_d = int(seg[-1]) + 1
        max_u = max(max_u, u_d)
        guniq = sgr[boundary].astype(_np.int32)
        sv = _np.asarray(vals[d * chunk:(d + 1) * chunk],
                         _np.float32).reshape(-1)[order]
        sex = (order // l).astype(_np.int32)
        per.append((seg, sv, sex, guniq, u_d))
    # u_cap is a MINIMUM (monotonic-rung discipline across batches, like
    # batch_iterator's ladder): the stack is padded to at least the
    # ladder rung above the max per-shard unique count.
    u_cap = max(ladder_budget(max_u), u_cap)
    segs, svs, sexs, gmaps = [], [], [], []
    for seg, sv, sex, guniq, u_d in per:
        gm = _np.zeros((u_cap,), _np.int32)
        gm[:u_d] = guniq
        segs.append(seg)
        svs.append(sv)
        sexs.append(sex)
        gmaps.append(gm)
    return (_np.stack(segs), _np.stack(svs), _np.stack(sexs),
            _np.stack(gmaps), u_cap)


class SortedPlan(NamedTuple):
    """Slot-sorted lookup plan (the ``update_path="sorted"`` layout).

    Slots are reordered by feature id so that per-unique reductions become
    contiguous-run segment sums (ops/segsum.py) instead of random
    scatter-adds. Payloads ride the sort, so no unsort pass exists at all.

    svals: (N,) f32 — slot values in sorted order.
    sex:   (N,) i32 — slot's example index in sorted order.
    seg:   (N,) i32 — dense rank of each sorted slot's unique id, clipped
           to [0, budget).
    uids:  (U,) i32 — unique ids, sorted; unused slots hold ``fill``.
    count / overflow: as DedupBatch.
    """

    svals: jnp.ndarray
    sex: jnp.ndarray
    seg: jnp.ndarray
    uids: jnp.ndarray
    count: jnp.ndarray
    overflow: jnp.ndarray


def sorted_plan(ids: jnp.ndarray, vals: jnp.ndarray, budget: int,
                fill: int) -> SortedPlan:
    """Sort slots by id carrying (val, example) payloads; derive dense
    ranks and the compacted unique-id list. Two sorts total (the natural-
    order 'unsort' sort that DedupBatch needs is gone — nothing here ever
    returns to natural slot order)."""
    b, l = ids.shape
    flat = ids.reshape(-1)
    n = flat.shape[0]
    pos = jax.lax.iota(jnp.int32, n)
    sid, svals, spos = jax.lax.sort(
        (flat, vals.reshape(-1), pos), num_keys=1)
    sex = spos // l

    boundary = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sid[1:] != sid[:-1]])
    seg = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    count = seg[-1] + 1
    overflow = count > budget
    seg_c = jnp.minimum(seg, budget - 1)

    nb = jnp.logical_not(boundary).astype(jnp.int32)
    _, uid_sorted = jax.lax.sort((nb, sid), num_keys=1, is_stable=True)
    take = min(budget, n)
    uids = uid_sorted[:take]
    if take < budget:
        uids = jnp.concatenate(
            [uids, jnp.full((budget - take,), fill, jnp.int32)])
    slot_idx = jax.lax.iota(jnp.int32, budget)
    uids = jnp.where(slot_idx < jnp.minimum(count, budget), uids, fill)

    return SortedPlan(svals=svals, sex=sex, seg=seg_c, uids=uids,
                      count=count, overflow=overflow)


def gather_rows(table: jnp.ndarray, ids: jnp.ndarray,
                indices_are_sorted: bool = False) -> jnp.ndarray:
    """(U, ...) rows of the big table — the only big-table gather.

    ``promise_in_bounds`` skips XLA's clamping: every id must lie in
    [0, table rows), which the plans guarantee by filling unused budget
    slots with the table's own dummy row id. A plan's uids are ascending
    with the max-id fill trailing, so callers pass
    ``indices_are_sorted=True`` for them; never for unsorted ids (a false
    promise gives wrong rows, not just slow ones).
    """
    return table.at[ids].get(indices_are_sorted=indices_are_sorted,
                             mode="promise_in_bounds")


def spread(rows_u: jnp.ndarray, plan: DedupBatch) -> jnp.ndarray:
    """Per-slot rows in natural order from the small unique matrix."""
    return rows_u[plan.ranks]


def accumulate_to_unique(g_slots: jnp.ndarray, plan: DedupBatch,
                         budget: int) -> jnp.ndarray:
    """Combine per-slot gradients into per-unique-row gradients (small
    scatter-add; the transpose of :func:`spread`)."""
    flat_ranks = plan.ranks.reshape(-1)
    g2 = g_slots.reshape((flat_ranks.shape[0],) + g_slots.shape[len(plan.ranks.shape):])
    return jnp.zeros((budget,) + g2.shape[1:], g2.dtype).at[flat_ranks].add(g2)


def accumulate_to_unique_sorted(g_slots: jnp.ndarray, plan: DedupBatch,
                                budget: int) -> jnp.ndarray:
    """Sorted accumulate: permute per-slot grads into id-sorted order
    (``plan.order``) and reduce contiguous runs with a segment sum
    (ops/segsum.py).

    Same result as :func:`accumulate_to_unique` up to float summation
    order. Requires ``plan.order``/``plan.seg`` (both plan builders emit
    them).
    """
    assert plan.order is not None and plan.seg is not None
    n = plan.order.shape[0]
    flat = g_slots.reshape((n,) + g_slots.shape[len(plan.ranks.shape):])
    # segment_rowsum wants (N, W); per-slot scalar payloads (shape == ids
    # shape, as accumulate_to_unique accepts) ride as a width-1 column.
    scalar = flat.ndim == 1
    if scalar:
        flat = flat[:, None]
    elif flat.ndim > 2:
        raise ValueError("sorted accumulate supports (N,) or (N, W) "
                         f"payloads, got trailing shape {flat.shape[1:]}")
    srt = flat.at[plan.order].get(unique_indices=True,
                                  mode="promise_in_bounds")
    from sparkfm_tpu.ops import segsum as SS
    out = SS.segment_rowsum(srt, plan.seg, budget)
    return out[:, 0] if scalar else out


def write_rows(table: jnp.ndarray, ids: jnp.ndarray, rows: jnp.ndarray,
               indices_are_sorted: bool = False,
               unique_indices: bool = False) -> jnp.ndarray:
    """table.at[ids].set(rows): the unique-row write-back.

    Same ``promise_in_bounds`` contract as :func:`gather_rows`.
    ``unique_indices`` is passed only when the caller opts in: dedup plans
    pad unused budget slots with a repeated fill id, so uniqueness is
    violated ONLY on the dummy row — its value races, which is fine
    exactly because the dummy row's content is garbage by contract.
    Callers writing real rows under duplicate ids keep it False.
    """
    return table.at[ids].set(rows, indices_are_sorted=indices_are_sorted,
                             unique_indices=unique_indices,
                             mode="promise_in_bounds")


def auto_budget(n_slots: int, cap: int = 1 << 18) -> int:
    """Static unique budget: next power of two >= n_slots, capped.

    With budget >= n_slots overflow is impossible; smaller budgets trade
    memory for a small dropped-update risk on pathological batches.
    """
    b = 1
    while b < n_slots:
        b *= 2
    return min(b, cap)


def ladder_budget(count: int, cap: int = 1 << 18) -> int:
    """Smallest ladder rung >= count; rungs are m * 2^k for m in 4..7
    (quarter-octave steps, <= 25% padding).

    The host input pipeline knows each batch's EXACT unique count before
    the step runs, so the plan can be padded to a tight rung instead of a
    worst-case power of two — every unique-row cost in the step (the
    big-table gather, the update math and the write-back scatter) scales
    with the rung. A BOUNDED ladder caps jit recompiles: 4 rungs per octave, each
    compiled once; with the monotonic-rung rule in batch_iterator real
    runs settle on one or two.
    """
    if count <= 0:
        return 1
    if count <= 4:
        return min(count, cap)
    b = 1
    while (b << 3) < count:
        b <<= 1
    for m in (4, 5, 6, 7, 8):
        if m * b >= count:
            return min(m * b, cap)
    raise AssertionError("unreachable")
