"""Per-unique-row reductions over id-sorted slots, in plain XLA.

The dedup plans (ops/embedding.py) sort a batch's slots by feature id and
give each sorted slot ``seg``: the dense rank of its id (sorted, starting
at 0, stepping by at most 1). Every reduction here sums rows of slots
that share a rank, ``out[u] = sum_{i: seg[i] == u} row[i]``, into a
``(num_segments, W)`` result whose ranks above ``seg[-1]`` (the plan's
unused budget) read zero. Each is ``jax.ops.segment_sum`` with
``indices_are_sorted=True``: ``seg`` MUST be sorted (a false promise
gives wrong sums, not just slow ones). The hint is what makes XLA:GPU's
scatter fast on these runs (PERF.md, the kernel decision); the
elementwise payload fuses into the reduce's operand.

Ranks outside ``[0, num_segments)`` are dropped by ``segment_sum``, so a
plan that clips overflow ids to the last budget rank stays in bounds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def segment_rowsum(g: jnp.ndarray, seg: jnp.ndarray,
                   num_segments: int) -> jnp.ndarray:
    """(N, W) rows summed per rank of sorted ``seg`` -> (U, W)."""
    return jax.ops.segment_sum(g, seg, num_segments=num_segments,
                               indices_are_sorted=True)


def segment_rowsum_sq(g: jnp.ndarray, seg: jnp.ndarray,
                      num_segments: int) -> jnp.ndarray:
    """[Σg | Σg²] per rank: (N, W) -> (U, 2W)."""
    return segment_rowsum(jnp.concatenate([g, jnp.square(g)], axis=1), seg,
                          num_segments)


def fm_grad_segsum(vw_srt: jnp.ndarray, ex_srt: jnp.ndarray,
                   x: jnp.ndarray, seg: jnp.ndarray, num_segments: int,
                   cv, cw) -> jnp.ndarray:
    """FM backward in id-sorted slot order + per-unique reduce.

    (N, k+1) slot rows [v | w], (N, k+2) example pack [s | ds | wt] and
    (N,) slot values -> (U, 2k+2) [Σg_v | Σg_w | Σg_v² | Σg_w²], where

        g_v[i] = ds_i x_i (s_i - v_i x_i) + cv * v_i * active_i
        g_w[i] = ds_i x_i + cw * w_i * active_i
        active_i = wt_i if x_i != 0 else 0

    cv/cw are the per-batch L2 coefficients 2*reg/denom_reg (traced
    scalars). Runs under the named scope ``fm_grad_segsum``, which the
    profiler trace carries on every operation of the reduce.
    """
    with jax.named_scope("fm_grad_segsum"):
        return _fm_grad_segsum(vw_srt, ex_srt, x, seg, num_segments, cv, cw)


def _fm_grad_segsum(vw_srt, ex_srt, x, seg, num_segments, cv, cw):
    k = vw_srt.shape[1] - 1
    v_srt = vw_srt[:, :k]
    w_srt = vw_srt[:, k]
    s_srt, ds_srt, wt_srt = ex_srt[:, :k], ex_srt[:, k], ex_srt[:, k + 1]
    active = jnp.where(x != 0, wt_srt, 0.0)
    dsx = ds_srt * x
    g_v = dsx[:, None] * (s_srt - v_srt * x[:, None]) \
        + (cv * active)[:, None] * v_srt
    g_w = dsx + cw * w_srt * active
    gpack = jnp.concatenate([g_v, g_w[:, None]], axis=1)
    return segment_rowsum_sq(gpack, seg, num_segments)


def fm_grad_segsum_factored(vw_u: jnp.ndarray, ex_srt: jnp.ndarray,
                            x: jnp.ndarray, seg: jnp.ndarray,
                            num_segments: int, cv, cw) -> jnp.ndarray:
    """:func:`fm_grad_segsum` fed from the (U, k+1) unique rows.

    vw_u must be aligned with seg's rank space (the single-device plan's
    budget rows, or vw_u[gmap] per shard on the sharded path); each
    sorted slot reads its run's row, ``vw_u[seg]``. Returns the same
    (U, 2k+2) [Σg_v | Σg_w | Σg_v² | Σg_w²].
    """
    with jax.named_scope("fm_grad_segsum"):
        vw_srt = vw_u.at[seg].get(indices_are_sorted=True,
                                  mode="promise_in_bounds")
        return fm_grad_segsum(vw_srt, ex_srt, x, seg, num_segments, cv, cw)


def segment_colsums(streams, seg: jnp.ndarray,
                    num_segments: int) -> jnp.ndarray:
    """Per-rank sums of scalar streams: ([(N,)] * S, sorted dense seg)
    -> (U, S), column j = segment_rowsum(streams[j], seg).

    One 1-D segment sum per stream: stacking to (N, S) first would
    materialize an (N, S) copy of streams that are already in memory.
    """
    return jnp.stack([segment_rowsum(s, seg, num_segments)
                      for s in streams], axis=1)
