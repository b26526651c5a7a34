"""Sorted-slot SGD: the fused-record path restructured around sorted runs.

The fused path's cost is dominated by row-granular dynamic ops: the
per-slot spread of unique rows, the scatter-add of slot gradients into
the (U, W) accumulator, and the big-table gather and write-back. This
path removes every random-access op that scales with N:

  1. ONE sort of (id, val, pos) — payloads ride the sort; slots stay in
     sorted order forever after (no unsort).
  2. Unique rows come in with one gather (ops/embedding.gather_rows) and
     leave with one write-back (ops/embedding.write_rows).
  3. The forward expands unique rows to slots with a *monotone* gather,
     reduces per-example sums by scatter-add into the small (B, k+2)
     example space, and computes loss/score vectorized.
  4. The per-example part of the backward is jax.grad of a tiny (B, k+2)
     function — the slot-space bilinear backward is written by hand.
  5. Per-unique gradient sums are a segment sum over sorted runs
     (ops/segsum.py) instead of a scatter-add by rank.

Update semantics are identical to solvers/sgd_fused.py (same fused-record
table layout, same adagrad sum-of-squares accumulation; tested for parity).

Reference lineage: this replaces the driver-side sequential coordinate
work of the reference's only solver (ALS.scala:34-70) with batched
device-side updates; SGD itself is a capability the reference lacks
(SURVEY §2.3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sparkfm_tpu.config import FMConfig, SGDConfig
from sparkfm_tpu.data.batching import SparseBatch
from sparkfm_tpu.ops import embedding as E
from sparkfm_tpu.ops import losses as L
from sparkfm_tpu.ops import segsum as SS
from sparkfm_tpu.solvers import sgd as sgd_solver
from sparkfm_tpu.solvers.sgd_fused import FusedState  # shared layout


def make_sorted_train_step(cfg: FMConfig, sgd_cfg: SGDConfig):
    """(FusedState, SparseBatch) -> (FusedState, aux)."""
    if cfg.num_fields > 0:
        raise ValueError("sorted path supports plain FM")
    if sgd_cfg.optimizer not in ("adagrad", "sgd"):
        raise ValueError("sorted path supports adagrad/sgd")
    if sgd_cfg.momentum > 0 and sgd_cfg.optimizer == "sgd":
        raise ValueError("sorted path: momentum not supported")
    k = cfg.num_factors
    loss_fn = L.loss_for_task(cfg.task)

    def train_step(state: FusedState, batch: SparseBatch):
        F = state.table.shape[0] - 1
        B, Lq = batch.ids.shape
        n_slots = B * Lq
        budget = sgd_cfg.unique_budget or E.auto_budget(n_slots)

        plan = E.sorted_plan(batch.ids, batch.vals, budget, fill=F)
        x = plan.svals                                  # (N,) sorted vals
        ex = plan.sex                                   # (N,) example idx

        # ---- unique-row gather (uids ascending; fill=F is the max id)
        rec_u = E.gather_rows(state.table, plan.uids,
                              indices_are_sorted=True)        # (U, W)
        v_u = rec_u[:, :k]
        w_u = rec_u[:, 2 * k]
        vw_u = jnp.concatenate([v_u, w_u[:, None]], axis=1)   # (U, k+1)

        # ---- expand to sorted slots (monotone gather) + slot terms
        vw_s = vw_u.at[plan.seg].get(
            indices_are_sorted=True, mode="promise_in_bounds")  # (N, k+1)
        v_s = vw_s[:, :k]
        w_s = vw_s[:, k]
        c = v_s * x[:, None]                            # (N, k) v*x
        q = jnp.sum(jnp.square(c), axis=1)              # (N,) sum_k v^2x^2
        lin = w_s * x                                   # (N,)

        # ---- per-example aggregates: [S (k) | Q | Lin]
        slot_feats = jnp.concatenate(
            [c, q[:, None], lin[:, None]], axis=1)      # (N, k+2)
        agg = jnp.zeros((B, k + 2), jnp.float32).at[ex].add(slot_feats)

        weights = (None if batch.mask is None
                   else batch.mask.astype(jnp.float32))
        denom = jnp.maximum(
            jnp.sum(weights) if weights is not None else float(B), 1.0)

        def example_loss(agg_, w0_):
            s = 0.5 * (jnp.sum(jnp.square(agg_[:, :k]), axis=1)
                       - agg_[:, k])
            if cfg.use_linear:
                s = s + agg_[:, k + 1]
            if cfg.use_bias:
                s = s + w0_
            data_loss = loss_fn(s, batch.y, weights)
            total = data_loss + cfg.reg0 * jnp.square(w0_)
            return total, (s, data_loss)

        (g_agg, g_w0), (scores, data_loss) = jax.grad(
            example_loss, argnums=(0, 1), has_aux=True)(agg, state.w0)

        # ---- slot-space backward (hand-written bilinear + analytic reg)
        g_slot = g_agg[ex]                              # (N, k+2) cheap
        active = (x != 0).astype(jnp.float32)
        if weights is not None:
            active = active * weights[ex]
        # dv = gS*x + gQ*2*v*x^2 + 2*reg_v*v*active/denom
        g_v = (g_slot[:, :k] * x[:, None]
               + g_slot[:, k:k + 1] * 2.0 * v_s * jnp.square(x)[:, None]
               + (2.0 * cfg.reg_v / denom) * v_s * active[:, None])
        # dw = gLin*x + 2*reg_w*w*active/denom
        g_w = (g_slot[:, k + 1] * x
               + (2.0 * cfg.reg_w / denom) * w_s * active)

        # ---- per-unique sums over the sorted runs
        packed = jnp.concatenate(
            [g_v, jnp.square(g_v), g_w[:, None],
             jnp.square(g_w)[:, None]], axis=1)         # (N, 2k+2)
        acc = SS.segment_rowsum(packed, plan.seg, budget)
        g_v_u, sq_v_u = acc[:, :k], acc[:, k:2 * k]
        g_w_u, sq_w_u = acc[:, 2 * k], acc[:, 2 * k + 1]

        # ---- fused-record update (identical math to sgd_fused)
        slot_v_u = rec_u[:, k:2 * k]
        slot_w_u = rec_u[:, 2 * k + 1]
        lr = sgd_cfg.learning_rate
        if sgd_cfg.optimizer == "adagrad":
            slot_v_new = slot_v_u + sq_v_u
            v_new = v_u - lr * g_v_u * jax.lax.rsqrt(
                slot_v_new + sgd_cfg.adagrad_eps)
            slot_w_new = slot_w_u + sq_w_u
            w_new = w_u - lr * g_w_u * jax.lax.rsqrt(
                slot_w_new + sgd_cfg.adagrad_eps)
        else:
            slot_v_new, slot_w_new = slot_v_u, slot_w_u
            v_new = v_u - lr * g_v_u
            w_new = w_u - lr * g_w_u

        pad = state.table.shape[1] - (2 * k + 2)
        rec_new = jnp.concatenate(
            [v_new, slot_v_new, w_new[:, None], slot_w_new[:, None],
             jnp.zeros((budget, pad), jnp.float32)], axis=1)

        table = E.write_rows(state.table, plan.uids, rec_new,
                             indices_are_sorted=True)

        if cfg.use_bias:
            # example_loss includes reg0*w0^2, so g_w0 already carries the
            # regularizer — matching _batch_loss_from_rows' autodiff.
            w0, sw0, _ = sgd_solver._dense_scalar_update(
                sgd_cfg.optimizer, lr, sgd_cfg, state.w0, state.slot_w0,
                None, g_w0, state.step)
        else:
            w0, sw0 = state.w0, state.slot_w0

        new_state = FusedState(table=table, w0=w0, slot_w0=sw0,
                               step=state.step + 1)
        return new_state, {"loss": data_loss, "scores": scores,
                           "unique_count": plan.count,
                           "unique_overflow": plan.overflow}

    return jax.jit(train_step, donate_argnums=(0,))
