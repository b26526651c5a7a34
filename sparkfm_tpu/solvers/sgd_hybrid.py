"""Hybrid SGD step: natural-order forward, sorted-order analytic backward.

The fused step (solvers/sgd_fused.py) produces per-slot gradients in
natural slot order and then has to move them to per-unique-row sums:
either a scatter-add into the (U, W) accumulator or a permute into
id-sorted order followed by a segment sum. This step never produces them
in natural order. The FM gradient has a closed form in terms of
per-example quantities:

    dL/dv[b,l,f] = ds_b * x_bl * (s_bf - v[b,l,f] * x_bl)
    dL/dw[b,l]   = ds_b * x_bl
    (+ per-appearance L2 terms)

so after the natural-order forward computes s (B, K) and the loss
derivative ds (B,), the backward evaluates those formulas DIRECTLY IN
ID-SORTED SLOT ORDER from three gathers:

    v_sorted  = vw_u[plan.seg]          sorted-indices gather
    ex rows   = [s | ds | wt][plan.sex] random gather, B rows
    x_sorted  = plan.svals              free (host plan carries it)

and reduces contiguous runs with a segment sum
(ops/segsum.py::fm_grad_segsum_factored) — no permute of slot gradients.
Update math (adagrad / adagrad_row / sgd on the fused record layout) is
identical to make_fused_train_step up to float summation order; parity is
tested in tests/test_sgd_hybrid.py against the jax.grad-based fused step.

Requires a host plan carrying order/seg/svals/sex (the input pipeline
emits them: data/batching.py::batch_iterator with dedup_budget); a device
plan would have to permute the slot values on device first.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sparkfm_tpu.config import FMConfig, SGDConfig, Task
from sparkfm_tpu.data.batching import SparseBatch
from sparkfm_tpu.ops import embedding as E
from sparkfm_tpu.ops import segsum as SS
from sparkfm_tpu.solvers import sgd as sgd_solver
from sparkfm_tpu.solvers.sgd_fused import FusedState


def make_hybrid_train_step(cfg: FMConfig, sgd_cfg: SGDConfig,
                           _jit: bool = True):
    """(FusedState, SparseBatch) -> (FusedState, aux). See module doc.

    _jit=False returns the raw traceable step (make_hybrid_multi_step
    wraps it in a lax.scan).
    """
    if cfg.num_fields > 0:
        raise ValueError("hybrid path supports plain FM (use dedup for FFM)")
    if sgd_cfg.optimizer not in ("adagrad", "adagrad_row", "sgd"):
        raise ValueError("hybrid path supports adagrad/adagrad_row/sgd")
    if sgd_cfg.momentum > 0:
        raise ValueError("hybrid path: momentum not supported")
    if jnp.dtype(cfg.compute_dtype) != jnp.float32:
        raise ValueError("hybrid path computes in float32")
    if cfg.feature_groups is not None:
        raise ValueError("hybrid path does not support attribute-group "
                         "regularization yet; use update_path='fused' or "
                         "'dedup' (their loss gathers per-group lambdas)")
    k = cfg.num_factors
    classification = cfg.task == Task.CLASSIFICATION

    def train_step(state: FusedState, batch: SparseBatch):
        plan = batch.plan
        if plan is None or plan.svals is None or plan.sex is None:
            raise ValueError(
                "hybrid step requires a host dedup plan with svals/sex "
                "(batch_iterator(..., dedup_budget=...) emits it)")
        budget = plan.uids.shape[0]
        n = plan.order.shape[0]
        valid_u = jax.lax.iota(jnp.int32, budget) < jnp.minimum(
            plan.count, budget)

        # ---- ONE big-table gather for the whole working set
        rec_u = E.gather_rows(state.table, plan.uids,
                              indices_are_sorted=True)        # (U, W)
        rec_u = jnp.where(valid_u[:, None], rec_u, 0.0)
        v_u = rec_u[:, :k]
        slot_v_u = rec_u[:, k:2 * k]
        w_u = rec_u[:, 2 * k]
        slot_w_u = rec_u[:, 2 * k + 1]
        vw_u = jnp.concatenate([v_u, w_u[:, None]], axis=1)   # (U, k+1)

        # ---- natural-order forward (manual; we need s and ds anyway)
        vals = batch.vals
        vw_rows = vw_u[plan.ranks]                            # (B, L, k+1)
        vx = vw_rows[..., :k] * vals[..., None]               # (B, L, k)
        s = jnp.sum(vx, axis=1)                               # (B, k)
        ssq = jnp.sum(jnp.square(vx), axis=(1, 2))            # (B,)
        score = 0.5 * (jnp.sum(jnp.square(s), axis=-1) - ssq)
        if cfg.use_linear:
            score = score + jnp.sum(vw_rows[..., k] * vals, axis=-1)
        if cfg.use_bias:
            score = score + state.w0

        wt = (batch.mask.astype(jnp.float32) if batch.mask is not None
              else jnp.ones_like(batch.y))
        # loss_fn normalizers (ops/losses.py): data term sums/max(Σwt,1e-12)
        denom_data = jnp.maximum(jnp.sum(wt), 1e-12)
        # per-appearance reg normalizer (solvers/sgd.py): max(Σwt, 1)
        denom_reg = jnp.maximum(jnp.sum(wt), 1.0)
        if classification:
            y_pm = jnp.where(batch.y > 0, 1.0, -1.0)
            z = -y_pm * score
            data_loss = jnp.sum(jax.nn.softplus(z) * wt) / denom_data
            ds = -y_pm * jax.nn.sigmoid(z) * wt / denom_data  # (B,)
        else:
            err = score - batch.y
            data_loss = jnp.sum(jnp.square(err) * wt) / denom_data
            ds = 2.0 * err * wt / denom_data

        # ---- sorted-order analytic backward: the gradient formula and
        # the [Σg | Σg²] reduce over id-sorted runs
        # (ops/segsum.py::fm_grad_segsum_factored).
        ex_pack = jnp.concatenate(
            [s, ds[:, None], wt[:, None]], axis=1)            # (B, k+2)
        ex_srt = ex_pack[plan.sex]                            # (N, k+2)
        x = plan.svals                                        # (N,)
        acc = SS.fm_grad_segsum_factored(
            vw_u, ex_srt, x, plan.seg, budget,
            2.0 * cfg.reg_v / denom_reg, 2.0 * cfg.reg_w / denom_reg)
        g_v_u, g_w_u = acc[:, :k], acc[:, k]
        sq_v_u, sq_w_u = acc[:, k + 1:2 * k + 1], acc[:, 2 * k + 1]
        if not cfg.use_linear:
            g_w_u = jnp.zeros_like(g_w_u)
            sq_w_u = jnp.zeros_like(sq_w_u)

        # ---- update (identical formulas to make_fused_train_step)
        lr = sgd_cfg.learning_rate
        if sgd_cfg.optimizer == "adagrad_row":
            sq_row_u = jnp.mean(sq_v_u, axis=-1)
            slot_row_new = slot_v_u[:, 0] + sq_row_u
            v_new = v_u - lr * g_v_u * jax.lax.rsqrt(
                slot_row_new + sgd_cfg.adagrad_eps)[:, None]
            slot_v_new = jnp.concatenate(
                [slot_row_new[:, None],
                 jnp.zeros((budget, k - 1), jnp.float32)], axis=1)
            slot_w_new = slot_w_u + sq_w_u
            w_new = w_u - lr * g_w_u * jax.lax.rsqrt(
                slot_w_new + sgd_cfg.adagrad_eps)
        elif sgd_cfg.optimizer == "adagrad":
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
                             unique_indices=True)

        if cfg.use_bias:
            g_w0 = jnp.sum(ds) + 2.0 * cfg.reg0 * state.w0
            w0, sw0, _ = sgd_solver._dense_scalar_update(
                sgd_cfg.optimizer, lr, sgd_cfg, state.w0, state.slot_w0,
                None, g_w0, state.step)
        else:
            w0, sw0 = state.w0, state.slot_w0

        new_state = FusedState(table=table, w0=w0, slot_w0=sw0,
                               step=state.step + 1)
        return new_state, {"loss": data_loss, "scores": score,
                           "unique_count": plan.count,
                           "unique_overflow": plan.overflow}

    if not _jit:
        return train_step
    return jax.jit(train_step, donate_argnums=(0,))


def stack_batches(batches):
    """Stack G same-shape SparseBatches into one (G, ...)-leading pytree
    for :func:`make_hybrid_multi_step` (ladder plans share a rung within
    an iterator, so shapes match)."""
    import jax.tree_util as jtu
    return jtu.tree_map(lambda *xs: jnp.stack(xs), *batches)


def make_hybrid_multi_step(cfg: FMConfig, sgd_cfg: SGDConfig,
                           group: int = 0):
    """G hybrid steps per dispatch via lax.scan over stacked batches.

    Why: each jitted dispatch carries a fixed launch/donation overhead
    that the single-step loop pays per batch. Scanning G staged batches
    amortizes it to 1/G while keeping update math EXACTLY the
    single-step sequence (scan is sequential; the table dependency
    chains through).

    aux is the LAST step's aux plus "unique_overflow" OR-ed over the
    group (an overflow anywhere must surface). `group` is documentary —
    scan takes its length from the stacked leading dim, so one built
    multi-step serves any group size (each size compiles once).
    """
    del group
    raw = make_hybrid_train_step(cfg, sgd_cfg, _jit=False)

    def multi(state: FusedState, stacked: SparseBatch):
        def body(s, b):
            s2, aux = raw(s, b)
            return s2, {"loss": aux["loss"],
                        "unique_overflow": aux["unique_overflow"]}
        state, auxs = jax.lax.scan(body, state, stacked)
        return state, {
            "loss": auxs["loss"][-1],
            "loss_mean": jnp.mean(auxs["loss"]),
            "unique_overflow": jnp.any(auxs["unique_overflow"])}

    return jax.jit(multi, donate_argnums=(0,))
