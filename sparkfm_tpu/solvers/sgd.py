"""SGD-family solver with sparse row updates.

The reference ships no SGD at all (SURVEY §2.3: only ALS exists; the libFM
lineage implies SGD and BASELINE config 1 requires it). This is a from-scratch
design, not a port:

  * One jitted train step per batch; no Python in the hot loop.
  * Sparse updates: gradients are taken w.r.t. the *gathered* parameter rows
    (B, L, ...) and scatter-added back into the (F, ...) tables with
    ``.at[ids].add`` — XLA performs an in-place O(nnz) scatter when the state
    is donated, never materializing a dense (F, K) gradient. This replaces
    the reference's driver-side whole-model updates (ALS.scala:34-70).
  * Adagrad (default, the standard FM/CTR optimizer), plain SGD with
    momentum, and Adam — all with row-sparse slot updates.
  * Per-appearance L2 regularization, matching libFM SGD semantics (the
    regularizer is applied to the coordinates an example touches).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from sparkfm_tpu.config import FMConfig, SGDConfig, Task
from sparkfm_tpu.data.batching import SparseBatch
from sparkfm_tpu.models.fm import FMParams
from sparkfm_tpu.ops import interaction as I
from sparkfm_tpu.ops import losses as L


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SGDState:
    """Parameters + per-coordinate optimizer slots + step counter.

    Slot arrays mirror param shapes; for plain SGD with momentum they hold
    velocities, for adagrad squared-grad accumulators, for adam first/second
    moments (m in slot, v in slot2).
    """

    params: FMParams
    slot_w0: jnp.ndarray
    slot_w: jnp.ndarray
    slot_v: jnp.ndarray
    slot2_w0: jnp.ndarray
    slot2_w: jnp.ndarray
    slot2_v: jnp.ndarray
    step: jnp.ndarray


def init_state(params: FMParams, optimizer: str = None) -> SGDState:
    """Fresh optimizer state. With ``optimizer`` given and != "adam",
    the second-moment slots are SCALAR placeholders instead of full
    table-sized buffers — adam is the only consumer, and a dead slot2_v
    costs a whole table of device memory (a (2^22, 176) flat FFM table
    is ~2.9 GB). None (the default) keeps full slots for backward
    compatibility with callers that restore arbitrary checkpoints."""
    z = lambda x: jnp.zeros_like(x)
    lean = optimizer is not None and optimizer != "adam"
    s2 = (lambda x: jnp.zeros((), x.dtype)) if lean else z
    return SGDState(params=params,
                    slot_w0=z(params.w0), slot_w=z(params.w), slot_v=z(params.v),
                    slot2_w0=z(params.w0), slot2_w=s2(params.w),
                    slot2_v=s2(params.v),
                    step=jnp.zeros((), jnp.int32))


def _batch_loss_from_rows(w0, w_rows, v_rows, batch: SparseBatch,
                          cfg: FMConfig):
    """Mean loss over valid examples, as a function of gathered rows."""
    if cfg.num_fields > 0:
        s = I.ffm_scores_from_gathered(
            w0, w_rows, v_rows, batch.vals, batch.field_ids, cfg.num_fields,
            use_bias=cfg.use_bias, use_linear=cfg.use_linear,
            compute_dtype=jnp.dtype(cfg.compute_dtype),
            slot_major=cfg.slot_major_fields)
    else:
        s = I.fm_scores_from_gathered(
            w0, w_rows, v_rows, batch.vals,
            use_bias=cfg.use_bias, use_linear=cfg.use_linear,
            compute_dtype=jnp.dtype(cfg.compute_dtype))
    loss_fn = L.loss_for_task(cfg.task)
    weights = None if batch.mask is None else batch.mask.astype(jnp.float32)
    data_loss = loss_fn(s, batch.y, weights)

    # Per-appearance L2 (libFM SGD semantics): each active slot regularizes
    # its row; padded slots (val == 0) excluded. With attribute groups
    # (cfg.feature_groups, the reference's Metadata capability) the
    # strengths are per-slot gathers of the per-group lambdas.
    active = (batch.vals != 0).astype(jnp.float32)
    if batch.mask is not None:
        active = active * batch.mask[:, None].astype(jnp.float32)
    denom = jnp.maximum(
        jnp.sum(batch.mask.astype(jnp.float32)) if batch.mask is not None
        else float(batch.vals.shape[0]), 1.0)
    if cfg.feature_groups is not None:
        rw_vec, rv_vec = cfg.reg_vectors()
        rw = jnp.asarray(rw_vec)[batch.ids]          # (B, L)
        rv = jnp.asarray(rv_vec)[batch.ids]          # (B, L)
    else:
        rw = cfg.reg_w
        rv = cfg.reg_v
    reg = (cfg.reg0 * jnp.square(w0)
           + jnp.sum(rw * jnp.square(w_rows) * active) / denom)
    if cfg.num_fields > 0:
        reg = reg + jnp.sum(
            (rv * active)[..., None] * jnp.square(v_rows)) / denom
    else:
        reg = reg + jnp.sum(
            (rv * active)[..., None] * jnp.square(v_rows)) / denom
    return data_loss + reg, (s, data_loss)


def _row_update(opt: str, lr: float, sgd_cfg: SGDConfig,
                table, slot, slot2, ids_flat, g_rows, step):
    """Apply one sparse optimizer update to `table` at `ids_flat`.

    Scatter-adds squared grads into the slot first, then re-gathers so
    duplicate ids inside a batch see the combined accumulator (standard
    sparse-adagrad practice).
    """
    _check_row_optimizer(opt)
    if opt == "adagrad":
        slot = slot.at[ids_flat].add(jnp.square(g_rows))
        scale = jax.lax.rsqrt(slot[ids_flat] + sgd_cfg.adagrad_eps)
        table = table.at[ids_flat].add(-lr * g_rows * scale)
    elif opt == "adam":
        b1, b2, eps = 0.9, 0.999, 1e-8
        # Row-sparse adam: moments decay only on touched rows ("lazy adam").
        m_rows = b1 * slot[ids_flat] + (1 - b1) * g_rows
        v_rows = b2 * slot2[ids_flat] + (1 - b2) * jnp.square(g_rows)
        slot = slot.at[ids_flat].set(m_rows)
        slot2 = slot2.at[ids_flat].set(v_rows)
        t = step.astype(jnp.float32) + 1.0
        mhat = m_rows / (1 - b1 ** t)
        vhat = v_rows / (1 - b2 ** t)
        table = table.at[ids_flat].add(-lr * mhat / (jnp.sqrt(vhat) + eps))
    else:  # plain sgd (+ momentum)
        if sgd_cfg.momentum > 0:
            vel = sgd_cfg.momentum * slot[ids_flat] + g_rows
            slot = slot.at[ids_flat].set(vel)
            table = table.at[ids_flat].add(-lr * vel)
        else:
            table = table.at[ids_flat].add(-lr * g_rows)
    return table, slot, slot2


_ROW_OPTIMIZERS = ("adagrad", "adam", "sgd")


def _check_row_optimizer(opt: str) -> None:
    """The per-element row paths support adagrad/adam/sgd only. adagrad_row
    (DLRM-style row-wise accumulator) exists ONLY on the fused-record path
    (solvers/sgd_fused.py) — silently degrading it to plain SGD here would
    train with un-normalized steps, so reject loudly (VERDICT r1 item 4)."""
    if opt not in _ROW_OPTIMIZERS:
        hint = (" (adagrad_row requires update_path='fused'/'sorted'; see "
                "solvers/sgd_fused.py)") if opt == "adagrad_row" else ""
        raise ValueError(f"unsupported optimizer {opt!r} for this update "
                         f"path; expected one of {_ROW_OPTIMIZERS}{hint}")


def _dense_scalar_update(opt: str, lr: float, sgd_cfg: SGDConfig,
                         x, slot, slot2, g, step):
    if opt == "adagrad_row":
        # A scalar is a width-1 row: row-wise and element-wise adagrad
        # coincide, so the dense bias under adagrad_row gets true adagrad
        # (previously this silently fell through to plain SGD).
        opt = "adagrad"
    elif opt not in _ROW_OPTIMIZERS:
        raise ValueError(f"unsupported optimizer {opt!r}")
    if opt == "adagrad":
        slot = slot + jnp.square(g)
        x = x - lr * g * jax.lax.rsqrt(slot + sgd_cfg.adagrad_eps)
    elif opt == "adam":
        b1, b2, eps = 0.9, 0.999, 1e-8
        slot = b1 * slot + (1 - b1) * g
        slot2 = b2 * slot2 + (1 - b2) * jnp.square(g)
        t = step.astype(jnp.float32) + 1.0
        x = x - lr * (slot / (1 - b1 ** t)) / (
            jnp.sqrt(slot2 / (1 - b2 ** t)) + eps)
    else:
        if sgd_cfg.momentum > 0:
            slot = sgd_cfg.momentum * slot + g
            x = x - lr * slot
        else:
            x = x - lr * g
    return x, slot, slot2


def _hybrid_eligible(cfg: FMConfig, sgd_cfg: SGDConfig) -> bool:
    """make_hybrid_train_step's static requirements (sgd_hybrid.py:59-70)
    plus host plans (the sorted backward consumes plan.svals/sex, which
    only the host input pipeline emits)."""
    return (sgd_cfg.host_plan
            and cfg.num_fields == 0
            and sgd_cfg.optimizer in ("adagrad", "adagrad_row", "sgd")
            and sgd_cfg.momentum == 0
            and jnp.dtype(cfg.compute_dtype) == jnp.float32
            and cfg.feature_groups is None)


def resolve_update_path(cfg: FMConfig, sgd_cfg: SGDConfig) -> str:
    """auto policy: small tables -> direct XLA; big tables -> hybrid
    (natural-order forward + analytic id-sorted backward;
    solvers/sgd_hybrid.py) when host plans and the model/optimizer fit
    its restrictions, else fused-record (one gather + one write per
    unique id; solvers/sgd_fused.py), else dedup."""
    if sgd_cfg.update_path != "auto":
        return sgd_cfg.update_path
    if sgd_cfg.optimizer == "adagrad_row":
        # adagrad_row exists only on the fused-record layout; route there
        # regardless of table size (make_fused_train_step validates the rest).
        return "hybrid" if _hybrid_eligible(cfg, sgd_cfg) else "fused"
    if cfg.num_features < (1 << 16):
        return "direct"
    if _hybrid_eligible(cfg, sgd_cfg):
        return "hybrid"
    # Fused covers FFM: one fused-record write replaces the dedup path's
    # four table scatters.
    if (sgd_cfg.optimizer in ("adagrad", "adagrad_row", "sgd")
            and sgd_cfg.momentum == 0):
        return "fused"
    return "dedup"


def pad_state_for_dedup(state: SGDState) -> SGDState:
    """Append one dummy row to every table (the dedup fill row; its contents
    are garbage by design — overflow/unused-budget traffic lands there).
    Scalar slot2 placeholders (lean non-adam states) pass through."""
    pad = lambda x: (jnp.concatenate(
        [x, jnp.zeros((1,) + x.shape[1:], x.dtype)], axis=0)
        if x.ndim else x)
    return SGDState(
        params=FMParams(w0=state.params.w0, w=pad(state.params.w),
                        v=pad(state.params.v)),
        slot_w0=state.slot_w0, slot_w=pad(state.slot_w),
        slot_v=pad(state.slot_v),
        slot2_w0=state.slot2_w0, slot2_w=pad(state.slot2_w),
        slot2_v=pad(state.slot2_v), step=state.step)


def trim_params(params: FMParams, num_features: int) -> FMParams:
    """Drop the dedup dummy row if present."""
    if params.w.shape[0] == num_features + 1:
        return FMParams(w0=params.w0, w=params.w[:num_features],
                        v=params.v[:num_features])
    return params


def make_train_step(cfg: FMConfig, sgd_cfg: SGDConfig):
    """Build the jitted sparse train step: (state, batch) -> (state, aux).

    Two table-access paths (resolve_update_path): "direct" XLA
    gather/scatter, or "dedup" (sort + unique-compact; see ops/embedding.py
    for the rationale). The dedup path requires the state to be
    padded with pad_state_for_dedup first. Both paths produce identical
    adagrad updates (tested to ~1e-6 in tests/test_dedup.py).
    """
    path = resolve_update_path(cfg, sgd_cfg)
    if path == "dedup":
        return _make_dedup_train_step(cfg, sgd_cfg)
    if path in ("fused", "sorted", "hybrid"):
        raise ValueError(
            f"resolved update path is '{path}', which uses a FusedState — "
            "build it with sparkfm_tpu.solvers.sgd_fused / sgd_sorted / "
            "sgd_hybrid instead (the trainer does this automatically)")

    def train_step(state: SGDState, batch: SparseBatch):
        p = state.params
        ids = batch.ids
        B, Lq = ids.shape
        ids_flat = ids.reshape(-1)

        w_rows = p.w[ids]
        v_rows = p.v[ids]

        def loss_of(w0, w_rows, v_rows):
            return _batch_loss_from_rows(w0, w_rows, v_rows, batch, cfg)

        grads, (scores, data_loss) = jax.grad(
            loss_of, argnums=(0, 1, 2), has_aux=True)(p.w0, w_rows, v_rows)
        g_w0, g_wrows, g_vrows = grads

        lr = sgd_cfg.learning_rate
        opt = sgd_cfg.optimizer

        w, sw, s2w = _row_update(
            opt, lr, sgd_cfg, p.w, state.slot_w, state.slot2_w,
            ids_flat, g_wrows.reshape(-1), state.step)
        # v rows are (K,) plain / (num_fields*K,) flat FFM — same rank
        gv = g_vrows.reshape(B * Lq, -1)
        v, sv, s2v = _row_update(
            opt, lr, sgd_cfg, p.v, state.slot_v, state.slot2_v,
            ids_flat, gv, state.step)
        if cfg.use_bias:
            w0, sw0, s2w0 = _dense_scalar_update(
                opt, lr, sgd_cfg, p.w0, state.slot_w0, state.slot2_w0,
                g_w0, state.step)
        else:
            w0, sw0, s2w0 = p.w0, state.slot_w0, state.slot2_w0

        new_state = SGDState(
            params=FMParams(w0=w0, w=w, v=v),
            slot_w0=sw0, slot_w=sw, slot_v=sv,
            slot2_w0=s2w0, slot2_w=s2w, slot2_v=s2v,
            step=state.step + 1)
        return new_state, {"loss": data_loss, "scores": scores}

    return jax.jit(train_step, donate_argnums=(0,))


def _make_dedup_train_step(cfg: FMConfig, sgd_cfg: SGDConfig):
    """Dedup-path train step (see ops/embedding.py).

    Exact-parity notes: the adagrad accumulator receives the per-slot
    *squared* grads summed per unique row (sum of squares, matching the
    direct path's duplicate-accumulating scatter), then every duplicate's
    update uses the same post-accumulation slot — identical math, one
    big-table touch per unique row instead of per slot.
    """
    from sparkfm_tpu.ops import embedding as E

    ffm = cfg.num_fields > 0

    def train_step(state: SGDState, batch: SparseBatch):
        p = state.params
        F = p.w.shape[0] - 1               # padded: last row is the dummy
        n_slots = batch.ids.shape[0] * batch.ids.shape[1]
        budget = sgd_cfg.unique_budget or E.auto_budget(n_slots)

        if batch.plan is not None:
            plan = batch.plan          # host-computed (ops.embedding.host_dedup)
            budget = plan.uids.shape[0]
        else:
            plan = E.dedup_ids(batch.ids, budget, fill=F)
        valid_u = jax.lax.iota(jnp.int32, budget) < jnp.minimum(
            plan.count, budget)

        w_u = jnp.where(valid_u, p.w[plan.uids], 0.0)
        v_u = p.v[plan.uids]
        v_u = jnp.where(valid_u.reshape((-1,) + (1,) * (v_u.ndim - 1)),
                        v_u, 0.0)

        def loss_of(w0, w_rows, v_rows):
            return _batch_loss_from_rows(w0, w_rows, v_rows, batch, cfg)

        # ONE per-slot spread for [v | w] (per-row gather cost is width-
        # independent, so fusing the two spreads halves the slot bill).
        v_flat_u = v_u.reshape(v_u.shape[0], -1)
        vw_u = jnp.concatenate([v_flat_u, w_u[:, None]], axis=1)
        vw_rows = E.spread(vw_u, plan)            # (B, L, kflat+1)
        v_rows = vw_rows[..., :-1].reshape(
            batch.ids.shape + v_u.shape[1:])
        w_rows = vw_rows[..., -1]
        grads, (scores, data_loss) = jax.grad(
            loss_of, argnums=(0, 1, 2), has_aux=True)(p.w0, w_rows, v_rows)
        g_w0, g_wrows, g_vrows = grads

        # per-unique sums of grads and squared grads (small scatters)
        g_w_u = E.accumulate_to_unique(g_wrows, plan, budget)
        g_v_u = E.accumulate_to_unique(g_vrows, plan, budget)
        sq_w_u = E.accumulate_to_unique(jnp.square(g_wrows), plan, budget)
        sq_v_u = E.accumulate_to_unique(jnp.square(g_vrows), plan, budget)

        lr, opt = sgd_cfg.learning_rate, sgd_cfg.optimizer

        def unique_update(table, slot, slot2, g_u, sq_u):
            _check_row_optimizer(opt)
            t_u = table[plan.uids]
            s_u = slot[plan.uids]
            # slot2 may be a scalar placeholder (lean non-adam state)
            s2_u = slot2[plan.uids] if opt == "adam" else None
            if opt == "adagrad":
                s_u = s_u + sq_u
                t_u = t_u - lr * g_u * jax.lax.rsqrt(
                    s_u + sgd_cfg.adagrad_eps)
            elif opt == "adam":
                b1, b2, eps = 0.9, 0.999, 1e-8
                s_u = b1 * s_u + (1 - b1) * g_u
                s2_u = b2 * s2_u + (1 - b2) * jnp.square(g_u)
                t = state.step.astype(jnp.float32) + 1.0
                t_u = t_u - lr * (s_u / (1 - b1 ** t)) / (
                    jnp.sqrt(s2_u / (1 - b2 ** t)) + eps)
            else:
                if sgd_cfg.momentum > 0:
                    s_u = sgd_cfg.momentum * s_u + g_u
                    t_u = t_u - lr * s_u
                else:
                    t_u = t_u - lr * g_u
            # unique hint: duplicate fill ids only race on the dummy row
            # (garbage by contract; ops/embedding.write_rows).
            table = E.write_rows(table, plan.uids, t_u, unique_indices=True)
            slot = E.write_rows(slot, plan.uids, s_u, unique_indices=True)
            if opt == "adam":
                slot2 = E.write_rows(slot2, plan.uids, s2_u,
                                     unique_indices=True)
            return table, slot, slot2

        w, sw, s2w = unique_update(p.w, state.slot_w, state.slot2_w,
                                   g_w_u, sq_w_u)
        v, sv, s2v = unique_update(p.v, state.slot_v, state.slot2_v,
                                   g_v_u, sq_v_u)

        if cfg.use_bias:
            w0, sw0, s2w0 = _dense_scalar_update(
                opt, lr, sgd_cfg, p.w0, state.slot_w0, state.slot2_w0,
                g_w0, state.step)
        else:
            w0, sw0, s2w0 = p.w0, state.slot_w0, state.slot2_w0

        new_state = SGDState(
            params=FMParams(w0=w0, w=w, v=v),
            slot_w0=sw0, slot_w=sw, slot_v=sv,
            slot2_w0=s2w0, slot2_w=s2w, slot2_v=s2v,
            step=state.step + 1)
        return new_state, {"loss": data_loss, "scores": scores,
                           "unique_count": plan.count,
                           "unique_overflow": plan.overflow}

    return jax.jit(train_step, donate_argnums=(0,))
