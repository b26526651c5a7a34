"""Fused-record SGD: all per-feature state in one row.

Every sparse-table touch pays a per-row cost (a dynamic gather or
scatter of one row), nearly independent of row width. The classic layout
(separate w, v, slot_w, slot_v tables) therefore pays that cost 4x per
unique feature. This module fuses them:

    record[f] = [ v[f] (K) | slot_v[f] (K) | w[f] (1) | slot_w[f] (1) | pad ]

one (F+1, W) f32 table with W = 128 * ceil((2K+2)/128). A train step
does ONE unique-row gather and ONE row write-back for the entire
optimizer state. Updates are identical in exact arithmetic to the direct
XLA path for adagrad/sgd (same sum / sum-of-squares accumulation as
solvers/sgd.py's dedup path); adam is not offered here (its slots would
need a wider record — use update_path="dedup").
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from sparkfm_tpu.config import FMConfig, SGDConfig
from sparkfm_tpu.data.batching import SparseBatch
from sparkfm_tpu.models.fm import FMParams
from sparkfm_tpu.ops import embedding as E
from sparkfm_tpu.solvers import sgd as sgd_solver


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FusedState:
    """Fused sparse state + dense scalars. ``table`` rows: see module doc.
    The last row (index F) is the dedup dummy row (garbage by contract)."""

    table: jnp.ndarray          # (F+1, W) f32
    w0: jnp.ndarray
    slot_w0: jnp.ndarray
    step: jnp.ndarray


def v_lanes(cfg: FMConfig) -> int:
    """Width of one row's factor block: K for plain FM, num_fields*K for
    FFM (the flat per-row layout of models/fm.py::FMParams)."""
    return cfg.num_factors * max(1, cfg.num_fields)


def record_width(num_factors: int, num_fields: int = 0) -> int:
    vk = num_factors * max(1, num_fields)
    need = 2 * vk + 2
    return ((need + 127) // 128) * 128


def init_fused_state(cfg: FMConfig,
                     key: Optional[jax.Array] = None) -> FusedState:
    """Same keyed init as the separate-table path, drawn DIRECTLY into
    the record table under one jit: materializing FMParams first costs a
    whole extra padded (F, vk) buffer at peak — at the full Avazu shape
    (2^22 x 176 -> 256 lanes, 4.3 GB, next to the 6.4 GB record table)
    the eager `.at[].set` copies on top of that multiply peak memory."""
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    vk = v_lanes(cfg)
    f = cfg.num_features
    w = record_width(cfg.num_factors, cfg.num_fields)

    if f * vk * 4 <= (1 << 30):
        @jax.jit
        def build(key):
            v = cfg.init_mean + cfg.init_stdev * jax.random.normal(
                key, (f, vk), dtype=jnp.float32)
            # pad v straight into the (F+1, W) record: zeros-table +
            # .at[].set kept both full-size buffers live (2 x 8.6 GB at
            # the 2^24 Criteo shape); pad is one op, peak = v + output
            return jnp.pad(v, ((0, 1), (0, w - vk)))

        table = build(key)
    else:
        # Huge tables (> 1 GiB of draw): even the pad form peaks at
        # table + v + the PRNG bit buffer (~12.8 GB at 2^24 x 32).
        # Initialize per row-chunk
        # into the donated table instead: peak = table + one chunk.
        # Deterministic under the key (fold_in by row offset) but NOT
        # bitwise equal to the small-table single draw — both are
        # "N(mean, stdev) keyed by cfg.seed", which is the documented
        # contract (the reference draws unseeded: FMModel.scala:19-22).
        from functools import partial

        @partial(jax.jit, static_argnames=("n",), donate_argnums=(0,))
        def set_chunk(t, k, off, n):
            v = cfg.init_mean + cfg.init_stdev * jax.random.normal(
                k, (n, vk), dtype=jnp.float32)
            return jax.lax.dynamic_update_slice(
                t, jnp.pad(v, ((0, 0), (0, w - vk))), (off, 0))

        table = jnp.zeros((f + 1, w), jnp.float32)
        ch = max(8, (1 << 28) // (vk * 4))
        off = 0
        while off < f:
            n = min(ch, f - off)
            table = set_chunk(table, jax.random.fold_in(key, off),
                              jnp.int32(off), n)
            off += n

    return FusedState(table=table, w0=jnp.zeros((), jnp.float32),
                      slot_w0=jnp.zeros((), jnp.float32),
                      step=jnp.zeros((), jnp.int32))


def fused_from_params(params: FMParams, cfg: FMConfig) -> FusedState:
    vk = v_lanes(cfg)
    f = cfg.num_features
    w = record_width(cfg.num_factors, cfg.num_fields)

    # One jitted build: eager .at[].set copies the whole record table per
    # call (two 6.4 GB copies at the full Avazu shape).
    @jax.jit
    def build(v, wvec):
        # pad + one column set (see init_fused_state: zeros + two sets
        # kept two full-size record buffers live)
        table = jnp.pad(v.astype(jnp.float32), ((0, 1), (0, w - vk)))
        return table.at[:f, 2 * vk].set(wvec.astype(jnp.float32))

    return FusedState(table=build(params.v, params.w),
                      w0=jnp.asarray(params.w0, jnp.float32),
                      slot_w0=jnp.zeros((), jnp.float32),
                      step=jnp.zeros((), jnp.int32))


def params_from_fused(state: FusedState, cfg: FMConfig) -> FMParams:
    vk = v_lanes(cfg)
    f = cfg.num_features
    return FMParams(w0=state.w0,
                    w=state.table[:f, 2 * vk],
                    v=state.table[:f, :vk])


def make_fused_train_step(cfg: FMConfig, sgd_cfg: SGDConfig,
                          _jit: bool = True):
    """(FusedState, SparseBatch) -> (FusedState, aux).

    Optimizers: "adagrad" (element-wise accumulators), "adagrad_row"
    (DLRM-style row-wise: ONE second-moment scalar per embedding row =
    mean of squared grads over the k lanes, stored at slot lane 0 — the
    packed gradient narrows from 2k+2 to k+3 lanes, which narrows the
    unique-accumulate), or plain "sgd".
    """
    if sgd_cfg.optimizer not in ("adagrad", "adagrad_row", "sgd"):
        raise ValueError("fused path supports adagrad/adagrad_row/sgd; use "
                         "update_path='dedup' for adam/momentum")
    if sgd_cfg.momentum > 0 and sgd_cfg.optimizer == "sgd":
        raise ValueError("fused path: momentum not supported")
    if sgd_cfg.accumulate not in ("auto", "scatter", "segsum"):
        raise ValueError(
            f"unknown accumulate={sgd_cfg.accumulate!r}; expected "
            "'auto', 'scatter' or 'segsum'")
    # One record row = [v-block | slot_v | w | slot_w | pad]. For FFM the
    # v-block is the flat (num_fields*K) per-row layout; everything below
    # is width-agnostic, so FFM rides the same single-gather/single-write
    # step (for adagrad_row, the row-wise second moment then spans the
    # whole flat block — one accumulator per (feature) row, DLRM-style).
    k = v_lanes(cfg)

    def train_step(state: FusedState, batch: SparseBatch):
        F = state.table.shape[0] - 1
        n_slots = batch.ids.shape[0] * batch.ids.shape[1]
        budget = sgd_cfg.unique_budget or E.auto_budget(n_slots)

        if batch.plan is not None:
            plan = batch.plan          # host-computed (ops.embedding.host_dedup)
            budget = plan.uids.shape[0]
        else:
            plan = E.dedup_ids(batch.ids, budget, fill=F)
        valid_u = jax.lax.iota(jnp.int32, budget) < jnp.minimum(
            plan.count, budget)

        # ---- ONE big-table gather for the whole working set
        # (uids ascending with the max-id fill row trailing)
        rec_u = E.gather_rows(state.table, plan.uids,
                              indices_are_sorted=True)        # (U, W)
        rec_u = jnp.where(valid_u[:, None], rec_u, 0.0)
        v_u = rec_u[:, :k]
        slot_v_u = rec_u[:, k:2 * k]
        w_u = rec_u[:, 2 * k]
        slot_w_u = rec_u[:, 2 * k + 1]

        def loss_of(w0, w_rows, v_rows):
            return sgd_solver._batch_loss_from_rows(
                w0, w_rows, v_rows, batch, cfg)

        # ONE per-slot spread for [v | w]: gather cost is per-row, so
        # fusing the two spreads halves the slot-space gather count.
        vw_u = jnp.concatenate([v_u, w_u[:, None]], axis=1)   # (U, k+1)
        vw_rows = E.spread(vw_u, plan)                        # (B, L, k+1)
        v_rows = vw_rows[..., :k]
        w_rows = vw_rows[..., k]
        grads, (scores, data_loss) = jax.grad(
            loss_of, argnums=(0, 1, 2), has_aux=True)(
            state.w0, w_rows, v_rows)
        g_w0, g_wrows, g_vrows = grads

        # ---- reduce per-slot gradients to per-unique-row gradients.
        # "segsum": permute the NARROW pre-square payload [g_v | g_w]
        # (k+1 lanes) into id-sorted order — the plan carries the
        # permutation — square/pack in sorted space, and reduce the
        # contiguous runs with a segment sum. "auto" is the scatter-add.
        if sgd_cfg.accumulate == "segsum" and plan.order is None:
            raise ValueError(
                "accumulate='segsum' requires a plan with the id-sort "
                "permutation (plan.order/plan.seg); both dedup_ids and "
                "host_dedup emit it — this plan was built without it")
        use_segsum = sgd_cfg.accumulate == "segsum"
        gv_s = g_vrows.reshape(-1, k)
        gw_s = g_wrows.reshape(-1, 1)
        if use_segsum and plan.order is not None:
            from sparkfm_tpu.ops import segsum as SS
            gvw = jnp.concatenate([gv_s, gw_s], axis=-1)      # (N, k+1)
            gvw_s = gvw.at[plan.order].get(unique_indices=True,
                                           mode="promise_in_bounds")
            gv_s, gw_s = gvw_s[:, :k], gvw_s[:, k:]

            def reduce_packed(parts):
                return SS.segment_rowsum(
                    jnp.concatenate(parts, axis=-1), plan.seg, budget)
        else:
            flat_ranks = plan.ranks.reshape(-1)

            def reduce_packed(parts):
                packed = jnp.concatenate(parts, axis=-1)      # (N, w)
                return jnp.zeros((budget, packed.shape[-1]),
                                 packed.dtype).at[flat_ranks].add(packed)

        lr = sgd_cfg.learning_rate
        if sgd_cfg.optimizer == "adagrad_row":
            # row-wise second moment: mean of squared grads over k lanes
            acc = reduce_packed(
                [gv_s, jnp.mean(jnp.square(gv_s), axis=-1, keepdims=True),
                 gw_s, jnp.square(gw_s)])                    # (U, k+3)
            g_v_u, sq_row_u = acc[:, :k], acc[:, k]
            g_w_u, sq_w_u = acc[:, k + 1], acc[:, k + 2]
            slot_row_new = slot_v_u[:, 0] + sq_row_u
            v_new = v_u - lr * g_v_u * jax.lax.rsqrt(
                slot_row_new + sgd_cfg.adagrad_eps)[:, None]
            slot_v_new = jnp.concatenate(
                [slot_row_new[:, None],
                 jnp.zeros((budget, k - 1), jnp.float32)], axis=1)
            slot_w_new = slot_w_u + sq_w_u
            w_new = w_u - lr * g_w_u * jax.lax.rsqrt(
                slot_w_new + sgd_cfg.adagrad_eps)
        else:
            acc = reduce_packed(
                [gv_s, jnp.square(gv_s), gw_s,
                 jnp.square(gw_s)])                          # (U, 2k+2)
            g_v_u, sq_v_u = acc[:, :k], acc[:, k:2 * k]
            g_w_u, sq_w_u = acc[:, 2 * k], acc[:, 2 * k + 1]
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

        # ---- ONE big-table write-back; duplicate fill ids only race on
        # the dummy row, whose content is garbage by contract.
        table = E.write_rows(state.table, plan.uids, rec_new,
                             unique_indices=True)

        if cfg.use_bias:
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

    if not _jit:
        return train_step
    return jax.jit(train_step, donate_argnums=(0,))


def make_fused_multi_step(cfg: FMConfig, sgd_cfg: SGDConfig):
    """G fused steps per dispatch via lax.scan over stacked batches —
    the fused-path twin of sgd_hybrid.make_hybrid_multi_step. Update
    math is EXACTLY the single-step sequence (scan is sequential);
    batches must share plan shapes (ladder rung); stack with
    sgd_hybrid.stack_batches. aux carries the last step's loss, the
    group mean, and overflow OR-ed over the group.

    The single step remains the default everywhere; this exists for API
    symmetry with the hybrid path and for dispatch-starved environments
    (e.g. many tiny batches per rung)."""
    raw = make_fused_train_step(cfg, sgd_cfg, _jit=False)

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
