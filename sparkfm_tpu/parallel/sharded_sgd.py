"""Sharded SGD: data-parallel examples x row-sharded parameter tables.

The replacement for the reference's "replicate the model in a
closure, collect everything to the driver" distribution model (SURVEY §2.7;
reference ALS.scala:34 pulls the entire transposed dataset to the driver and
FMModel lives whole on its heap). Here:

  * The w/V tables are row-sharded over the `model` mesh axis
    (feature f lives on shard f // rows_per_shard) — no chip holds the full
    table; a 2^24-bucket Criteo table (BASELINE config 3) spreads evenly.
  * The batch is sharded over the `data` mesh axis.

Three exchange strategies (``make_sharded_train_step(..., exchange=...)``):

  * ``"unique"`` (default for adagrad/sgd) — the SURVEY §2.7 centerpiece.
    Each data shard dedups its batch ids (host plan or on-device sorts,
    ops/embedding.py), then:
      forward:  ONE psum over `model` of the masked (U, K+1) UNIQUE rows —
                comm scales with the unique count U, not B·L slots (a
                ~L·dedup-ratio reduction: 16x at Criteo shapes); slots are
                spread locally from the U-row matrix.
      backward: per-slot grads reduce LOCALLY to per-unique [Σg | Σg²]
                (the same sum/sum-of-squares the single-chip dedup path
                accumulates), then ONE all_gather over `data` of the packed
                (U, 2K+2) unique grads + uids; each model shard masks to
                the rows it owns and scatter-adds — comm again scales with
                U, and the local scatter touches D·U rows, not B·L.
    Update math is identical to the single-chip direct/dedup paths in exact
    arithmetic (the adagrad accumulator sees the same Σg² and every
    duplicate sees the post-accumulation slot); only float summation order
    differs (tested to tight tolerance on the 8-device CPU mesh).
  * ``"global"`` — the pod-scale refinement of "unique" (round 3): ONE
    host dedup plan covers the whole global batch, so every data shard's
    per-unique sums live in the SAME (U_g, 2K+2) rank space and the
    backward all_gather (comm D·U·W per chip — the scaling wall the
    round-2 review flagged) collapses to ONE psum (ring comm ~2·U_g·W,
    independent of D; U_g grows sublinearly in global batch under
    power-law ids). The trainer uses this whenever host plans are on.
    With per-shard sorted extras in the plan (stack_hybrid_extras), the
    local reduce is the single-chip hybrid step's analytic sorted
    backward (ops/segsum.py::fm_grad_segsum) instead of jax.grad + a
    (B/D)·L-slot scatter-add (auto for plain-FM f32 adagrad/sgd).
  * ``"dense"`` — the simple masked-psum of full slot-row tensors +
    all_gather of slot grads. Comm scales with B·L. Kept for adam/momentum
    (their slot updates don't decompose into cross-shard adds) and as the
    oracle in parity tests.

Feature-popularity SKEW (SURVEY §7's "hard part": power-law CTR ids
concentrating traffic on a few model shards; classic DLRM systems add
hot-row replication for it) is neutralized by design rather than by a
replication mechanism: a hot id appears ONCE in a dedup plan no matter
how many slots reference it, so the unique exchange's comm and the
owner shard's write amplification scale with the UNIQUE set, and the
global exchange goes further — its psum comm (~2*U_g*W, ring) is
identical on every shard regardless of which shard owns the hot rows,
and the per-unique sums each shard contributes are add-combined, which
IS the replicated-accumulator pattern hot-row replication builds by
hand. The residual imbalance (hot rows' owner does their optimizer
update) is one (U, W) row per hot id per step — bounded by U, not by
popularity.

The loss is globally exact in both: per-shard weighted sums are
`psum`-combined and normalized by the global valid-example count.
Everything is one `shard_map`-wrapped jitted step; XLA lowers
psum/all_gather to ICI collectives on a real slice.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkfm_tpu.config import FMConfig, SGDConfig, Task
from sparkfm_tpu.data.batching import SparseBatch
from sparkfm_tpu.models.fm import FMParams
from sparkfm_tpu.ops import interaction as I
from sparkfm_tpu.ops import losses as L
from sparkfm_tpu.parallel import mesh as M
from sparkfm_tpu.solvers import sgd as sgd_solver
from sparkfm_tpu.solvers.sgd import SGDState


def init_sharded_state(cfg: FMConfig, mesh: Mesh,
                       key: jax.Array | None = None) -> tuple:
    """Initialize an SGDState with tables row-sharded over `model`.

    Pads num_features + 1 up to a multiple of the model-axis size: padding
    rows are never referenced by any example, so they stay at init — the
    same "empty column" semantics the ALS guard gives (reference
    ALS.scala:39) — and the +1 guarantees at least one padding row, which
    the unique exchange uses as the dedup fill/dummy row
    (id = padded_features - 1, owned by the last model shard; it only ever
    receives exact-zero gradient adds).

    Returns (state, padded_cfg).
    """
    from sparkfm_tpu.models import fm as fm_model
    msize = mesh.shape[M.MODEL_AXIS]
    f_pad = M.pad_to_multiple(cfg.num_features + 1, msize)
    pcfg = cfg.replace(num_features=f_pad)
    if cfg.feature_groups is not None:
        # Pad feature_groups alongside num_features: padding rows (incl. the
        # dedup dummy row) go to a dedicated extra group with ZERO reg, so
        # cfg.reg_vectors() stays consistent under the padded config and the
        # dummy slot never contributes a regularization pull.
        g_pad = cfg.num_groups
        groups = tuple(cfg.feature_groups) + (
            (g_pad,) * (f_pad - cfg.num_features))

        def _extend(per_group, scalar):
            base = (tuple(float(x) for x in per_group)
                    if per_group is not None
                    else (float(scalar),) * g_pad)
            return base + (0.0,)

        pcfg = pcfg.replace(
            feature_groups=groups,
            group_reg_w=_extend(cfg.group_reg_w, cfg.reg_w),
            group_reg_v=_extend(cfg.group_reg_v, cfg.reg_v))
    params = fm_model.init_params(pcfg, key)
    state = sgd_solver.init_state(params)
    pspecs = M.state_pspecs(ffm=cfg.num_fields > 0)
    state = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, pspecs)
    return state, pcfg


def _gather_rows(table, ids, axis_name):
    """Gather table rows for global `ids` from a row-sharded table.

    table: (F/M, ...) local shard; ids: (..., ) global int32.
    Masked local lookup + psum over the model axis = exact gather.
    """
    rows_per_shard = table.shape[0]
    m_idx = jax.lax.axis_index(axis_name)
    owner = ids // rows_per_shard
    lid = ids - owner * rows_per_shard
    mine = owner == m_idx
    lid_safe = jnp.where(mine, lid, 0)
    rows = table[lid_safe]
    mask = mine.reshape(mine.shape + (1,) * (rows.ndim - mine.ndim))
    rows = jnp.where(mask, rows, 0)
    return jax.lax.psum(rows, axis_name)


def _own_mask_and_lid(ids, rows_per_shard, axis_name):
    m_idx = jax.lax.axis_index(axis_name)
    owner = ids // rows_per_shard
    lid = ids - owner * rows_per_shard
    mine = owner == m_idx
    return mine, jnp.where(mine, lid, 0)


def _loss_sums_from_rows(w0, w_rows, v_rows, batch: SparseBatch,
                         cfg: FMConfig):
    """(sum data loss, sum reg, valid count) over the local batch shard.

    Sum (not mean) form so that psum over `data` + one global normalizer
    yields the exact global objective regardless of per-shard valid counts.
    """
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
    if batch.mask is not None:
        wts = batch.mask.astype(jnp.float32)
    else:
        wts = jnp.ones_like(batch.y)
    if cfg.task == Task.REGRESSION:
        per_ex = jnp.square(s - batch.y)
    else:
        y_pm = jnp.where(batch.y > 0, 1.0, -1.0)
        per_ex = jax.nn.softplus(-y_pm * s)
    data_sum = jnp.sum(per_ex * wts)
    count = jnp.sum(wts)

    active = (batch.vals != 0).astype(jnp.float32) * wts[:, None]
    if cfg.feature_groups is not None:
        rw_vec, rv_vec = cfg.reg_vectors()
        rw = jnp.asarray(rw_vec)[batch.ids]
        rv = jnp.asarray(rv_vec)[batch.ids]
    else:
        rw, rv = cfg.reg_w, cfg.reg_v
    reg_sum = (cfg.reg0 * jnp.square(w0) * count
               + jnp.sum(rw * jnp.square(w_rows) * active))
    # v_rows are (B, L, K) plain / (B, L, nf*K) flat FFM — same rank
    reg_sum = reg_sum + jnp.sum(
        (rv * active)[..., None] * jnp.square(v_rows))
    return data_sum, reg_sum, count, s


def _unique_row_update(opt: str, lr: float, sgd_cfg: SGDConfig,
                       table, slot, lids, g_u, sq_u):
    """Owner-shard optimizer update from exchanged per-unique sums.

    ``g_u``/``sq_u`` are Σgrad / Σgrad² over each source shard's slots for
    one unique id (masked to zero off-owner); the same id may appear once
    per data shard, so everything is expressed as scatter-ADDs with a
    post-accumulation re-gather — exactly the direct path's adagrad
    semantics (solvers/sgd.py::_row_update) with the per-slot sums
    pre-reduced."""
    if opt == "adagrad":
        slot = slot.at[lids].add(sq_u)
        scale = jax.lax.rsqrt(slot[lids] + sgd_cfg.adagrad_eps)
        table = table.at[lids].add(-lr * g_u * scale)
    else:  # plain sgd (momentum rejected by the exchange router)
        table = table.at[lids].add(-lr * g_u)
    return table, slot


def make_sharded_train_step(cfg: FMConfig, sgd_cfg: SGDConfig, mesh: Mesh,
                            exchange: str = "auto"):
    """Build the jitted shard_map train step over the (data, model) mesh.

    cfg.num_features must already be padded (init_sharded_state does this).

    exchange:
      * "unique" — per-shard dedup; collectives move unique rows (module
        doc). Backward: all_gather over `data` of each shard's packed
        (U, 2K+2) sums — comm D*U*W per chip.
      * "global" — ONE host dedup plan over the whole global batch
        (batch.plan in "global" layout, mesh.batch_pspecs): every shard's
        per-unique sums live in the SAME (U_g, 2K+2) rank space, so the
        backward exchange is a single psum over `data` — comm ~2*U_g*W
        per chip, INDEPENDENT of the data-axis size (the pod-scale fix
        for the all_gather; U_g grows sublinearly with global batch).
        Requires a global host plan; rejects device-plan batches loudly.
      * "dense" — full slot tensors. Comm scales with B*L. Kept for
        adam/momentum (their slot updates don't decompose into
        cross-shard adds) and as the oracle in parity tests.
      * "auto" — unique for adagrad / plain sgd, dense otherwise. (The
        trainer passes "global" explicitly when it builds global plans.)
    """
    if exchange == "auto":
        exchange = ("unique" if sgd_cfg.optimizer in ("adagrad", "sgd")
                    and sgd_cfg.momentum == 0 else "dense")
    if exchange not in ("unique", "dense", "global"):
        raise ValueError(f"unknown exchange={exchange!r}")
    if exchange in ("unique", "global") and (
            sgd_cfg.optimizer not in ("adagrad", "sgd")
            or sgd_cfg.momentum > 0):
        raise ValueError(f"{exchange} exchange supports adagrad/plain sgd; "
                         "use exchange='dense' for adam/momentum")
    if exchange == "unique":
        return _make_unique_sharded_step(cfg, sgd_cfg, mesh)
    if exchange == "global":
        return _make_global_sharded_step(cfg, sgd_cfg, mesh)
    return _make_dense_sharded_step(cfg, sgd_cfg, mesh)


def _make_unique_sharded_step(cfg: FMConfig, sgd_cfg: SGDConfig, mesh: Mesh):
    """The unique-row exchange step (module doc, strategy "unique")."""
    from sparkfm_tpu.ops import embedding as E

    ffm = cfg.num_fields > 0
    k = cfg.num_factors
    kf = cfg.num_fields * k if ffm else k
    fill = cfg.num_features - 1       # padding row (init_sharded_state +1)
    state_specs = M.state_pspecs(ffm=ffm)
    aux_specs = {"loss": P(), "unique_count": P(), "unique_overflow": P()}

    def step(state: SGDState, batch: SparseBatch):
        p = state.params
        rows_per_shard = p.w.shape[0]
        ids = batch.ids                            # (B/D, L) global ids
        n_loc = ids.shape[0] * ids.shape[1]

        if batch.plan is not None:
            uids = batch.plan.uids[0]              # (U,) this shard's plan
            ranks = batch.plan.ranks               # (B/D, L)
            count = batch.plan.count[0]
            overflow = batch.plan.overflow[0]
            budget = uids.shape[0]
        else:
            budget = sgd_cfg.unique_budget or E.auto_budget(n_loc)
            pl = E.dedup_ids(ids, budget, fill=fill)
            uids, ranks = pl.uids, pl.ranks
            count, overflow = pl.count, pl.overflow
        valid_u = jax.lax.iota(jnp.int32, budget) < jnp.minimum(count, budget)

        # ---- forward: ONE psum over `model` of masked UNIQUE rows
        w_u = _gather_rows(p.w, uids, M.MODEL_AXIS)          # (U,)
        v_u = _gather_rows(p.v, uids, M.MODEL_AXIS)          # (U,[nf,]k)
        w_u = jnp.where(valid_u, w_u, 0.0)
        v_u = jnp.where(valid_u.reshape((-1,) + (1,) * (v_u.ndim - 1)),
                        v_u, 0.0)

        # local spread from the small unique matrix (no collective)
        vw_u = jnp.concatenate([v_u.reshape(budget, kf), w_u[:, None]],
                               axis=1)
        vw_rows = vw_u[ranks]                                # (B/D, L, kf+1)
        v_rows = vw_rows[..., :kf].reshape(ids.shape + v_u.shape[1:])
        w_rows = vw_rows[..., kf]

        def objective(w0, w_rows, v_rows):
            dsum, rsum, count_ex, _ = _loss_sums_from_rows(
                w0, w_rows, v_rows, batch, cfg)
            total = jax.lax.psum(count_ex, M.DATA_AXIS)
            inv = 1.0 / jnp.maximum(total, 1.0)
            return (dsum + rsum) * inv, (dsum, total)

        grads, (dsum, total) = jax.grad(
            objective, argnums=(0, 1, 2), has_aux=True)(p.w0, w_rows, v_rows)
        g_w0, g_wrows, g_vrows = grads

        # ---- local reduce: per-unique [Σg_v | Σg_w | Σg_v² | Σg_w²]
        gv = g_vrows.reshape(n_loc, kf)
        gw = g_wrows.reshape(n_loc, 1)
        packed = jnp.concatenate(
            [gv, gw, jnp.square(gv), jnp.square(gw)], axis=-1)
        acc = jnp.zeros((budget, 2 * kf + 2), packed.dtype
                        ).at[ranks.reshape(-1)].add(packed)   # (U, 2kf+2)

        # ---- exchange: ONE all_gather over `data` of unique grads + ids
        uids_all = jax.lax.all_gather(uids, M.DATA_AXIS, tiled=True)
        acc_all = jax.lax.all_gather(acc, M.DATA_AXIS, tiled=True)

        mine, lids = _own_mask_and_lid(uids_all, rows_per_shard,
                                       M.MODEL_AXIS)
        acc_all = jnp.where(mine[:, None], acc_all, 0.0)
        g_v_u = acc_all[:, :kf]
        g_w_u = acc_all[:, kf]
        sq_v_u = acc_all[:, kf + 1:2 * kf + 1]
        sq_w_u = acc_all[:, 2 * kf + 1]

        lr, opt = sgd_cfg.learning_rate, sgd_cfg.optimizer
        w, sw = _unique_row_update(opt, lr, sgd_cfg, p.w, state.slot_w,
                                   lids, g_w_u, sq_w_u)
        v, sv = _unique_row_update(opt, lr, sgd_cfg, p.v, state.slot_v,
                                   lids, g_v_u, sq_v_u)

        if cfg.use_bias:
            g_w0_glob = jax.lax.psum(g_w0, M.DATA_AXIS)
            w0, sw0, s2w0 = sgd_solver._dense_scalar_update(
                opt, lr, sgd_cfg, p.w0, state.slot_w0, state.slot2_w0,
                g_w0_glob, state.step)
        else:
            w0, sw0, s2w0 = p.w0, state.slot_w0, state.slot2_w0

        loss = jax.lax.psum(dsum, M.DATA_AXIS) / jnp.maximum(total, 1.0)
        new_state = SGDState(
            params=FMParams(w0=w0, w=w, v=v),
            slot_w0=sw0, slot_w=sw, slot_v=sv,
            slot2_w0=s2w0, slot2_w=state.slot2_w, slot2_v=state.slot2_v,
            step=state.step + 1)
        aux = {"loss": loss,
               "unique_count": jax.lax.pmax(count, M.DATA_AXIS),
               "unique_overflow": jax.lax.pmax(
                   overflow.astype(jnp.int32), M.DATA_AXIS) > 0}
        return new_state, aux

    cache = {}

    def call(state, batch):
        has_plan = batch.plan is not None
        if has_plan not in cache:
            batch_specs = M.batch_pspecs(has_mask=True, has_fields=ffm,
                                         has_plan=has_plan)
            sharded = shard_map(
                step, mesh=mesh,
                in_specs=(state_specs, batch_specs),
                out_specs=(state_specs, aux_specs),
                check_vma=False)
            cache[has_plan] = jax.jit(sharded, donate_argnums=(0,))
        return cache[has_plan](state, batch)

    return call


def _gather_masked_unique(params: FMParams, uids, count):
    """Forward half shared by the global-exchange steps: psum'd unique
    rows over `model`, masked past the valid count.

    Returns (w_u, v_u, valid_u)."""
    budget = uids.shape[0]
    valid_u = jax.lax.iota(jnp.int32, budget) < jnp.minimum(count, budget)
    w_u = _gather_rows(params.w, uids, M.MODEL_AXIS)
    v_u = _gather_rows(params.v, uids, M.MODEL_AXIS)
    w_u = jnp.where(valid_u, w_u, 0.0)
    v_u = jnp.where(valid_u.reshape((-1,) + (1,) * (v_u.ndim - 1)),
                    v_u, 0.0)
    return w_u, v_u, valid_u


def _apply_unique_acc(cfg: FMConfig, sgd_cfg: SGDConfig, state: SGDState,
                      acc, uids, g_w0, dsum, total):
    """Update half shared by the global-exchange steps: unpack the
    psum'd (U_g, 2kf+2) per-unique sums, mask to owner rows, apply the
    optimizer, update w0, and assemble the new state.

    Returns (new_state, loss)."""
    ffm = cfg.num_fields > 0
    k = cfg.num_factors
    kf = cfg.num_fields * k if ffm else k
    p = state.params
    rows_per_shard = p.w.shape[0]

    mine, lids = _own_mask_and_lid(uids, rows_per_shard, M.MODEL_AXIS)
    acc = jnp.where(mine[:, None], acc, 0.0)
    g_v_u = acc[:, :kf]
    g_w_u = acc[:, kf]
    sq_v_u = acc[:, kf + 1:2 * kf + 1]
    sq_w_u = acc[:, 2 * kf + 1]
    if not cfg.use_linear:
        g_w_u = jnp.zeros_like(g_w_u)
        sq_w_u = jnp.zeros_like(sq_w_u)

    lr, opt = sgd_cfg.learning_rate, sgd_cfg.optimizer
    w, sw = _unique_row_update(opt, lr, sgd_cfg, p.w, state.slot_w,
                               lids, g_w_u, sq_w_u)
    v, sv = _unique_row_update(opt, lr, sgd_cfg, p.v, state.slot_v,
                               lids, g_v_u, sq_v_u)

    if cfg.use_bias:
        w0, sw0, s2w0 = sgd_solver._dense_scalar_update(
            opt, lr, sgd_cfg, p.w0, state.slot_w0, state.slot2_w0,
            g_w0, state.step)
    else:
        w0, sw0, s2w0 = p.w0, state.slot_w0, state.slot2_w0

    loss = jax.lax.psum(dsum, M.DATA_AXIS) / total
    new_state = SGDState(
        params=FMParams(w0=w0, w=w, v=v),
        slot_w0=sw0, slot_w=sw, slot_v=sv,
        slot2_w0=s2w0, slot2_w=state.slot2_w, slot2_v=state.slot2_v,
        step=state.step + 1)
    return new_state, loss


def _make_global_sharded_step(cfg: FMConfig, sgd_cfg: SGDConfig, mesh: Mesh):
    """The global-plan exchange (make_sharded_train_step, "global").

    One host dedup plan covers the WHOLE global batch, so every data
    shard's local per-unique gradient sums live in the same (U_g, 2kf+2)
    rank space and the backward exchange collapses to ONE psum over
    `data` (ring comm ~2*U_g*W per chip regardless of D — the "unique"
    exchange's all_gather moves D*U*W and bites at pod scale; module
    doc). Forward is the same masked unique-row psum over `model`, now on
    the global unique set (U_g >= per-shard U; for power-law ids U_g
    grows sublinearly in the global batch, so the forward overhead is
    small next to the backward savings at D >= 4). Update math is
    identical to the "unique" exchange in exact arithmetic: the psum'd
    sums are exactly what its masked all_gather + scatter-add applies.
    """
    from sparkfm_tpu.ops import embedding as E

    ffm = cfg.num_fields > 0
    k = cfg.num_factors
    kf = cfg.num_fields * k if ffm else k
    state_specs = M.state_pspecs(ffm=ffm)
    aux_specs = {"loss": P(), "unique_count": P(), "unique_overflow": P()}

    def step(state: SGDState, batch: SparseBatch):
        p = state.params
        ids = batch.ids                            # (B/D, L) global ids
        n_loc = ids.shape[0] * ids.shape[1]

        uids = batch.plan.uids                     # (U_g,) replicated
        ranks = batch.plan.ranks                   # (B/D, L) global ranks
        count = batch.plan.count
        overflow = batch.plan.overflow
        budget = uids.shape[0]

        # ---- forward: ONE psum over `model` of masked UNIQUE rows
        w_u, v_u, _ = _gather_masked_unique(p, uids, count)

        vw_u = jnp.concatenate([v_u.reshape(budget, kf), w_u[:, None]],
                               axis=1)
        vw_rows = vw_u[ranks]                                # (B/D, L, kf+1)
        v_rows = vw_rows[..., :kf].reshape(ids.shape + v_u.shape[1:])
        w_rows = vw_rows[..., kf]

        def objective(w0, w_rows, v_rows):
            dsum, rsum, count_ex, _ = _loss_sums_from_rows(
                w0, w_rows, v_rows, batch, cfg)
            total = jax.lax.psum(count_ex, M.DATA_AXIS)
            inv = 1.0 / jnp.maximum(total, 1.0)
            return (dsum + rsum) * inv, (dsum, total)

        grads, (dsum, total) = jax.grad(
            objective, argnums=(0, 1, 2), has_aux=True)(p.w0, w_rows, v_rows)
        g_w0, g_wrows, g_vrows = grads

        # ---- local reduce into the SHARED global rank space
        gv = g_vrows.reshape(n_loc, kf)
        gw = g_wrows.reshape(n_loc, 1)
        packed = jnp.concatenate(
            [gv, gw, jnp.square(gv), jnp.square(gw)], axis=-1)
        acc = jnp.zeros((budget, 2 * kf + 2), packed.dtype
                        ).at[ranks.reshape(-1)].add(packed)  # (U_g, 2kf+2)

        # ---- exchange: ONE psum over `data` (ranks aligned across shards)
        acc = jax.lax.psum(acc, M.DATA_AXIS)

        new_state, loss = _apply_unique_acc(
            cfg, sgd_cfg, state, acc, uids,
            g_w0=jax.lax.psum(g_w0, M.DATA_AXIS), dsum=dsum,
            total=jnp.maximum(total, 1.0))
        aux = {"loss": loss, "unique_count": count,
               "unique_overflow": overflow}
        return new_state, aux

    k = cfg.num_factors
    classification = cfg.task == Task.CLASSIFICATION
    hybrid_ok = (not ffm and cfg.feature_groups is None
                 and jnp.dtype(cfg.compute_dtype) == jnp.float32
                 and sgd_cfg.optimizer in ("adagrad", "sgd"))

    def step_hybrid(state: SGDState, batch: SparseBatch):
        """Analytic per-shard sorted backward (the single-chip hybrid
        step's math, solvers/sgd_hybrid.py) feeding the global exchange:
        each shard evaluates the closed-form FM gradient in locally
        id-sorted order, reduces runs in fm_grad_segsum, scatter-adds its
        (U_cap, 2k+2) local sums into the SHARED global rank space via
        the host gmap, and ONE psum combines — no jax.grad, no
        (B/D)*L-slot scatter accumulate."""
        from sparkfm_tpu.ops import segsum as SS

        p = state.params
        ids = batch.ids                            # (B/D, L)
        plan = batch.plan
        uids = plan.uids                           # (U_g,) replicated
        ranks = plan.ranks                         # (B/D, L) global ranks
        count = plan.count
        overflow = plan.overflow
        budget = uids.shape[0]
        seg_d = plan.seg[0]                        # (N_loc,) local block
        svals_d = plan.svals[0]
        sex_d = plan.sex[0]
        gmap_d = plan.order[0]                     # (U_cap,)
        u_cap = gmap_d.shape[0]

        # ---- forward: psum'd unique rows + local spread (as step())
        w_u, v_u, _ = _gather_masked_unique(p, uids, count)
        vw_u = jnp.concatenate([v_u, w_u[:, None]], axis=1)   # (U_g, k+1)

        vals = batch.vals
        vw_rows = vw_u[ranks]                                 # (B/D, L, k+1)
        vx = vw_rows[..., :k] * vals[..., None]
        s = jnp.sum(vx, axis=1)                               # (B/D, k)
        ssq = jnp.sum(jnp.square(vx), axis=(1, 2))
        score = 0.5 * (jnp.sum(jnp.square(s), axis=-1) - ssq)
        if cfg.use_linear:
            score = score + jnp.sum(vw_rows[..., k] * vals, axis=-1)
        if cfg.use_bias:
            score = score + p.w0

        wt = (batch.mask.astype(jnp.float32) if batch.mask is not None
              else jnp.ones_like(batch.y))
        total = jax.lax.psum(jnp.sum(wt), M.DATA_AXIS)
        denom_data = jnp.maximum(total, 1e-12)
        denom_reg = jnp.maximum(total, 1.0)
        if classification:
            y_pm = jnp.where(batch.y > 0, 1.0, -1.0)
            z = -y_pm * score
            dsum = jnp.sum(jax.nn.softplus(z) * wt)
            ds = -y_pm * jax.nn.sigmoid(z) * wt / denom_data
        else:
            err = score - batch.y
            dsum = jnp.sum(jnp.square(err) * wt)
            ds = 2.0 * err * wt / denom_data

        # ---- per-shard analytic sorted backward over the (U_cap, k+1)
        # local rows (ops/segsum.py::fm_grad_segsum_factored)
        vw_loc = vw_u.at[gmap_d].get(mode="promise_in_bounds")  # (U_cap,k+1)
        ex_pack = jnp.concatenate(
            [s, ds[:, None], wt[:, None]], axis=1)            # (B/D, k+2)
        ex_srt = ex_pack[sex_d]
        acc_loc = SS.fm_grad_segsum_factored(
            vw_loc, ex_srt, svals_d, seg_d, u_cap,
            2.0 * cfg.reg_v / denom_reg, 2.0 * cfg.reg_w / denom_reg)
        # unused U_cap rows are exact zeros (no slot has their rank);
        # their gmap entries point at rank 0 and add nothing.
        acc = jnp.zeros((budget, 2 * k + 2), jnp.float32
                        ).at[gmap_d].add(acc_loc)

        # ---- exchange: ONE psum over `data` (shared global rank space)
        acc = jax.lax.psum(acc, M.DATA_AXIS)

        new_state, loss = _apply_unique_acc(
            cfg, sgd_cfg, state, acc, uids,
            g_w0=(jax.lax.psum(jnp.sum(ds), M.DATA_AXIS)
                  + 2.0 * cfg.reg0 * p.w0),
            dsum=dsum, total=denom_data)
        return new_state, {"loss": loss, "unique_count": count,
                           "unique_overflow": overflow}

    cache = {}

    def call(state, batch):
        if batch.plan is None or batch.plan.uids.ndim != 1:
            raise ValueError(
                "exchange='global' requires ONE host dedup plan over the "
                "whole global batch (uids shape (U_g,)); build it with "
                "ops.embedding.host_dedup on the full id block, or use "
                "exchange='unique' for stacked per-shard plans")
        import dataclasses as _dc
        has_hybrid = batch.plan.seg is not None
        if has_hybrid and not hybrid_ok:
            raise ValueError(
                "global-exchange hybrid extras need plain FM, float32, "
                "adagrad/sgd, no feature_groups — drop the extras "
                "(stack_hybrid_extras) for this config")
        if not has_hybrid and batch.plan.order is not None:
            batch = _dc.replace(
                batch, plan=batch.plan._replace(order=None, seg=None,
                                                svals=None, sex=None))
        if has_hybrid not in cache:
            batch_specs = M.batch_pspecs(
                has_mask=True, has_fields=ffm,
                plan_mode="global_hybrid" if has_hybrid else "global")
            sharded = shard_map(
                step_hybrid if has_hybrid else step, mesh=mesh,
                in_specs=(state_specs, batch_specs),
                out_specs=(state_specs, aux_specs),
                check_vma=False)
            cache[has_hybrid] = jax.jit(sharded, donate_argnums=(0,))
        return cache[has_hybrid](state, batch)

    return call


def _make_dense_sharded_step(cfg: FMConfig, sgd_cfg: SGDConfig, mesh: Mesh):
    """The dense slot-tensor exchange (module doc, strategy "dense")."""
    ffm = cfg.num_fields > 0
    state_specs = M.state_pspecs(ffm=ffm)
    batch_specs = M.batch_pspecs(has_mask=True, has_fields=ffm)
    aux_specs = {"loss": P()}

    def step(state: SGDState, batch: SparseBatch):
        p = state.params
        rows_per_shard = p.w.shape[0]
        ids = batch.ids                            # (B/D, L) global ids

        # ---- forward gather over the model axis (psum collective)
        w_rows = _gather_rows(p.w, ids, M.MODEL_AXIS)
        v_rows = _gather_rows(p.v, ids, M.MODEL_AXIS)

        # ---- global normalizer (exact across uneven shards)
        def objective(w0, w_rows, v_rows):
            dsum, rsum, count, _ = _loss_sums_from_rows(
                w0, w_rows, v_rows, batch, cfg)
            total = jax.lax.psum(count, M.DATA_AXIS)
            inv = 1.0 / jnp.maximum(total, 1.0)
            # local contribution to the global mean objective; summing the
            # resulting grads over shards (the all_gather below) gives the
            # exact global gradient.
            return (dsum + rsum) * inv, (dsum, total)

        grads, (dsum, total) = jax.grad(
            objective, argnums=(0, 1, 2), has_aux=True)(p.w0, w_rows, v_rows)
        g_w0, g_wrows, g_vrows = grads

        # ---- backward exchange: grads for every shard's batch rows
        ids_all = jax.lax.all_gather(ids, M.DATA_AXIS, tiled=True)
        g_wrows_all = jax.lax.all_gather(g_wrows, M.DATA_AXIS, tiled=True)
        g_vrows_all = jax.lax.all_gather(g_vrows, M.DATA_AXIS, tiled=True)

        mine, lid = _own_mask_and_lid(ids_all, rows_per_shard, M.MODEL_AXIS)
        lid_flat = lid.reshape(-1)
        gw_flat = jnp.where(mine, g_wrows_all, 0).reshape(-1)
        gv_flat = jnp.where(mine[..., None], g_vrows_all, 0
                            ).reshape(-1, g_vrows_all.shape[-1])

        lr, opt = sgd_cfg.learning_rate, sgd_cfg.optimizer
        w, sw, s2w = sgd_solver._row_update(
            opt, lr, sgd_cfg, p.w, state.slot_w, state.slot2_w,
            lid_flat, gw_flat, state.step)
        v, sv, s2v = sgd_solver._row_update(
            opt, lr, sgd_cfg, p.v, state.slot_v, state.slot2_v,
            lid_flat, gv_flat, state.step)

        if cfg.use_bias:
            g_w0_glob = jax.lax.psum(g_w0, M.DATA_AXIS)
            w0, sw0, s2w0 = sgd_solver._dense_scalar_update(
                opt, lr, sgd_cfg, p.w0, state.slot_w0, state.slot2_w0,
                g_w0_glob, state.step)
        else:
            w0, sw0, s2w0 = p.w0, state.slot_w0, state.slot2_w0

        loss = jax.lax.psum(dsum, M.DATA_AXIS) / jnp.maximum(total, 1.0)
        new_state = SGDState(
            params=FMParams(w0=w0, w=w, v=v),
            slot_w0=sw0, slot_w=sw, slot_v=sv,
            slot2_w0=s2w0, slot2_w=s2w, slot2_v=s2v,
            step=state.step + 1)
        return new_state, {"loss": loss}

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(state_specs, batch_specs),
        out_specs=(state_specs, aux_specs),
        check_vma=False)
    jitted = jax.jit(sharded, donate_argnums=(0,))

    def call(state, batch):
        if batch.plan is not None:
            # dense exchange has no use for a dedup plan; drop it so the
            # batch pytree matches the specs.
            import dataclasses as _dc
            batch = _dc.replace(batch, plan=None)
        return jitted(state, batch)

    return call


def make_sharded_score_fn(cfg: FMConfig, mesh: Mesh):
    """Sharded batched scoring: gather rows over `model`, score over `data`."""
    ffm = cfg.num_fields > 0
    param_specs = M.param_pspecs(ffm=ffm)

    def score(params: FMParams, ids, vals, field_ids):
        w_rows = _gather_rows(params.w, ids, M.MODEL_AXIS)
        v_rows = _gather_rows(params.v, ids, M.MODEL_AXIS)
        if ffm:
            return I.ffm_scores_from_gathered(
                params.w0, w_rows, v_rows, vals, field_ids, cfg.num_fields,
                use_bias=cfg.use_bias, use_linear=cfg.use_linear,
                compute_dtype=jnp.dtype(cfg.compute_dtype),
                slot_major=cfg.slot_major_fields)
        return I.fm_scores_from_gathered(
            params.w0, w_rows, v_rows, vals,
            use_bias=cfg.use_bias, use_linear=cfg.use_linear,
            compute_dtype=jnp.dtype(cfg.compute_dtype))

    in_specs = (param_specs, P(M.DATA_AXIS, None), P(M.DATA_AXIS, None),
                P(M.DATA_AXIS, None) if ffm else P(M.DATA_AXIS, None))
    sharded = shard_map(score, mesh=mesh, in_specs=in_specs,
                        out_specs=P(M.DATA_AXIS), check_vma=False)

    def score_fn(params, ids, vals, field_ids=None):
        if field_ids is None:
            field_ids = jnp.zeros_like(ids)
        return sharded(params, ids, vals, field_ids)

    return jax.jit(score_fn)
