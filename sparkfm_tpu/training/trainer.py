"""Training loop: pluggable solver + per-epoch evaluation.

Counterpart of the reference's FactorizationMachines.learnWith
(impl/FactorizationMachines.scala:30-49): same observable behavior — build
model, iterate solver epochs, log train metric each epoch, return the model —
but the epoch body is jitted device code and eval cadence is configurable
(the reference unconditionally pays a full extra train-RMSE pass every epoch
*before* each update: FactorizationMachines.scala:42-46).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import expit as _expit

from sparkfm_tpu.config import FMConfig, SGDConfig, Task
from sparkfm_tpu.data.batching import SparseBatch, SparseDataset, batch_iterator
from sparkfm_tpu.models import fm as fm_model
from sparkfm_tpu.models.fm import FMParams
from sparkfm_tpu.ops import losses as L
from sparkfm_tpu.ops import metrics as M
from sparkfm_tpu.solvers import sgd as sgd_solver

log = logging.getLogger("sparkfm_tpu")


def _eval_scores_fn(cfg: FMConfig):
    @jax.jit
    def score_batch(params: FMParams, ids, vals, field_ids, plan=None):
        return fm_model.scores(params, cfg, ids, vals, field_ids, plan=plan)
    return score_batch


def evaluate(params: FMParams, cfg: FMConfig, ds: SparseDataset,
             batch_size: int = 8192,
             score_fn=None) -> Dict[str, float]:
    """Full-dataset metrics. Regression: RMSE/MAE. Classification: AUC,
    logloss, accuracy. Scores stream back to host once per batch.

    Big plain-FM tables score through host ladder dedup plans (one tight
    unique-row gather per batch, no device sorts) — the same input-
    pipeline discipline as training."""
    if score_fn is None:
        score_fn = _eval_scores_fn(cfg)
    dedup_budget = dedup_fill = None
    if cfg.num_fields == 0 and cfg.num_features >= (1 << 16):
        # fill = LAST row id: fill entries trail the sorted uniques, so
        # fill must compare >= every uid or fm.scores'
        # indices_are_sorted gather promise is violated (wrong rows)
        dedup_budget, dedup_fill = "ladder", cfg.num_features - 1
    all_scores: List[np.ndarray] = []
    for b in batch_iterator(ds, batch_size, shuffle=False,
                            dedup_budget=dedup_budget,
                            dedup_fill=dedup_fill):
        plan = b.plan
        if plan is not None and bool(plan.overflow):
            # Ladder plans cap at auto_budget(n_slots) <= 2^18; a batch
            # with more distinct ids would alias rows and score WRONG.
            # Fall back to exact dense/device scoring for this batch
            # (ADVICE r3 medium).
            log.warning("eval batch overflowed the dedup-plan budget "
                        "(%d uniques > %d); scoring it exactly without "
                        "a plan", int(plan.count), plan.uids.shape[0])
            plan = None
        s = score_fn(params, b.ids, b.vals, b.field_ids, plan)
        nvalid = int(np.sum(np.asarray(b.mask)))
        all_scores.append(np.asarray(s)[:nvalid])
    scores = np.concatenate(all_scores)
    y = ds.y[:len(scores)]
    out: Dict[str, float] = {}
    if cfg.task == Task.REGRESSION:
        out["rmse"] = float(np.sqrt(np.mean(np.square(scores - y))))
        out["mae"] = float(np.mean(np.abs(scores - y)))
    else:
        prob = _expit(scores)  # overflow-safe sigmoid
        y01 = (y > 0).astype(np.float64)
        eps = 1e-7
        p = np.clip(prob, eps, 1 - eps)
        out["logloss"] = float(-np.mean(y01 * np.log(p)
                                        + (1 - y01) * np.log1p(-p)))
        out["accuracy"] = float(np.mean((prob >= 0.5) == (y01 > 0.5)))
        out["auc"] = float(M.auc(jnp.asarray(scores), jnp.asarray(y)))
    return out


@dataclasses.dataclass
class TrainResult:
    params: FMParams
    history: List[Dict[str, float]]
    examples_per_sec: float = 0.0


def _time_budget_reached(t0: float, max_seconds: float, epoch: int) -> bool:
    """Epoch-boundary wall-clock budget (SGDConfig.max_seconds — the
    reference's `timeout` knob, FM.scala:30, honored here). The epoch in
    flight always completes; callers write a final checkpoint before
    breaking."""
    if max_seconds and (time.perf_counter() - t0) >= max_seconds:
        log.info("wall-clock budget max_seconds=%.3f reached after epoch "
                 "%d; stopping early", max_seconds, epoch)
        return True
    return False

def train_sgd(cfg: FMConfig, sgd_cfg: SGDConfig, train: SparseDataset,
              eval_ds: Optional[SparseDataset] = None,
              eval_every: int = 1,
              key: Optional[jax.Array] = None,
              hooks: Optional[List[Callable]] = None,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 1,
              resume: bool = True,
              mesh=None,
              init_params=None) -> TrainResult:
    """SGD training (BASELINE config 1 path).

    With ``mesh`` set (a jax.sharding.Mesh from parallel.mesh.make_mesh, or
    a config.MeshConfig), training runs the sharded shard_map step over the
    (data, model) device mesh — tables row-sharded, batches data-sharded,
    unique-row collectives (parallel/sharded_sgd.py) — instead of the
    single-device step. This is the one-call mesh entry point (SURVEY §7
    step 7); multi-process runs call parallel.multihost.initialize() first
    and every process executes this same function.

    With ``checkpoint_dir`` set, the full state is async-saved every
    ``checkpoint_every`` epochs and, if ``resume`` and a checkpoint exists,
    training continues from the saved epoch with the identical
    (seed, epoch)-keyed batch order — a resumed run reproduces an
    uninterrupted one exactly (tests/test_checkpoint.py).
    """
    if mesh is not None:
        if init_params is not None:
            raise ValueError("init_params (warm start) is single-device "
                             "for now; shard the tables manually via "
                             "parallel.sharded_sgd for a sharded warm "
                             "start")
        return _train_sgd_sharded(cfg, sgd_cfg, train, eval_ds, eval_every,
                                  key, hooks, checkpoint_dir,
                                  checkpoint_every, resume, mesh)
    path = sgd_solver.resolve_update_path(cfg, sgd_cfg)
    if init_params is not None and init_params.v.shape[0] != cfg.num_features:
        raise ValueError(
            f"init_params table has {init_params.v.shape[0]} rows != "
            f"num_features {cfg.num_features}")
    if path in ("fused", "sorted", "hybrid"):
        from sparkfm_tpu.solvers import sgd_fused
        state = (sgd_fused.fused_from_params(init_params, cfg)
                 if init_params is not None
                 else sgd_fused.init_fused_state(cfg, key))
        if path == "sorted":
            from sparkfm_tpu.solvers import sgd_sorted
            step_fn = sgd_sorted.make_sorted_train_step(cfg, sgd_cfg)
        elif path == "hybrid":
            from sparkfm_tpu.solvers import sgd_hybrid
            step_fn = sgd_hybrid.make_hybrid_train_step(cfg, sgd_cfg)
        else:
            step_fn = sgd_fused.make_fused_train_step(cfg, sgd_cfg)
        get_params = lambda s: sgd_fused.params_from_fused(s, cfg)
    else:
        params = (init_params if init_params is not None
                  else fm_model.init_params(cfg, key))
        state = sgd_solver.init_state(params, optimizer=sgd_cfg.optimizer)
        if path == "dedup":
            state = sgd_solver.pad_state_for_dedup(state)
        step_fn = sgd_solver.make_train_step(cfg, sgd_cfg)
        get_params = lambda s: s.params
    score_fn = _eval_scores_fn(cfg)

    history: List[Dict[str, float]] = []
    start_epoch = 0
    ckpt = None
    if checkpoint_dir is not None:
        from sparkfm_tpu.utils.checkpoint import Checkpointer
        ckpt = Checkpointer(checkpoint_dir)
        if resume and ckpt.latest_step() is not None:
            try:
                state, extra = ckpt.restore(template=state)
            except Exception as e:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir} does not match the "
                    f"resolved update path {path!r} state layout — it was "
                    "probably written under a different update_path (the "
                    "'auto' policy can change across versions: round 5 "
                    "routes big-table FFM to 'fused'). Pin SGDConfig."
                    "update_path to the original path to resume, or start "
                    "fresh with resume=False.") from e
            start_epoch = int(extra.get("epoch", -1)) + 1
            history = list(extra.get("history", []))
            log.info("resumed from %s at epoch %d", checkpoint_dir,
                     start_epoch)

    # Host-side dedup plans (overlapped with device compute via prefetch)
    # for the table-access paths that consume them.
    dedup_budget = dedup_fill = None
    if path == "hybrid" and not sgd_cfg.host_plan:
        raise ValueError("update_path='hybrid' requires host_plan=True "
                         "(the sorted backward consumes plan.svals/sex)")
    if sgd_cfg.host_plan and path in ("dedup", "fused", "hybrid"):
        # unique_budget=0 -> the ladder: plans sized to each batch's real
        # unique count rounded to a coarse rung (ops.embedding
        # .ladder_budget) — tight write-backs, overflow impossible, at
        # most a handful of step recompiles per run.
        dedup_budget = sgd_cfg.unique_budget or "ladder"
        dedup_fill = cfg.num_features

    # Hybrid multi-step: scan steps_per_dispatch staged batches per
    # jitted call, amortizing the fixed per-dispatch launch cost
    # (solvers/sgd_hybrid.py::make_hybrid_multi_step; exact same update
    # sequence). Only consecutive batches whose ladder plans share a
    # rung group together; rung growth or tails fall back to singles.
    group = (sgd_cfg.steps_per_dispatch
             if path == "hybrid" and sgd_cfg.steps_per_dispatch > 1
             else 1)
    multi_fn = None
    if group > 1:
        from sparkfm_tpu.solvers import sgd_hybrid as _H
        multi_fn = _H.make_hybrid_multi_step(cfg, sgd_cfg)
        log.info("hybrid multi-step: %d steps/dispatch", group)

    n_examples = 0
    t0 = time.perf_counter()
    compile_time = 0.0
    first_dispatch = [True]
    from sparkfm_tpu.data.batching import prefetch
    for epoch in range(start_epoch, sgd_cfg.epochs):
        losses = []
        overflows = []
        buf: List[SparseBatch] = []

        def _record_compile(tc, scalar):
            nonlocal compile_time
            jax.block_until_ready(scalar)
            compile_time = time.perf_counter() - tc
            first_dispatch[0] = False

        def dispatch_single(b):
            nonlocal state
            tc = time.perf_counter() if first_dispatch[0] else None
            state, aux = step_fn(state, b)
            if tc is not None:
                _record_compile(tc, aux["loss"])
            losses.append(aux["loss"])
            if "unique_overflow" in aux:
                overflows.append(jnp.asarray(aux["unique_overflow"],
                                             jnp.int32))

        def dispatch_group(bs):
            nonlocal state
            stacked = _H.stack_batches(bs)
            tc = time.perf_counter() if first_dispatch[0] else None
            state, aux = multi_fn(state, stacked)
            if tc is not None:
                _record_compile(tc, aux["loss"])
            # the group mean replicated len(bs) times keeps the epoch
            # mean identical to per-batch logging
            losses.extend([aux["loss_mean"]] * len(bs))
            overflows.append(jnp.asarray(aux["unique_overflow"],
                                         jnp.int32))

        def flush():
            if multi_fn is not None and len(buf) == group:
                dispatch_group(list(buf))
            else:
                for b in buf:
                    dispatch_single(b)
            buf.clear()

        def plan_shape(b):
            return None if b.plan is None else b.plan.uids.shape

        for batch in prefetch(batch_iterator(
                train, sgd_cfg.batch_size,
                shuffle=sgd_cfg.shuffle_each_epoch, seed=cfg.seed,
                epoch=epoch, drop_remainder=False,
                dedup_budget=dedup_budget, dedup_fill=dedup_fill)):
            n_examples += int(jnp.sum(batch.mask)) if batch.mask is not None \
                else batch.batch_size
            if group == 1:
                dispatch_single(batch)
                continue
            if buf and plan_shape(buf[-1]) != plan_shape(batch):
                flush()
            buf.append(batch)
            if len(buf) == group:
                flush()
        flush()
        rec = {"epoch": epoch,
               "train_loss": float(jnp.mean(jnp.stack(losses)))}
        if overflows:
            # steps whose distinct-id count exceeded the unique budget:
            # those steps silently aliased excess ids onto the last budget
            # slot (dropped/merged updates) — surface it (VERDICT r1 #9).
            n_over = int(jnp.sum(jnp.stack(overflows)))
            rec["unique_overflow_steps"] = n_over
            if n_over:
                log.warning(
                    "epoch %d: %d step(s) overflowed the unique-id budget "
                    "(updates aliased); raise SGDConfig.unique_budget",
                    epoch, n_over)
        if eval_ds is not None and (epoch % eval_every == 0
                                    or epoch == sgd_cfg.epochs - 1):
            rec.update({f"eval_{k}": v for k, v in evaluate(
                get_params(state), cfg, eval_ds, sgd_cfg.batch_size,
                score_fn).items()})
        history.append(rec)
        log.info("epoch %d: %s", epoch,
                 " ".join(f"{k}={v:.5f}" for k, v in rec.items()
                          if k != "epoch"))
        if hooks:
            for h in hooks:
                h(epoch, state, rec)
        stop = _time_budget_reached(t0, sgd_cfg.max_seconds, epoch)
        if ckpt is not None and ((epoch + 1) % checkpoint_every == 0
                                 or epoch == sgd_cfg.epochs - 1 or stop):
            ckpt.save(epoch, state,
                      extra={"epoch": epoch, "history": history})
        if stop:
            break
    if ckpt is not None:
        ckpt.close()
    elapsed = time.perf_counter() - t0 - compile_time
    eps = n_examples / max(elapsed, 1e-9)
    return TrainResult(
        params=sgd_solver.trim_params(get_params(state), cfg.num_features),
        history=history, examples_per_sec=eps)


def _train_sgd_sharded(cfg: FMConfig, sgd_cfg: SGDConfig,
                       train: SparseDataset,
                       eval_ds, eval_every, key, hooks,
                       checkpoint_dir, checkpoint_every, resume,
                       mesh) -> TrainResult:
    """Mesh-sharded SGD epoch loop (see train_sgd's ``mesh`` doc).

    Every process runs this loop SPMD; batches are drawn with the identical
    (seed, epoch) order on all hosts, each host lifts its
    process_batch_slice into the globally sharded batch
    (parallel.multihost.global_batch), and eval scores are
    process_allgather-ed so metrics are identical everywhere.
    """
    from sparkfm_tpu.config import MeshConfig
    from sparkfm_tpu.ops import embedding as _E
    from sparkfm_tpu.parallel import mesh as _M
    from sparkfm_tpu.parallel import multihost as _MH
    from sparkfm_tpu.parallel import sharded_sgd as _S

    exchange_pref = "auto"
    if isinstance(mesh, MeshConfig):
        exchange_pref = mesh.exchange
        mesh = _M.mesh_from_config(mesh)
    d_shards = mesh.shape[_M.DATA_AXIS]
    if sgd_cfg.batch_size % d_shards:
        raise ValueError(f"batch_size={sgd_cfg.batch_size} not divisible by "
                         f"data axis size {d_shards}")
    ffm = cfg.num_fields > 0

    state, pcfg = _S.init_sharded_state(cfg, mesh, key)
    unique = (sgd_cfg.optimizer in ("adagrad", "sgd")
              and sgd_cfg.momentum == 0)

    # Host plans + unique-compatible optimizer -> the GLOBAL exchange: one
    # host dedup plan over the whole global batch, backward = one psum of
    # aligned per-unique sums (comm independent of the data-axis size —
    # parallel/sharded_sgd.py module doc). Otherwise the per-shard unique
    # exchange (device dedup) or dense (adam/momentum) via "auto".
    # MeshConfig.exchange pins a strategy explicitly.
    if exchange_pref == "auto":
        use_global = sgd_cfg.host_plan and unique
        exchange = "global" if use_global else "auto"
    else:
        exchange = exchange_pref
        use_global = exchange == "global"
        if use_global and not sgd_cfg.host_plan:
            raise ValueError("exchange='global' requires host_plan=True "
                             "(it consumes a host dedup plan)")
    step_fn = _S.make_sharded_train_step(pcfg, sgd_cfg, mesh,
                                         exchange=exchange)
    score_fn = _S.make_sharded_score_fn(pcfg, mesh)

    plan_budget = plan_fill = None
    stacked_budget = None
    global_hybrid = False
    if use_global:
        n_glob = sgd_cfg.batch_size * train.max_nnz
        # unique_budget=0 -> budget ladder on the global unique count
        # (monotonic rung, same policy as the single-device path).
        plan_budget = sgd_cfg.unique_budget or "ladder"
        plan_ladder_cap = _E.auto_budget(n_glob)
        plan_rung = [1]
        plan_fill = pcfg.num_features - 1
        # Per-shard analytic sorted backward (the single-chip hybrid
        # step's math) when the model/optimizer fit its restrictions:
        # the host also emits shard-sorted extras (stack_hybrid_extras).
        global_hybrid = (cfg.num_fields == 0
                         and cfg.feature_groups is None
                         and jnp.dtype(cfg.compute_dtype) == jnp.float32
                         and sgd_cfg.optimizer in ("adagrad", "sgd"))
        hybrid_cap = [1]
        if global_hybrid:
            log.info("mesh path: exchange=global backward=hybrid "
                     "(analytic sorted segsum per shard, one psum)")
        else:
            why = ("ffm" if cfg.num_fields > 0
                   else "feature_groups" if cfg.feature_groups is not None
                   else "compute_dtype=%s" % cfg.compute_dtype
                   if jnp.dtype(cfg.compute_dtype) != jnp.float32
                   else "optimizer=%s" % sgd_cfg.optimizer)
            log.info("mesh path: exchange=global backward=jax.grad "
                     "(hybrid ineligible: %s)", why)
    elif exchange == "unique" and sgd_cfg.host_plan:
        # Pinned per-shard unique exchange with host plans: stacked plans.
        n_loc = (sgd_cfg.batch_size // d_shards) * train.max_nnz
        stacked_budget = sgd_cfg.unique_budget or _E.auto_budget(n_loc)
        plan_fill = pcfg.num_features - 1
        log.info("mesh path: exchange=unique (stacked host plans) "
                 "backward=jax.grad")
    else:
        resolved = exchange if exchange != "auto" else (
            "unique" if unique else "dense")
        log.info("mesh path: exchange=%s (device dedup) backward=jax.grad"
                 if resolved == "unique" else
                 "mesh path: exchange=%s backward=jax.grad", resolved)

    history: List[Dict[str, float]] = []
    start_epoch = 0
    ckpt = None
    if checkpoint_dir is not None:
        from sparkfm_tpu.utils.checkpoint import Checkpointer
        ckpt = Checkpointer(checkpoint_dir)
        if resume and ckpt.latest_step() is not None:
            try:
                state, extra = ckpt.restore(template=state)
            except Exception as e:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir} does not match the "
                    f"resolved update path {path!r} state layout — it was "
                    "probably written under a different update_path (the "
                    "'auto' policy can change across versions: round 5 "
                    "routes big-table FFM to 'fused'). Pin SGDConfig."
                    "update_path to the original path to resume, or start "
                    "fresh with resume=False.") from e
            start_epoch = int(extra.get("epoch", -1)) + 1
            history = list(extra.get("history", []))
            log.info("resumed from %s at epoch %d", checkpoint_dir,
                     start_epoch)

    def lift(batch: SparseBatch) -> SparseBatch:
        # Per-host input: every host draws the same global batch order (same
        # seed), keeps only its contiguous process slice, and lifts it into
        # the globally sharded batch (make_array_from_process_local_data
        # assembles the rest). Single-process: the slice is the whole batch.
        plan = None
        extras = None
        if plan_budget is not None:
            # Global plan: dedup the FULL global id block (identical on
            # every process by the same-seed discipline) BEFORE slicing;
            # ranks slice per host alongside ids below.
            ids_full = np.asarray(batch.ids)
            if plan_budget == "ladder":
                hp = _E.host_dedup(ids_full, plan_ladder_cap, plan_fill)
                plan_rung[0] = max(plan_rung[0], _E.ladder_budget(
                    int(hp.count), cap=plan_ladder_cap))
                hp = hp._replace(uids=hp.uids[:plan_rung[0]])
            else:
                hp = _E.host_dedup(ids_full, plan_budget, plan_fill)
            plan = hp._replace(order=None, seg=None, svals=None, sex=None)
            if global_hybrid:
                # Hybrid extras over the FULL global batch split into ALL
                # d_shards chunks — never from a process-local slice: the
                # u_cap rung must be identical on every process, or
                # make_array_from_process_local_data sees inconsistent
                # global shapes for gmap/seg/svals/sex (ADVICE r3 high).
                # Each process keeps only its own shard rows below.
                seg, svals, sex, gmap, u_cap = _E.stack_hybrid_extras(
                    np.asarray(hp.ranks), np.asarray(batch.vals),
                    d_shards, u_cap=hybrid_cap[0])
                if u_cap > hybrid_cap[0]:
                    hybrid_cap[0] = u_cap
                extras = (gmap, seg, svals, sex)
        local_shards = d_shards
        if jax.process_count() > 1:
            sl = _MH.process_batch_slice(batch.batch_size)
            batch = dataclasses.replace(
                batch, ids=batch.ids[sl], vals=batch.vals[sl],
                y=batch.y[sl],
                mask=None if batch.mask is None else batch.mask[sl],
                field_ids=(None if batch.field_ids is None
                           else batch.field_ids[sl]))
            if plan is not None:
                plan = plan._replace(ranks=plan.ranks[sl])
            local_shards = d_shards // jax.process_count()
            if extras is not None:
                # this process's rows of the (D, ...) shard-stacked extras
                ssl = slice(jax.process_index() * local_shards,
                            (jax.process_index() + 1) * local_shards)
                extras = tuple(x[ssl] for x in extras)
        if stacked_budget is not None:
            plan = _E.stack_plans(np.asarray(batch.ids), local_shards,
                                  budget=stacked_budget, fill=plan_fill)
            return _MH.global_batch(mesh, batch, has_fields=ffm, plan=plan,
                                    plan_mode="stacked")
        plan_mode = "global"
        if extras is not None:
            gmap, seg, svals, sex = extras
            plan = plan._replace(order=gmap, seg=seg, svals=svals, sex=sex)
            plan_mode = "global_hybrid"
        return _MH.global_batch(mesh, batch, has_fields=ffm, plan=plan,
                                plan_mode=plan_mode)

    n_examples = 0
    t0 = time.perf_counter()
    compile_time = 0.0
    from sparkfm_tpu.data.batching import prefetch
    for epoch in range(start_epoch, sgd_cfg.epochs):
        losses, overflows = [], []
        it = batch_iterator(train, sgd_cfg.batch_size,
                            shuffle=sgd_cfg.shuffle_each_epoch,
                            seed=cfg.seed, epoch=epoch,
                            drop_remainder=False)
        for i, batch in enumerate(prefetch(map(lift, it))):
            if epoch == 0 and i == 0:
                tc = time.perf_counter()
            state, aux = step_fn(state, batch)
            if epoch == 0 and i == 0:
                jax.block_until_ready(aux["loss"])
                compile_time = time.perf_counter() - tc
            losses.append(aux["loss"])
            if "unique_overflow" in aux:
                overflows.append(jnp.asarray(aux["unique_overflow"],
                                             jnp.int32))
            # batch.mask is globally sharded: np.asarray would throw on
            # non-addressable shards under multi-process — collect() does
            # the process_allgather when needed.
            n_examples += int(np.sum(_MH.collect(batch.mask))) \
                if batch.mask is not None else batch.batch_size
        rec = {"epoch": epoch,
               "train_loss": float(jnp.mean(jnp.stack(losses)))}
        if overflows:
            n_over = int(jnp.sum(jnp.stack(overflows)))
            rec["unique_overflow_steps"] = n_over
            if n_over:
                log.warning(
                    "epoch %d: %d step(s) overflowed the per-shard "
                    "unique-id budget; raise SGDConfig.unique_budget",
                    epoch, n_over)
        if eval_ds is not None and (epoch % eval_every == 0
                                    or epoch == sgd_cfg.epochs - 1):
            rec.update({f"eval_{k}": v for k, v in evaluate_sharded(
                state.params, pcfg, eval_ds, mesh, score_fn,
                sgd_cfg.batch_size).items()})
        history.append(rec)
        log.info("epoch %d: %s", epoch,
                 " ".join(f"{k}={v:.5f}" for k, v in rec.items()
                          if k != "epoch"))
        if hooks:
            for h in hooks:
                h(epoch, state, rec)
        stop = _time_budget_reached(t0, sgd_cfg.max_seconds, epoch)
        if ckpt is not None and ((epoch + 1) % checkpoint_every == 0
                                 or epoch == sgd_cfg.epochs - 1 or stop):
            ckpt.save(epoch, state,
                      extra={"epoch": epoch, "history": history})
        if stop:
            break
    if ckpt is not None:
        ckpt.close()
    elapsed = time.perf_counter() - t0 - compile_time
    eps = n_examples / max(elapsed, 1e-9)

    # Return fully-replicated host params trimmed to the true feature count
    # (drop the fill/pad rows), so the returned model predicts anywhere.
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(_MH.collect(x)), state.params)
    params = sgd_solver.trim_params(
        FMParams(w0=jnp.asarray(params.w0),
                 w=jnp.asarray(params.w[:cfg.num_features]),
                 v=jnp.asarray(params.v[:cfg.num_features])),
        cfg.num_features)
    return TrainResult(params=params, history=history,
                       examples_per_sec=eps)


def evaluate_sharded(params, pcfg: FMConfig, ds: SparseDataset, mesh,
                     score_fn, batch_size: int = 8192) -> Dict[str, float]:
    """Mesh-sharded evaluate: scores computed with the sharded score fn,
    collected to every host (multi-process safe), metrics on host."""
    from sparkfm_tpu.parallel import multihost as _MH

    all_scores: List[np.ndarray] = []
    for b in batch_iterator(ds, batch_size, shuffle=False):
        b_loc = b
        if jax.process_count() > 1:
            sl = _MH.process_batch_slice(b.batch_size)
            b_loc = dataclasses.replace(
                b, ids=b.ids[sl], vals=b.vals[sl], y=b.y[sl],
                mask=None if b.mask is None else b.mask[sl],
                field_ids=(None if b.field_ids is None
                           else b.field_ids[sl]))
        gb = _MH.global_batch(mesh, b_loc, has_fields=pcfg.num_fields > 0)
        s = score_fn(params, gb.ids, gb.vals, gb.field_ids)
        nvalid = int(np.sum(np.asarray(b.mask)))
        all_scores.append(np.asarray(_MH.collect(s))[:nvalid])
    scores = np.concatenate(all_scores)
    y = ds.y[:len(scores)]
    out: Dict[str, float] = {}
    if pcfg.task == Task.REGRESSION:
        out["rmse"] = float(np.sqrt(np.mean(np.square(scores - y))))
        out["mae"] = float(np.mean(np.abs(scores - y)))
    else:
        prob = _expit(scores)  # overflow-safe sigmoid
        y01 = (y > 0).astype(np.float64)
        eps_ = 1e-7
        p = np.clip(prob, eps_, 1 - eps_)
        out["logloss"] = float(-np.mean(y01 * np.log(p)
                                        + (1 - y01) * np.log1p(-p)))
        out["accuracy"] = float(np.mean((prob >= 0.5) == (y01 > 0.5)))
        out["auc"] = float(M.auc(jnp.asarray(scores), jnp.asarray(y)))
    return out


def train_sgd_relational(cfg: FMConfig, sgd_cfg: SGDConfig, train,
                         eval_ds=None, eval_every: int = 1,
                         key: Optional[jax.Array] = None) -> TrainResult:
    """SGD on a block-structure RelationalDataset: relation tables live on
    device and are joined by gather inside the jitted step — the working
    version of the reference's dead relational path (FMLearn.scala:14).

    eval_ds may be a RelationalDataset (materialized once for metrics) or a
    plain SparseDataset.
    """
    from sparkfm_tpu.data import relational as R

    params = fm_model.init_params(cfg, key)
    state = sgd_solver.init_state(params)
    step_fn = R.make_relational_train_step(cfg, sgd_cfg)
    tables = R.tables_to_device(train.tables)
    if eval_ds is not None and hasattr(eval_ds, "materialize"):
        eval_ds = eval_ds.materialize()
    score_fn = _eval_scores_fn(cfg)

    history: List[Dict[str, float]] = []
    n_examples = 0
    t0 = time.perf_counter()
    for epoch in range(sgd_cfg.epochs):
        losses = []
        for batch in R.relational_batch_iterator(
                train, sgd_cfg.batch_size,
                shuffle=sgd_cfg.shuffle_each_epoch, seed=cfg.seed,
                epoch=epoch):
            state, aux = step_fn(state, batch, tables)
            losses.append(aux["loss"])
            n_examples += int(jnp.sum(batch.mask)) if batch.mask is not None \
                else batch.y.shape[0]
        rec = {"epoch": epoch,
               "train_loss": float(jnp.mean(jnp.stack(losses)))}
        if eval_ds is not None and (epoch % eval_every == 0
                                    or epoch == sgd_cfg.epochs - 1):
            rec.update({f"eval_{k}": v for k, v in evaluate(
                state.params, cfg, eval_ds, sgd_cfg.batch_size,
                score_fn).items()})
        history.append(rec)
        log.info("epoch %d: %s", epoch,
                 " ".join(f"{k}={v:.5f}" for k, v in rec.items()
                          if k != "epoch"))
        if _time_budget_reached(t0, sgd_cfg.max_seconds, epoch):
            break
    eps = n_examples / max(time.perf_counter() - t0, 1e-9)
    return TrainResult(params=state.params, history=history,
                       examples_per_sec=eps)
