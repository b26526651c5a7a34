"""Smoke run of the FM training and serving path on the GPU.

    python chip_smoke.py             # one card
    python chip_smoke.py --chips 4   # four cards: sharded training only

One card runs these phases in order:

  device  fails unless JAX's default backend is a GPU; prints the devices,
          the JAX version and the card's name and power limit.
  train   BASELINE config 3 (Criteo-shape logistic FM: rank 32, 2^24
          hashed buckets, 39 fields, adagrad, batch 16384) through the
          ``FM`` facade and the trainer: host dedup plans from the native
          planner, the budget ladder, prefetch, the hybrid update path.
          Four epochs of five steps; the last epoch's mean loss must be
          below the first's.
  serve   the trained model behind ``MicroBatcher``: requests of mixed
          sizes, each score checked against a float64 NumPy FM.
  parity  each plain-XLA reduction on the hybrid path at the train
          phase's shapes, against float64 NumPy; one hybrid step against
          one direct-path step from the same state and (padded-plan)
          batch; segment_colsums at the ALS shape.
  als     ``FM(solver="als")`` on a MovieLens-1M-shape set for 2 sweeps;
          the RMSE must fall below its value at initialization.

``--chips 4`` runs only the sharded path: the train configuration on a
(data=2, model=2) mesh for 10 steps with the global exchange and hybrid
extras, against the same 10 steps on one card.

Every phase raises on failure, so the script then exits non-zero and
never prints the last line, which is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Lines that carry a number end with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# Every comparison: max |a - b| / (1 + |b|) <= TOL. All of these paths
# compute in float32 and contain no matrix product, so TF32 does not
# apply; the slack is for float32 summation order, which for GPU
# scatter-adds (atomics) changes from run to run. The reductions' own
# checks feed them small integers and halves, whose float32 sums over
# runs of thousands of slots are exact in any order: a float32 sum of
# thousands of arbitrary values can itself drift by ~1e-4 from float64.
TOL = 1e-4

CRITEO = dict(num_features=1 << 24, num_factors=32, num_fields=39,
              batch=16384)
# Per-appearance adagrad sums the squared gradients of every slot that
# touches a row, so a head feature seen in a quarter of the batch moves
# ~lr * sqrt(4000) per step: 0.002 keeps the synthetic CTR loss monotone.
LR = 0.002


def rel_err(a, b) -> float:
    """max |a - b| / (1 + |b|), in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise AssertionError(f"shape {a.shape} != {b.shape}")
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def check(name: str, err: float, say) -> None:
    say(f"{name}: rel err {err:.3g} (tol {TOL:g})")
    if not err <= TOL:
        raise AssertionError(f"{name}: rel err {err} > {TOL}")


def segment_sum_np(rows, seg, num_segments):
    """float64 per-rank sums of rows over SORTED seg (np.add.reduceat)."""
    rows = np.asarray(rows, np.float64)
    seg = np.asarray(seg)
    out = np.zeros((num_segments,) + rows.shape[1:], np.float64)
    if seg.size:
        starts = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
        out[seg[starts]] = np.add.reduceat(rows, starts, axis=0)
    return out


def fm_scores_np(w0, w, v, ids, vals):
    """float64 FM scores: w0 + Σ w x + ½ Σ_f ((Σ v x)² − Σ v² x²)."""
    x = np.asarray(vals, np.float64)
    wr = np.asarray(w, np.float64)[ids]
    vx = np.asarray(v, np.float64)[ids] * x[..., None]
    s = vx.sum(axis=1)
    return (float(w0) + (wr * x).sum(axis=1)
            + 0.5 * (np.square(s).sum(axis=1) - np.square(vx).sum(axis=(1, 2))))


def fm_grad_segsum_np(vw_u, ex, x, seg, num_segments, cv, cw):
    """float64 oracle of ops/segsum.fm_grad_segsum_factored."""
    vw = np.asarray(vw_u, np.float64)[seg]
    ex = np.asarray(ex, np.float64)
    x = np.asarray(x, np.float64)
    k = vw.shape[1] - 1
    active = np.where(x != 0, ex[:, k + 1], 0.0)
    dsx = ex[:, k] * x
    g_v = dsx[:, None] * (ex[:, :k] - vw[:, :k] * x[:, None]) \
        + cv * vw[:, :k] * active[:, None]
    g_w = dsx + cw * vw[:, k] * active
    g = np.concatenate([g_v, g_w[:, None]], axis=1)
    return segment_sum_np(np.concatenate([g, g * g], axis=1), seg,
                          num_segments)


def dense_ranks(sorted_ids):
    """Dense ranks of sorted ids (the plans' ``seg`` contract)."""
    sorted_ids = np.asarray(sorted_ids)
    step = np.r_[0, (sorted_ids[1:] != sorted_ids[:-1]).astype(np.int64)]
    return np.cumsum(step).astype(np.int32)


def padded_plan(ids, vals, fill):
    """Host dedup plan padded to the ladder rung above count + 1, so at
    least one unused budget slot carries the fill id."""
    from sparkfm_tpu.ops import embedding as E
    cap = E.auto_budget(ids.size)
    hp = E.host_dedup(ids, cap, fill, vals=vals)
    rung = E.ladder_budget(int(hp.count) + 1, cap=cap)
    return hp._replace(uids=hp.uids[:rung]), rung


def fm_grad_segsum_error(seg, num_segments, k, seed=0) -> float:
    """ops/segsum.fm_grad_segsum_factored on random payloads over a real
    plan's ranks vs the float64 oracle. Values in {-1, 0, 1} and L2
    coefficients of 1/2 keep every float32 partial sum exact (TOL)."""
    import jax
    import jax.numpy as jnp
    from sparkfm_tpu.ops import segsum as SS
    rng = np.random.default_rng(seed)
    n = seg.shape[0]
    unit = lambda *shape: rng.integers(-1, 2, shape).astype(np.float32)
    vw_u = unit(num_segments, k + 1)
    ex = unit(n, k + 2)
    ex[:, k + 1] = rng.integers(0, 2, n)                 # example weights
    x = unit(n)                                          # 1/3 are zero
    cv, cw = 0.5, -0.5
    fn = jax.jit(SS.fm_grad_segsum_factored, static_argnums=(4,))
    got = fn(jnp.asarray(vw_u), jnp.asarray(ex), jnp.asarray(x),
             jnp.asarray(seg), num_segments, cv, cw)
    return rel_err(got, fm_grad_segsum_np(vw_u, ex, x, seg, num_segments,
                                          cv, cw))


def colsums_error(seg, num_segments, n_streams=5, seed=0) -> float:
    """ops/segsum.segment_colsums vs the float64 oracle, on small
    integer streams (exact float32 sums, see TOL)."""
    import jax
    import jax.numpy as jnp
    from sparkfm_tpu.ops import segsum as SS
    rng = np.random.default_rng(seed)
    streams = [rng.integers(-4, 5, seg.shape[0]).astype(np.float32)
               for _ in range(n_streams)]
    fn = jax.jit(SS.segment_colsums, static_argnums=(2,))
    got = fn([jnp.asarray(s) for s in streams], jnp.asarray(seg),
             num_segments)
    return rel_err(got, segment_sum_np(np.stack(streams, axis=1), seg,
                                       num_segments))


def _device_rel_err(a, b) -> float:
    import jax.numpy as jnp
    return float(jnp.max(jnp.abs(a - b) / (1.0 + jnp.abs(b))))


def hybrid_vs_direct(cfg, sgd_cfg, params, ids, vals, y) -> dict:
    """One hybrid step (fused record, analytic sorted backward) and one
    direct-path step (plain gather/scatter on the (F, K) tables) from the
    same parameters and batch; the hybrid batch carries a padded host
    plan. Returns the relative errors of loss, w0, w and v."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from sparkfm_tpu.data.batching import SparseBatch
    from sparkfm_tpu.ops import embedding as E
    from sparkfm_tpu.solvers import sgd as sgd_solver
    from sparkfm_tpu.solvers import sgd_fused, sgd_hybrid

    F = cfg.num_features
    hp, _ = padded_plan(ids, vals, fill=F)
    plan = E.DedupBatch(*(None if a is None else jnp.asarray(a)
                          for a in hp))
    batch = SparseBatch(ids=jnp.asarray(ids), vals=jnp.asarray(vals),
                        y=jnp.asarray(y),
                        mask=jnp.ones((ids.shape[0],), bool))
    dparams = jax.tree_util.tree_map(jnp.copy, params)  # steps donate
    hstate = sgd_fused.fused_from_params(params, cfg)
    hstep = sgd_hybrid.make_hybrid_train_step(cfg, sgd_cfg)
    hstate, haux = hstep(hstate, dataclasses.replace(batch, plan=plan))
    hp_out = sgd_fused.params_from_fused(hstate, cfg)

    dcfg = dataclasses.replace(sgd_cfg, update_path="direct")
    dstate = sgd_solver.init_state(dparams, optimizer=sgd_cfg.optimizer)
    dstep = sgd_solver.make_train_step(cfg, dcfg)
    dstate, daux = dstep(dstate, batch)
    dp = dstate.params
    return {"loss": rel_err(haux["loss"], daux["loss"]),
            "w0": rel_err(hp_out.w0, dp.w0),
            "w": _device_rel_err(hp_out.w, dp.w),
            "v": _device_rel_err(hp_out.v, dp.v)}


def serve_error(model, requests) -> float:
    """Score ``requests`` [(ids, vals)] through MicroBatcher and compare
    each with the float64 NumPy FM on the same rows."""
    from scipy.special import expit
    import sparkfm_tpu as sfm
    mb = sfm.MicroBatcher(model.params, model.cfg)
    for ids, vals in requests:
        mb.submit(ids, vals)
    outs = mb.flush()
    p = model.params
    w, v = np.asarray(p.w), np.asarray(p.v)
    err = 0.0
    for (ids, vals), got in zip(requests, outs):
        want = fm_scores_np(np.asarray(p.w0), w, v, ids, vals)
        if model.cfg.task == sfm.Task.CLASSIFICATION:
            want = expit(want)
        err = max(err, rel_err(got, want))
    return err


def mesh_vs_single(cfg, sgd_cfg, mesh, batches, key) -> tuple:
    """The sharded train step (global exchange + hybrid extras, batches
    lifted as the trainer lifts them) against the single-device hybrid
    step on one card, from the same initial parameters. ``batches`` is a
    list of host (ids, vals, y). Returns (errors, sharded state)."""
    import jax
    import jax.numpy as jnp
    from sparkfm_tpu.data.batching import SparseBatch
    from sparkfm_tpu.models.fm import FMParams
    from sparkfm_tpu.ops import embedding as E
    from sparkfm_tpu.parallel import mesh as M
    from sparkfm_tpu.parallel import multihost as MH
    from sparkfm_tpu.parallel import sharded_sgd
    from sparkfm_tpu.solvers import sgd_fused, sgd_hybrid

    F = cfg.num_features
    d = mesh.shape[M.DATA_AXIS]
    sstate, pcfg = sharded_sgd.init_sharded_state(cfg, mesh, key)
    sstep = sharded_sgd.make_sharded_train_step(pcfg, sgd_cfg, mesh,
                                                exchange="global")
    one = mesh.devices.flat[0]
    p0 = sstate.params
    # copies: both steps donate their state
    params = FMParams(*(jnp.copy(jax.device_put(a, one))
                        for a in (p0.w0, p0.w[:F], p0.v[:F])))
    state1 = sgd_fused.fused_from_params(params, cfg)
    step1 = sgd_hybrid.make_hybrid_train_step(cfg, sgd_cfg)

    cap = E.auto_budget(batches[0][0].size)
    rung_s = rung_1 = u_cap = 1
    loss_s, loss_1 = [], []
    for ids, vals, y in batches:
        mask = np.ones((ids.shape[0],), bool)
        hp = E.host_dedup(ids, cap, pcfg.num_features - 1)
        rung_s = max(rung_s, E.ladder_budget(int(hp.count), cap=cap))
        seg, svals, sex, gmap, u_cap = E.stack_hybrid_extras(
            hp.ranks, vals, d, u_cap=u_cap)
        plan = hp._replace(uids=hp.uids[:rung_s], order=gmap, seg=seg,
                           svals=svals, sex=sex)
        gb = MH.global_batch(mesh, SparseBatch(ids=ids, vals=vals, y=y,
                                               mask=mask),
                             plan=plan, plan_mode="global_hybrid")
        sstate, saux = sstep(sstate, gb)
        loss_s.append(saux["loss"])

        hp1 = E.host_dedup(ids, cap, F, vals=vals)
        rung_1 = max(rung_1, E.ladder_budget(int(hp1.count), cap=cap))
        hp1 = hp1._replace(uids=hp1.uids[:rung_1])
        put = lambda a: jax.device_put(a, one)
        b1 = SparseBatch(ids=put(ids), vals=put(vals), y=put(y),
                         mask=put(mask),
                         plan=E.DedupBatch(*(None if a is None else put(a)
                                             for a in hp1)))
        state1, aux1 = step1(state1, b1)
        loss_1.append(aux1["loss"])

    p1 = sgd_fused.params_from_fused(state1, cfg)
    ps = sstate.params
    errs = {"loss": rel_err(np.asarray(loss_s), np.asarray(loss_1)),
            "w0": rel_err(ps.w0, p1.w0),
            "w": rel_err(ps.w[:F], p1.w),
            "v": rel_err(ps.v[:F], p1.v)}
    return errs, sstate


def phase_device(chips: int):
    import jax
    from sparkfm_tpu.utils.device import gpu_line, require_gpu
    device = require_gpu()
    if device["count"] < chips:
        raise RuntimeError(f"--chips {chips} needs {chips} GPUs, JAX sees "
                           f"{device['count']}")
    card = gpu_line()
    print(f"device: {jax.devices()}  jax {jax.__version__}  card {card}",
          flush=True)

    def say(msg):
        print(f"{msg}  [{card}]", flush=True)

    return device, say


def phase_train(say, num_features=CRITEO["num_features"],
                num_factors=CRITEO["num_factors"],
                num_fields=CRITEO["num_fields"], batch=CRITEO["batch"],
                steps_per_epoch=5, epochs=4):
    """Returns (model, holdout dataset)."""
    import sparkfm_tpu as sfm
    from sparkfm_tpu.data import native_io, synth
    from sparkfm_tpu.solvers import sgd as sgd_solver

    n_train = steps_per_epoch * batch
    ds = synth.synth_ctr(num_examples=n_train + batch, num_fields=num_fields,
                         num_buckets=num_features, seed=0)
    train = ds.slice(np.arange(n_train))
    holdout = ds.slice(np.arange(n_train, n_train + batch))
    fm = sfm.FM(num_factors=num_factors, task=sfm.Task.CLASSIFICATION,
                solver="sgd", max_iter=epochs, batch_size=batch,
                optimizer="adagrad", learning_rate=LR, reg_w=1e-6,
                reg_v=1e-6, num_features=num_features, seed=0)
    cfg = sfm.FMConfig(num_features=num_features, num_factors=num_factors,
                       task=sfm.Task.CLASSIFICATION)
    path = sgd_solver.resolve_update_path(
        cfg, sfm.SGDConfig(optimizer="adagrad", batch_size=batch))
    print(f"update path: {path}", flush=True)
    if path != "hybrid":
        raise AssertionError(f"update path {path!r}, expected 'hybrid'")
    native = native_io.dedup_available()
    asked_off = bool(os.environ.get("SPARKFM_NO_NATIVE"))
    print(f"native planner loaded: {native}"
          + (" (SPARKFM_NO_NATIVE set)" if asked_off else ""), flush=True)
    if not native and not asked_off:
        raise AssertionError("native dedup planner did not load")

    t0 = time.perf_counter()
    model = fm.fit(train)
    wall = time.perf_counter() - t0
    losses = [h["train_loss"] for h in model.history]
    say(f"train: epoch losses {[round(x, 6) for x in losses]}, "
        f"{epochs * steps_per_epoch} steps in {wall:.1f} s wall "
        "(first compile included)")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: last 5 steps {losses[-1]}"
                             f" >= first 5 steps {losses[0]}")
    eps = model.examples_per_sec
    say(f"train: {batch / eps * 1e3:.2f} ms/step, {eps:,.0f} examples/s "
        "(trainer-driven, host planning overlapped; information only)")
    metrics = model.evaluate(holdout)
    say(f"train: holdout {metrics}")
    if not all(np.isfinite(list(metrics.values()))):
        raise AssertionError(f"non-finite holdout metrics {metrics}")
    return model, holdout


def phase_serve(say, model, holdout,
                sizes=(1, 3, 64, 257, 1000, 4096, 2048, 17)):
    rows = np.cumsum((0,) + tuple(sizes))
    if rows[-1] > holdout.num_examples:
        raise ValueError("holdout too small for the request sizes")
    requests = [(holdout.ids[a:b], holdout.vals[a:b])
                for a, b in zip(rows[:-1], rows[1:])]
    check(f"serve: MicroBatcher vs float64 FM, {len(sizes)} requests of "
          f"{list(sizes)} rows", serve_error(model, requests), say)


def phase_parity(say, num_features=CRITEO["num_features"],
                 num_factors=CRITEO["num_factors"],
                 num_fields=CRITEO["num_fields"], batch=CRITEO["batch"],
                 als_slots=4 << 20):
    import jax
    import sparkfm_tpu as sfm
    from sparkfm_tpu.data import synth
    from sparkfm_tpu.models import fm as fm_model

    ds = synth.synth_ctr(num_examples=batch, num_fields=num_fields,
                         num_buckets=num_features, seed=1)
    hp, rung = padded_plan(ds.ids, ds.vals, fill=num_features)
    n = ds.ids.size
    check(f"parity: fm_grad_segsum_factored N={n} U={rung} "
          f"(count {int(hp.count)}) k={num_factors}",
          fm_grad_segsum_error(hp.seg, rung, num_factors), say)

    cfg = sfm.FMConfig(num_features=num_features, num_factors=num_factors,
                       task=sfm.Task.CLASSIFICATION, reg_w=1e-2,
                       reg_v=1e-2, seed=3)
    sgd_cfg = sfm.SGDConfig(batch_size=batch, learning_rate=LR,
                            optimizer="adagrad")
    params = fm_model.init_params(cfg, jax.random.PRNGKey(3))
    errs = hybrid_vs_direct(cfg, sgd_cfg, params, ds.ids, ds.vals, ds.y)
    for name, err in errs.items():
        check(f"parity: hybrid step vs direct step, {name}", err, say)

    rng = np.random.default_rng(2)
    feats = np.sort(rng.zipf(1.3, size=als_slots) % 221588)
    seg = dense_ranks(feats)
    u = int(seg[-1]) + 1
    check(f"parity: segment_colsums 5 streams N={als_slots} U={u}",
          colsums_error(seg, u), say)


def phase_als(say, num_users=6040, num_items=3706, num_examples=1_000_000,
              num_factors=32, sweeps=2):
    import jax
    import sparkfm_tpu as sfm
    from sparkfm_tpu.data import synth
    from sparkfm_tpu.models import fm as fm_model

    ds = synth.synth_movielens(num_users=num_users, num_items=num_items,
                               num_examples=num_examples, seed=1)
    fm = sfm.FM(solver="als", num_factors=num_factors, max_iter=sweeps,
                reg_v=1.0, seed=0)
    t0 = time.perf_counter()
    model = fm.fit(ds)
    wall = time.perf_counter() - t0
    init = sfm.FMModel(params=fm_model.init_params(model.cfg,
                                                   jax.random.PRNGKey(0)),
                       cfg=model.cfg)
    r0, r1 = init.compute_rmse(ds), model.compute_rmse(ds)
    say(f"als: {num_examples} examples, {sweeps} sweeps in {wall:.1f} s "
        f"wall (compile included); rmse {r0:.4f} at init -> {r1:.4f}")
    if not (np.isfinite(r1) and r1 < r0):
        raise AssertionError(f"als rmse {r1} not below init {r0}")


def phase_mesh(say, num_features=CRITEO["num_features"],
               num_factors=CRITEO["num_factors"],
               num_fields=CRITEO["num_fields"], batch=CRITEO["batch"],
               steps=10, devices=None):
    import jax
    import sparkfm_tpu as sfm
    from sparkfm_tpu.data import synth
    from sparkfm_tpu.parallel import mesh as M

    mesh = M.make_mesh(2, 2, devices=devices)
    ds = synth.synth_ctr(num_examples=steps * batch, num_fields=num_fields,
                         num_buckets=num_features, seed=4)
    batches = [(ds.ids[i * batch:(i + 1) * batch],
                ds.vals[i * batch:(i + 1) * batch],
                ds.y[i * batch:(i + 1) * batch]) for i in range(steps)]
    cfg = sfm.FMConfig(num_features=num_features, num_factors=num_factors,
                       task=sfm.Task.CLASSIFICATION, reg_w=1e-6,
                       reg_v=1e-6, seed=0)
    sgd_cfg = sfm.SGDConfig(batch_size=batch, learning_rate=LR,
                            optimizer="adagrad")
    t0 = time.perf_counter()
    errs, sstate = mesh_vs_single(cfg, sgd_cfg, mesh, batches,
                                  jax.random.PRNGKey(0))
    say(f"mesh: {steps} steps on a (data=2, model=2) mesh and on one card "
        f"in {time.perf_counter() - t0:.1f} s wall (compile included)")
    n_dev = len(sstate.params.v.sharding.device_set)
    print(f"mesh: V table spans {n_dev} devices", flush=True)
    if n_dev != 4:
        raise AssertionError(f"V table on {n_dev} devices, expected 4")
    for dev in mesh.devices.flat:
        stats = dev.memory_stats() or {}
        say(f"mesh: {dev} bytes_in_use {stats.get('bytes_in_use')}")
    for name, err in errs.items():
        check(f"mesh: sharded vs one card after {steps} steps, {name}",
              err, say)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    device, say = phase_device(args.chips)
    from sparkfm_tpu.utils.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    if args.chips == 4:
        phase_mesh(say)
    else:
        model, holdout = phase_train(say)
        phase_serve(say, model, holdout)
        del model
        phase_parity(say)
        phase_als(say)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
