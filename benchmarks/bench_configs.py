"""Throughput of the non-headline BASELINE configs on one GPU.

Invoked by bench.py as BENCH_MODE=als|ffm|deepfm. Each mode stages
synthetic data at its config's published shape, compiles, warms up and
returns one result record (bench.py adds the device and prints it).
Timed regions end in ``jax.block_until_ready``.

  als     BASELINE config 2 — MovieLens-25M shape rating regression:
          rank-32 FM, full-dataset ALS sweeps (F = 162541 users + 59047
          movies = 221588 one-hot features, L = 2 slots/example),
          N = the full 25M examples by default. Reference analog: the
          driver-sequential sweep at ALS.scala:15-75; here it is the
          blocked device sweep (solvers/als.py). Value = examples swept
          / sec; sweep_ms = per-sweep wall time at the measured N.
  ffm     BASELINE config 4 — Avazu shape CTR: field-aware FM, 22 fields,
          hashed buckets (default the full 2^22), rank 8, B=8192,
          fused-record path + host ladder plans.
  deepfm  BASELINE config 5 — Criteo-shape DeepFM: 39 fields, 2^20
          buckets, rank 16, tower (256, 128), B=8192 (fused-record path
          + host ladder plans).

The reference publishes no numbers for any config (BASELINE.md), so no
record carries a baseline ratio. The ffm and deepfm records also carry
``tf32_gap``: the largest relative difference, |a-b|/(1+|b|), between
scores computed at JAX's default float32 matmul precision (which the GPU
may run in TF32) and at ``jax.default_matmul_precision("highest")``, on
one batch from the trained state.

Env knobs: BENCH_ALS_N (default 25_000_000 = the full dataset size),
BENCH_STEPS (default 2 sweeps for als, 20 steps otherwise).
"""

from __future__ import annotations

import os
import time

import numpy as np

def _tf32_gap(score_fn, *args) -> float:
    """max |a-b|/(1+|b|) of score_fn at default vs highest matmul
    precision."""
    import jax
    a = np.asarray(jax.jit(score_fn)(*args), np.float64)
    with jax.default_matmul_precision("highest"):
        b = np.asarray(jax.jit(score_fn)(*args), np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def _time_steps(step_fn, state, batches, k, s0):
    """k steps from batch s0 on; returns (state, seconds)."""
    import jax
    t0 = time.perf_counter()
    for i in range(k):
        state, aux = step_fn(state, batches[(s0 + i) % len(batches)])
    jax.block_until_ready((state, aux))
    assert np.isfinite(float(aux["loss"]))
    return state, time.perf_counter() - t0


def bench_als(hb):
    import jax

    from sparkfm_tpu.config import ALSConfig, FMConfig
    from sparkfm_tpu.data.batching import SparseDataset
    from sparkfm_tpu.models import fm as fm_model
    from sparkfm_tpu.solvers import als as A

    n = int(os.environ.get("BENCH_ALS_N", 25_000_000))
    users, movies = 162541, 59047                 # true ML-25M cardinality
    f = users + movies
    rng = np.random.default_rng(0)
    hb(f"als: generating {n:,} examples, F={f}")
    uid = rng.integers(0, users, n).astype(np.int32)
    # zipf-ish movie popularity (real ratings are head-heavy)
    mid = ((rng.zipf(1.3, size=n).astype(np.int64) * 2654435761) % movies
           ).astype(np.int32)
    ids = np.stack([uid, users + mid], axis=1)
    vals = np.ones((n, 2), np.float32)
    y = (rng.integers(1, 11, n) * 0.5).astype(np.float32)
    ds = SparseDataset(ids=ids, vals=vals, y=y, num_features=f)

    cfg = FMConfig(num_features=f, num_factors=32, reg_w=0.1, reg_v=1.0,
                   seed=0)
    als_cfg = ALSConfig(feature_blocks=A.slot_blocks(ds))
    hb("als: staging workspace on device")
    ws, nb = A.build_workspace(ds, cfg, als_cfg)
    jax.block_until_ready(ws.col_val)
    params = fm_model.init_params(cfg, jax.random.PRNGKey(0))
    rw, rv = cfg.reg_vectors() if cfg.feature_groups is not None else (
        cfg.reg_w, cfg.reg_v)

    n_ranks = int(ws.present.shape[0])
    cpure = A.blocks_are_column_pure(ds, np.asarray(ws.block_of_feat))
    uniform = cpure and A.csc_blocks_uniform(ds,
                                             np.asarray(ws.block_of_feat))
    ident = A.csc_slice_identity(ws, nb, n) if uniform else ()
    # above nnz*K = 4e8 the sweep runs as K+1 dispatches instead of one
    # jit — identical update sequence (tests/test_als.py)
    dispatched = ds.ids.size * cfg.num_factors > (4 * 10**8)
    hb(f"als: column_pure={cpure} csc_uniform={uniform} "
       f"dispatched={dispatched}")
    hb(f"als: slice_identity={ident}")
    if dispatched:
        sweep = lambda p, w: A.als_sweep_compact_dispatched(
            p, w, nb, cfg.num_features, n_ranks, cfg.reg0, rw, rv,
            column_pure=cpure, csc_uniform=uniform, slice_identity=ident)
    else:
        sweep = jax.jit(lambda p, w: A.als_sweep_compact(
            p, w, nb, cfg.num_features, n_ranks, cfg.reg0, rw, rv,
            column_pure=cpure, csc_uniform=uniform,
            slice_identity=ident))
    hb("als: compiling sweep")
    params = jax.block_until_ready(sweep(params, ws))
    k = int(os.environ.get("BENCH_STEPS", 2))
    hb(f"als: measuring ({k} sweeps)")
    t0 = time.perf_counter()
    for _ in range(k):
        params = sweep(params, ws)
    jax.block_until_ready(params)
    sw = (time.perf_counter() - t0) / k
    assert np.isfinite(float(params.w0))
    hb(f"als: {sw * 1e3:.0f} ms/sweep; done")
    return {"metric": "ml25m_shape_als_rank32_sweep_throughput",
            "value": round(n / sw, 1), "unit": "examples/sec",
            "sweep_ms": round(sw * 1e3, 1), "n_examples": n}


def _ctr_batches(rng, n_batches, batch, nnz, buckets, field_major,
                 host_plan_fill=None, ladder=None):
    """Zipf-id CTR batches (+ optional host dedup plans at a shared rung)."""
    from sparkfm_tpu.ops import embedding as E
    out = []
    rung = [1]
    cap = E.auto_budget(batch * nnz)
    for _ in range(n_batches):
        raw = rng.zipf(1.3, size=(batch, nnz)).astype(np.int64)
        ids = ((raw * 2654435761) % buckets).astype(np.int32)
        if field_major:
            # one feature per field: offset each slot into its own bucket
            # range (the synth_ctr layout)
            per = buckets // nnz
            ids = (ids % per) + per * np.arange(nnz, dtype=np.int32)[None, :]
        y = rng.integers(0, 2, (batch,)).astype(np.float32)
        hp = None
        if host_plan_fill is not None:
            hp = E.host_dedup(ids, cap, host_plan_fill)
            rung[0] = max(rung[0], E.ladder_budget(int(hp.count), cap=cap))
        out.append((ids, y, hp))
    return out, rung[0]


def bench_ffm(hb):
    import jax
    import jax.numpy as jnp

    from sparkfm_tpu.config import FMConfig, SGDConfig, Task
    from sparkfm_tpu.data.batching import SparseBatch
    from sparkfm_tpu.solvers import sgd as sgd_solver

    fields = 22
    # Default = the FULL published 2^22 Avazu table (BASELINE config 4).
    buckets = int(os.environ.get("BENCH_BUCKETS", 1 << 22))
    rank = 8
    batch = int(os.environ.get("BENCH_BATCH", 8192))
    steps = int(os.environ.get("BENCH_STEPS", 20))
    # slot_major_fields: the Avazu layout is one feature per field per
    # example (field_ids == arange), so the interaction takes the static
    # transpose form (ops/interaction.py::ffm_interaction_slot_major).
    cfg = FMConfig(num_features=buckets, num_factors=rank,
                   num_fields=fields, task=Task.CLASSIFICATION,
                   reg_v=1e-6, seed=0, slot_major_fields=True)
    sgd_cfg = SGDConfig(batch_size=batch, learning_rate=0.05,
                        optimizer="adagrad")
    path = sgd_solver.resolve_update_path(cfg, sgd_cfg)
    hb(f"ffm: path={path}, staging")
    from sparkfm_tpu.models import fm as fm_model
    if path == "fused":
        from sparkfm_tpu.solvers import sgd_fused
        state = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(0))
        step_fn = sgd_fused.make_fused_train_step(cfg, sgd_cfg)
        params_of = lambda st: sgd_fused.params_from_fused(st, cfg)
    else:
        params = fm_model.init_params(cfg, jax.random.PRNGKey(0))
        state = sgd_solver.init_state(params, optimizer=sgd_cfg.optimizer)
        if path == "dedup":
            state = sgd_solver.pad_state_for_dedup(state)
        step_fn = sgd_solver.make_train_step(cfg, sgd_cfg)
        params_of = lambda st: sgd_solver.trim_params(st.params, buckets)

    rng = np.random.default_rng(0)
    hbs, rung = _ctr_batches(rng, 6, batch, fields, buckets,
                             field_major=True,
                             host_plan_fill=buckets
                             if path in ("dedup", "fused") else None)
    from sparkfm_tpu.ops import embedding as E
    batches = []
    fid = np.broadcast_to(np.arange(fields, dtype=np.int32),
                          (batch, fields))
    for ids, y, hp in hbs:
        plan = None
        if hp is not None:
            hp = hp._replace(uids=hp.uids[:rung])
            plan = E.DedupBatch(
                uids=jnp.asarray(hp.uids), ranks=jnp.asarray(hp.ranks),
                count=jnp.asarray(hp.count),
                overflow=jnp.asarray(hp.overflow),
                order=jnp.asarray(hp.order), seg=jnp.asarray(hp.seg))
        batches.append(SparseBatch(
            ids=jnp.asarray(ids), vals=jnp.ones((batch, fields),
                                                jnp.float32),
            y=jnp.asarray(y), mask=jnp.ones((batch,), bool),
            field_ids=jnp.asarray(fid), plan=plan))
    jax.block_until_ready(batches)
    hb("ffm: compiling step")
    state, _ = _time_steps(step_fn, state, batches, 4, 0)
    hb(f"ffm: measuring ({steps} steps)")
    state, dt = _time_steps(step_fn, state, batches, steps, 4)
    b0 = batches[0]
    gap = _tf32_gap(lambda p, ids, vals, fid: fm_model.scores(
        p, cfg, ids, vals, fid), params_of(state), b0.ids, b0.vals,
        b0.field_ids)
    hb(f"ffm: {steps * batch / dt:,.0f} ex/s, tf32_gap {gap:.3g}; done")
    return {"metric": "avazu_shape_ffm_rank8_train_throughput",
            "value": round(steps * batch / dt, 1), "unit": "examples/sec",
            "step_ms": round(dt / steps * 1e3, 3), "update_path": path,
            "tf32_gap": gap}


def bench_deepfm(hb):
    import jax
    import jax.numpy as jnp

    from sparkfm_tpu.config import FMConfig, SGDConfig, Task
    from sparkfm_tpu.data.batching import SparseBatch
    from sparkfm_tpu.models import deepfm as DF

    fields = 39
    buckets = 1 << 20
    batch = int(os.environ.get("BENCH_BATCH", 8192))
    steps = int(os.environ.get("BENCH_STEPS", 20))
    cfg = DF.DeepFMConfig(
        fm=FMConfig(num_features=buckets, num_factors=16,
                    num_fields=fields, task=Task.CLASSIFICATION,
                    reg_v=1e-6, seed=0),
        hidden=(256, 128))
    sgd_cfg = SGDConfig(batch_size=batch, learning_rate=0.05,
                        optimizer="adagrad")
    path = DF.resolve_deepfm_path(cfg, sgd_cfg)
    hb(f"deepfm: path={path}, staging")
    if path == "fused":
        state = DF.init_fused_deepfm_state(cfg, jax.random.PRNGKey(0))
        params_of = lambda st: DF.params_from_fused_deepfm(st, cfg)
    else:
        state = DF.pad_deepfm_state_for_dedup(
            DF.init_state(DF.init_params(cfg, jax.random.PRNGKey(0))))
        params_of = lambda st: st["params"]
    step_fn = DF.make_train_step(cfg, sgd_cfg)

    rng = np.random.default_rng(0)
    hbs, rung = _ctr_batches(rng, 6, batch, fields, buckets,
                             field_major=True, host_plan_fill=buckets)
    from sparkfm_tpu.ops import embedding as E
    batches = []
    for ids, y, hp in hbs:
        hp = hp._replace(uids=hp.uids[:rung])
        plan = E.DedupBatch(
            uids=jnp.asarray(hp.uids), ranks=jnp.asarray(hp.ranks),
            count=jnp.asarray(hp.count), overflow=jnp.asarray(hp.overflow),
            order=jnp.asarray(hp.order), seg=jnp.asarray(hp.seg))
        batches.append(SparseBatch(
            ids=jnp.asarray(ids),
            vals=jnp.ones((batch, fields), jnp.float32),
            y=jnp.asarray(y), mask=jnp.ones((batch,), bool), plan=plan))
    jax.block_until_ready(batches)
    hb("deepfm: compiling step")
    state, _ = _time_steps(step_fn, state, batches, 4, 0)
    hb(f"deepfm: measuring ({steps} steps)")
    state, dt = _time_steps(step_fn, state, batches, steps, 4)
    b0 = batches[0]
    gap = _tf32_gap(lambda p, ids, vals: DF.scores(p, cfg, ids, vals),
                    params_of(state), b0.ids, b0.vals)
    hb(f"deepfm: {steps * batch / dt:,.0f} ex/s, tf32_gap {gap:.3g}; "
       "done")
    return {"metric": "criteo_shape_deepfm16_train_throughput",
            "value": round(steps * batch / dt, 1), "unit": "examples/sec",
            "step_ms": round(dt / steps * 1e3, 3), "update_path": path,
            "tf32_gap": gap}


def run_config_bench(mode: str, hb) -> dict:
    return {"als": bench_als, "ffm": bench_ffm,
            "deepfm": bench_deepfm}[mode](hb)
