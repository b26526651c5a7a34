"""Benchmark: Criteo-shape logistic FM training throughput on one GPU.

Prints ONE final JSON line (stdout):
  {"metric": "...", "value": N, "unit": "examples/sec",
   "device": {"platform", "kind", "count"}, "card": "<name>, <power limit>"}

Config matches BASELINE.json config 3: hashed sparse features, rank-32
logistic FM, adagrad SGD with sparse row updates. The reference publishes
no numbers (BASELINE.md), so the line carries no baseline ratio.

Everything runs in this one process, which holds the card. Timed regions
end in ``jax.block_until_ready`` on the final state. Batches (with their
host dedup plans) are staged before timing, so the host planner is not
on the clock. Phase heartbeats go to stderr; stdout is the one JSON line.
A run that finds no GPU exits non-zero before measuring anything.

Env knobs (all optional):
  BENCH_MODE      unset (default) = training throughput; "score" =
                  serving throughput of models/fm.scores with host
                  ladder plans (BENCH_HOSTPLAN=0: device-dedup fallback);
                  "als" | "ffm" | "deepfm" = the other BASELINE configs
                  (benchmarks/bench_configs.py): ALS sweep-time at ML-25M
                  shape, FFM / DeepFM train throughput at their config
                  shapes.
  BENCH_BUCKETS   feature buckets (default 2^22)
  BENCH_BATCH     batch size      (default 16384)
  BENCH_NNZ       actives/example (default 39, the Criteo field count)
  BENCH_RANK      factors         (default 32)
  BENCH_STEPS     timed steps (default 60)
  BENCH_OPT       optimizer: adagrad (default) | adagrad_row | sgd
  BENCH_DIST      id distribution: zipf (default; Criteo-like) | uniform
  BENCH_PATH      update path: auto (default) | direct | dedup | fused |
                  sorted | hybrid
  BENCH_HOSTPLAN  1 (default) = batches carry host-computed dedup plans
                  (the production input pipeline computes these overlapped
                  with device compute — data.batching.prefetch); 0 = the
                  step dedups on device
  BENCH_BUDGET    unique-id budget U. Default "ladder" = the library's
                  auto behavior (ops.embedding.ladder_budget): each
                  pre-staged batch's plan is padded to the coarse rung
                  just above its ACTUAL unique count, exactly what
                  trainer-driven host plans do. Overflow is impossible by
                  construction and still asserted 0. A numeric value pins
                  a static budget.
  BENCH_GROUP     hybrid steps per dispatch (default 2; lax.scan over
                  stacked staged batches — SGDConfig.steps_per_dispatch;
                  1 = single-step)
"""

import json
import os
import sys
import time

import numpy as np

_T0 = time.time()


def hb(msg: str) -> None:
    """Phase heartbeat on stderr (never stdout — stdout is the one JSON
    line contract)."""
    print(f"[bench +{time.time() - _T0:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def bench_score(cfg, batch, nnz, buckets, steps):
    """Serving-path throughput: models/fm.scores with host ladder dedup
    plans (the serving pipeline precomputes them like training;
    BENCH_HOSTPLAN=0 measures the device-dedup fallback). Requests are
    independent, so calls are pipelined and the window ends when the
    last score is ready."""
    import jax
    import jax.numpy as jnp

    from sparkfm_tpu.models import fm as fm_model
    from sparkfm_tpu.ops import embedding as E

    params = fm_model.init_params(cfg, jax.random.PRNGKey(0))
    score_fn = jax.jit(lambda p, ids, vals, plan: fm_model.scores(
        p, cfg, ids, vals, plan=plan))
    use_plan = os.environ.get("BENCH_HOSTPLAN", "1") == "1"
    rng = np.random.default_rng(0)
    cap = E.auto_budget(batch * nnz)
    rung = 1
    hbs = []
    hb("staging score batches")
    for _ in range(8):
        ids = ((rng.zipf(1.3, size=(batch, nnz)).astype(np.int64)
                * 2654435761) % buckets).astype(np.int32)
        hp = None
        if use_plan:
            hp = E.host_dedup(ids, cap, fill=buckets - 1)
            rung = max(rung, E.ladder_budget(int(hp.count), cap=cap))
        hbs.append((ids, hp))
    staged = []
    for ids, hp in hbs:
        plan = None
        if hp is not None:
            plan = E.DedupBatch(
                uids=jnp.asarray(hp.uids[:rung]),
                ranks=jnp.asarray(hp.ranks),
                count=jnp.asarray(hp.count),
                overflow=jnp.asarray(hp.overflow), order=None, seg=None)
        staged.append((jnp.asarray(ids), plan))
    vals = jnp.ones((batch, nnz), jnp.float32)
    hb("compiling score fn")
    jax.block_until_ready(score_fn(params, staged[0][0], vals,
                                   staged[0][1]))
    outs = [score_fn(params, ids, vals, plan) for ids, plan in staged]
    jax.block_until_ready(outs)
    hb(f"measuring ({steps} calls)")
    t0 = time.perf_counter()
    outs = [score_fn(params, staged[i % 8][0], vals, staged[i % 8][1])
            for i in range(steps)]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    assert all(np.isfinite(np.asarray(o[:8])).all() for o in outs[-2:])
    return {"metric": "criteo_logistic_fm_rank32_score_throughput",
            "value": round(steps * batch / dt, 1), "unit": "examples/sec",
            "call_ms": round(dt / steps * 1e3, 3)}


def bench_train(cfg, batch, nnz, buckets, steps):
    import jax
    import jax.numpy as jnp

    from sparkfm_tpu.config import SGDConfig
    from sparkfm_tpu.data.batching import SparseBatch
    from sparkfm_tpu.models import fm as fm_model
    from sparkfm_tpu.ops import embedding as E
    from sparkfm_tpu.solvers import sgd as sgd_solver

    dist = os.environ.get("BENCH_DIST", "zipf")
    budget_env = os.environ.get("BENCH_BUDGET", "ladder")
    budget = 0 if budget_env == "ladder" else int(budget_env)
    sgd_cfg = SGDConfig(batch_size=batch, learning_rate=0.05,
                        optimizer=os.environ.get("BENCH_OPT", "adagrad"),
                        update_path=os.environ.get("BENCH_PATH", "auto"),
                        unique_budget=budget)

    resolved = sgd_solver.resolve_update_path(cfg, sgd_cfg)
    hb(f"update path: {resolved}")
    if resolved in ("fused", "sorted", "hybrid"):
        from sparkfm_tpu.solvers import sgd_fused
        state = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(0))
        if resolved == "sorted":
            from sparkfm_tpu.solvers import sgd_sorted
            step_fn = sgd_sorted.make_sorted_train_step(cfg, sgd_cfg)
        elif resolved == "hybrid":
            from sparkfm_tpu.solvers import sgd_hybrid
            step_fn = sgd_hybrid.make_hybrid_train_step(cfg, sgd_cfg)
        else:
            step_fn = sgd_fused.make_fused_train_step(cfg, sgd_cfg)
    else:
        params = fm_model.init_params(cfg, jax.random.PRNGKey(0))
        state = sgd_solver.init_state(params)
        if resolved == "dedup":
            state = sgd_solver.pad_state_for_dedup(state)
        step_fn = sgd_solver.make_train_step(cfg, sgd_cfg)

    rng = np.random.default_rng(0)
    n_batches = 8
    host_plan = os.environ.get("BENCH_HOSTPLAN", "1") == "1" and resolved in (
        "dedup", "fused", "hybrid")

    # Ladder mode mirrors the trainer's host-plan auto behavior: size every
    # plan to the shared monotonic rung above the actual unique counts.
    ladder = budget == 0
    ladder_cap = E.auto_budget(batch * nnz)
    rung = 1

    hb("staging batches")
    host_batches = []
    for _ in range(n_batches):
        if dist == "uniform":
            ids = rng.integers(0, buckets, (batch, nnz)).astype(np.int32)
        else:
            raw = rng.zipf(1.3, size=(batch, nnz)).astype(np.int64)
            ids = ((raw * 2654435761) % buckets).astype(np.int32)
        y = rng.integers(0, 2, (batch,)).astype(np.float32)
        vals = np.ones((batch, nnz), np.float32)
        hp = None
        if host_plan:
            hp = E.host_dedup(ids, ladder_cap if ladder else budget,
                              fill=buckets, vals=vals)
            if ladder:
                rung = max(rung, E.ladder_budget(int(hp.count),
                                                 cap=ladder_cap))
        host_batches.append((ids, vals, y, hp))

    def stage(ids, vals, y, hp):
        plan = None
        if hp is not None:
            if ladder:
                # all batches share the final monotonic rung -> one compile
                hp = hp._replace(uids=hp.uids[:rung])
            plan = E.DedupBatch(
                uids=jnp.asarray(hp.uids), ranks=jnp.asarray(hp.ranks),
                count=jnp.asarray(hp.count),
                overflow=jnp.asarray(hp.overflow),
                order=jnp.asarray(hp.order), seg=jnp.asarray(hp.seg),
                svals=jnp.asarray(hp.svals), sex=jnp.asarray(hp.sex))
        return SparseBatch(ids=jnp.asarray(ids), vals=jnp.asarray(vals),
                           y=jnp.asarray(y),
                           mask=jnp.ones((batch,), bool), plan=plan)

    batches = [stage(*hbt) for hbt in host_batches]
    jax.block_until_ready(batches)

    # Multi-step dispatch (hybrid only): scan BENCH_GROUP staged batches
    # per jitted call.
    group = int(os.environ.get("BENCH_GROUP", "2"))
    per_call = batch
    if group > 1 and resolved == "hybrid":
        from sparkfm_tpu.solvers import sgd_hybrid
        step_fn = sgd_hybrid.make_hybrid_multi_step(cfg, sgd_cfg, group)
        assert n_batches % group == 0
        batches = [sgd_hybrid.stack_batches(batches[i:i + group])
                   for i in range(0, n_batches, group)]
        n_batches = len(batches)
        per_call = batch * group
        steps = max(1, steps // group)
        hb(f"grouped: {group} steps/dispatch")

    hb("compiling train step")
    state, aux = step_fn(state, batches[0])
    jax.block_until_ready((state, aux))
    hb("warmup")
    for i in range(2):
        state, aux = step_fn(state, batches[(i + 1) % n_batches])
    jax.block_until_ready((state, aux))

    hb(f"measuring ({steps} dispatches)")
    t0 = time.perf_counter()
    for i in range(steps):
        state, aux = step_fn(state, batches[(3 + i) % n_batches])
    jax.block_until_ready((state, aux))
    dt = time.perf_counter() - t0
    assert np.isfinite(float(aux["loss"]))
    if "unique_overflow" in aux:
        assert not bool(aux["unique_overflow"]), (
            "unique budget overflowed — raise BENCH_BUDGET")
    return {"metric": "criteo_logistic_fm_rank32_train_throughput",
            "value": round(steps * per_call / dt, 1),
            "unit": "examples/sec", "update_path": resolved,
            "step_ms": round(dt / (steps * per_call / batch) * 1e3, 3)}


def main() -> int:
    hb("importing jax")
    from sparkfm_tpu.utils.compile_cache import enable_compile_cache
    from sparkfm_tpu.utils.device import gpu_line, require_gpu

    device = require_gpu()
    card = gpu_line()
    enable_compile_cache()
    hb(f"device {device}; card {card}")

    from sparkfm_tpu.config import FMConfig, Task

    mode = os.environ.get("BENCH_MODE", "")
    if mode in ("als", "ffm", "deepfm"):
        from benchmarks.bench_configs import run_config_bench
        rec = run_config_bench(mode, hb)
    else:
        buckets = int(os.environ.get("BENCH_BUCKETS", 1 << 22))
        batch = int(os.environ.get("BENCH_BATCH", 16384))
        nnz = int(os.environ.get("BENCH_NNZ", 39))
        rank = int(os.environ.get("BENCH_RANK", 32))
        steps = int(os.environ.get("BENCH_STEPS", 60))
        cfg = FMConfig(num_features=buckets, num_factors=rank,
                       task=Task.CLASSIFICATION, reg_w=1e-6, reg_v=1e-6,
                       seed=0)
        bench = bench_score if mode == "score" else bench_train
        rec = bench(cfg, batch, nnz, buckets, steps)
    rec.update(device=device, card=card)
    print(json.dumps(rec), flush=True)
    hb("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
