"""Serving latency vs batch size on one GPU.

Measures the single-request score-path latency of models/fm.scores at
the config-3 shape (rank 32, 2^24 hashed buckets, 39 slots) for
B = 1 .. 16384, with host ladder dedup plans where they pay (B*L >= 2048
slots) and direct gathers where they don't.

Calls run one at a time, each on fresh ids. The reported latency
includes ONE host->device transfer of the ids (the serving reality) and
the device->host read of the result.

Output: the card, then one line per B with p50/p95 latency (of `iters`
calls), the implied max throughput at that batch, and the share of the
dispatch floor (a tiny jitted call, round-tripped).

Usage: python benchmarks/serving_latency.py [iters]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    from sparkfm_tpu.config import FMConfig, Task
    from sparkfm_tpu.models import fm as fm_model
    from sparkfm_tpu.ops import embedding as E
    from sparkfm_tpu.utils.compile_cache import enable_compile_cache
    from sparkfm_tpu.utils.device import gpu_line, require_gpu

    print(f"device {require_gpu()}; card {gpu_line()}", flush=True)
    enable_compile_cache()

    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    R, L, K = 1 << 24, 39, 32
    cfg = FMConfig(num_features=R, num_factors=K,
                   task=Task.CLASSIFICATION, seed=0)
    params = fm_model.init_params(cfg, jax.random.PRNGKey(0))
    score_fn = jax.jit(lambda p, ids, vals, plan: fm_model.scores(
        p, cfg, ids, vals, plan=plan))
    rng = np.random.default_rng(0)

    # dispatch floor: a tiny jitted call, round-tripped to the host
    tiny = jax.jit(lambda x: x + 1)
    y = jax.block_until_ready(tiny(jnp.float32(1.0)))
    floor = []
    for _ in range(10):
        t0 = time.perf_counter()
        y = np.asarray(tiny(y))
        floor.append(time.perf_counter() - t0)
    floor = float(np.median(floor))
    print(f"dispatch floor (tiny jit + fetch): {floor * 1e3:.2f} ms",
          flush=True)

    for B in (1, 16, 64, 256, 1024, 4096, 16384):
        use_plan = B * L >= 2048   # plans pay only once dedup does
        cap = E.auto_budget(B * L)
        ids_np = ((rng.zipf(1.3, size=(iters + 2, B, L)).astype(np.int64)
                   * 2654435761) % R).astype(np.int32)
        vals = jnp.ones((B, L), jnp.float32)
        plans = [None] * (iters + 2)
        if use_plan:
            rung = 1
            hps = []
            for i in range(iters + 2):
                hp = E.host_dedup(ids_np[i], cap, fill=0)
                rung = max(rung, E.ladder_budget(int(hp.count), cap=cap))
                hps.append(hp)
            plans = [E.DedupBatch(
                uids=jnp.asarray(hp.uids[:rung]),
                ranks=jnp.asarray(hp.ranks), count=jnp.asarray(hp.count),
                overflow=jnp.asarray(hp.overflow), order=None, seg=None)
                for hp in hps]
        # warm compile
        jax.block_until_ready(
            score_fn(params, jnp.asarray(ids_np[0]), vals, plans[0]))
        lats = []
        for i in range(iters):
            t0 = time.perf_counter()
            s = np.asarray(score_fn(params, jnp.asarray(ids_np[i + 1]),
                                    vals, plans[i + 1]))
            lats.append(time.perf_counter() - t0)
            assert np.isfinite(s).all()
        p50 = float(np.median(lats)) * 1e3
        p95 = float(np.percentile(lats, 95)) * 1e3
        print(f"B={B:6d} plan={'Y' if use_plan else 'n'} "
              f"p50={p50:7.2f} ms p95={p95:7.2f} ms  "
              f"-> {B / p50 * 1e3:10,.0f} ex/s  "
              f"(dispatch floor {floor * 1e3 / p50 * 100:4.0f}%)",
              flush=True)


if __name__ == "__main__":
    main()
