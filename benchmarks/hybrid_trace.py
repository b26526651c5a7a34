"""Device-time anatomy of the hybrid train step at the Criteo shape.

Builds the chip_smoke train cell's hybrid step (rank-32 logistic FM,
2^24 buckets, batch 16384 x 39 slots, adagrad, host ladder plans staged
before timing), then:

  1. times ``steps`` single-step dispatches with the profiler off
     (host clock around work that ends in ``block_until_ready``);
  2. traces the same number of steps with ``jax.profiler`` into
     ``<out>/trace`` and reduces the trace: device busy time and idle
     share of the window, device time per operation, and the share and
     achieved bandwidth of the per-unique segment reduce (every operation
     under the ``fm_grad_segsum`` named scope, ops/segsum.py).

The reduce's bytes are the least it must move: read the id-sorted
example pack (N, k+2), slot values (N,), ranks (N,) and one (k+1)-float
row per slot, and write the (U, 2k+2) sums once. Achieved bytes/s is
that over the reduce's device time, against the 3.35 TB/s peak of an
H100 SXM (NVIDIA data sheet).

Prints one JSON line and writes it, with the top operations, to
``<out>/hybrid_trace.json``.

Usage: python benchmarks/hybrid_trace.py [out_dir] [steps]
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
SCOPE = "fm_grad_segsum"


def scoped_ops(hlo_text: str, scope: str = SCOPE) -> set:
    """Names of the compiled HLO instructions whose op_name metadata lies
    under ``scope`` (trace events carry these instruction names)."""
    names = set()
    for line in hlo_text.splitlines():
        m = re.match(r'\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name="([^"]*)"',
                     line)
        if m and f"/{scope}/" in f"/{m.group(2)}/":
            # kernels are named after their instruction, "." -> "_"
            names.add(m.group(1).replace(".", "_"))
    return names


def reduce_trace(trace_dir: str, scoped: set,
                 plane_prefix: str = "/device:GPU") -> dict:
    """Per-operation device time from the newest .xplane.pb under
    trace_dir. Operations are the events of each device plane's "XLA
    Ops" line (all of its lines when it has none); ``scoped`` names the
    operations of the segment reduce."""
    from jax.profiler import ProfileData
    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    pd = ProfileData.from_file(paths[-1])
    per_op, lines_seen = {}, {}
    scope_ns = 0
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        lines = list(plane.lines)
        for line in lines:
            lines_seen[f"{plane.name} | {line.name}"] = sum(
                1 for _ in line.events)
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or lines
        for line in ops:
            for ev in line.events:
                rec = per_op.setdefault(ev.name, [0, 0, ""])
                rec[0] += ev.duration_ns
                rec[1] += 1
                if ev.name in scoped:
                    rec[2] = SCOPE
                    scope_ns += ev.duration_ns
                intervals.append((ev.start_ns, ev.end_ns))
    if not intervals:
        raise RuntimeError(f"no GPU operations in {paths[-1]} "
                           f"(lines: {lines_seen})")
    intervals.sort()
    busy, cur_s, cur_e = 0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    top = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:40]
    return {"window_ns": window, "busy_ns": busy,
            "op_ns": sum(v[0] for v in per_op.values()),
            "scope_ns": scope_ns, "lines": lines_seen,
            "top_ops": [{"name": n, "ns": v[0], "count": v[1],
                         "scope": v[2]} for n, v in top]}


def main() -> int:
    out = sys.argv[1] if len(sys.argv) > 1 else "chiprun_out"
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    import jax

    from sparkfm_tpu.config import FMConfig, SGDConfig, Task
    from sparkfm_tpu.data import synth
    from sparkfm_tpu.data.batching import batch_iterator
    from sparkfm_tpu.solvers import sgd_fused, sgd_hybrid
    from sparkfm_tpu.utils import profiling
    from sparkfm_tpu.utils.compile_cache import enable_compile_cache
    from sparkfm_tpu.utils.device import gpu_line, require_gpu

    device = require_gpu()
    card = gpu_line()
    enable_compile_cache()
    F, K, L, B = 1 << 24, 32, 39, 16384
    cfg = FMConfig(num_features=F, num_factors=K, task=Task.CLASSIFICATION,
                   reg_w=1e-6, reg_v=1e-6, seed=0)
    sgd_cfg = SGDConfig(batch_size=B, learning_rate=0.05,
                        optimizer="adagrad")
    ds = synth.synth_ctr(num_examples=2 * steps * B, num_fields=L,
                         num_buckets=F, seed=0)
    batches = list(batch_iterator(ds, B, shuffle=False,
                                  dedup_budget="ladder", dedup_fill=F))
    batches = jax.device_put(batches)
    state = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(0))
    step = sgd_hybrid.make_hybrid_train_step(cfg, sgd_cfg)
    for b in batches:              # compile every ladder rung once
        state, aux = step(state, b)
    jax.block_until_ready((state, aux))

    t0 = time.perf_counter()
    for b in batches[:steps]:
        state, aux = step(state, b)
    jax.block_until_ready((state, aux))
    step_s = (time.perf_counter() - t0) / steps

    traced = batches[steps:]
    scoped = set()
    for shape in {b.plan.uids.shape for b in traced}:
        b = next(b for b in traced if b.plan.uids.shape == shape)
        scoped |= scoped_ops(step.lower(state, b).compile().as_text())
    trace_dir = os.path.join(out, "trace")
    with profiling.trace(trace_dir):
        for b in traced:
            state, aux = step(state, b)
        jax.block_until_ready((state, aux))
    red = reduce_trace(trace_dir, scoped)
    red["scoped_ops"] = sorted(scoped)

    plan = batches[-1].plan
    n, u = int(plan.seg.shape[0]), int(plan.uids.shape[0])
    reduce_bytes = 4 * (n * (K + 2) + n + n + n * (K + 1) + u * (2 * K + 2))
    scope_s = red["scope_ns"] / 1e9 / steps
    peak = PEAK_BYTES_PER_S.get(device["kind"])
    rec = {
        "metric": "hybrid_step_anatomy", "device": device, "card": card,
        "step_ms": round(step_s * 1e3, 4),
        "device_busy_ms_per_step": round(red["busy_ns"] / 1e6 / steps, 4),
        "idle_share": round(1 - red["busy_ns"] / red["window_ns"], 4),
        "reduce_ms_per_step": round(scope_s * 1e3, 4),
        "reduce_share_of_busy": round(red["scope_ns"] / red["busy_ns"], 4),
        "reduce_bytes": reduce_bytes, "slots": n, "budget": u,
        "reduce_bytes_per_s": (round(reduce_bytes / scope_s, 1)
                               if scope_s else None),
        "reduce_roofline_share": (round(reduce_bytes / scope_s / peak, 4)
                                  if scope_s and peak else None),
        "loss": float(aux["loss"]),
    }
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "hybrid_trace.json"), "w") as f:
        json.dump({**rec, "trace": red}, f, indent=1)
    for op in red["top_ops"][:25]:
        print(f"{op['ns'] / 1e6 / steps:9.4f} ms/step  x{op['count'] // steps:<3d}"
              f" {op['scope']:15s} {op['name']}", file=sys.stderr)
    print(json.dumps(rec), flush=True)
    assert np.isfinite(rec["loss"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
