"""Multi-host (multi-process) SPMD setup.

Replaces the reference's Spark driver/executor topology (SURVEY §2.7 —
Akka RPC, Kryo-serialized closures, driver collects) with JAX's SPMD model:
every host runs the same program, `jax.distributed.initialize` wires the
processes into one runtime, and arrays are globally sharded over the
combined device set. There is no user-level RPC anywhere — cross-chip
traffic is XLA collectives over ICI/DCN inside the jitted step.

Single-process testing: the CPU-emulated 8-device mesh (tests/conftest.py)
exercises the same pjit/shard_map code paths; the driver's dryrun does the
same. True multi-process runs only need `initialize()` called first.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkfm_tpu.parallel import mesh as M

log = logging.getLogger("sparkfm_tpu")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the multi-process JAX runtime.

    With no args, trusts the environment (COORDINATOR_ADDRESS etc.). No-op for single-process runs without
    coordinator info.
    """
    # Detect "already initialized" WITHOUT jax.process_count(): that call
    # would itself initialize the XLA backend, after which
    # jax.distributed.initialize refuses to run.
    from jax._src import distributed as _dist
    if getattr(_dist.global_state, "client", None) is not None:
        return  # already initialized
    if coordinator_address is None and num_processes is None \
            and "COORDINATOR_ADDRESS" not in os.environ \
            and os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        return
    explicit = coordinator_address is not None or num_processes is not None
    try:
        jax.distributed.initialize(coordinator_address, num_processes,
                                   process_id)
        log.info("distributed: process %d/%d, %d local + %d global devices",
                 jax.process_index(), jax.process_count(),
                 jax.local_device_count(), jax.device_count())
    except Exception as e:
        if explicit:
            # caller asked for a specific topology: failing to join it is
            # an error, not a fallback (a silent 1-process "cluster" would
            # train on a fraction of the data and report success)
            raise
        log.info("distributed init skipped: %s", e)


def global_mesh(data: int = -1, model: int = 1) -> Mesh:
    """(data, model) mesh over ALL processes' devices."""
    return M.make_mesh(data, model, devices=jax.devices())


def process_batch_slice(n_global: int) -> slice:
    """This process's contiguous slice of a global batch (per-host input
    pipeline: each host loads only its shard of every batch)."""
    per = n_global // jax.process_count()
    i = jax.process_index()
    return slice(i * per, (i + 1) * per)


def host_local_to_global(mesh: Mesh, spec: P, host_local: np.ndarray):
    """Assemble a globally-sharded array from this process's local shard
    (jax.make_array_from_process_local_data; on a single process this is
    just a device_put with the sharding)."""
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(host_local, sharding)
    return jax.make_array_from_process_local_data(sharding, host_local)


def global_batch(mesh: Mesh, batch, has_fields: bool = False, plan=None,
                 plan_mode: str = "stacked"):
    """Lift a host-local SparseBatch into a globally (data-)sharded one.

    ``plan`` (optional): a dedup plan to ride the batch, lifted with the
    matching specs — either a stacked per-data-shard plan
    (ops.embedding.stack_plans; plan_mode="stacked", the unique
    exchange) or ONE plan over the whole global batch whose ranks slice
    per host alongside ids (plan_mode="global", the global exchange:
    uids/count/overflow replicated — every process must supply identical
    arrays, which the same-seed same-global-batch input discipline
    guarantees). plan_mode="global_hybrid" additionally lifts the
    per-data-shard sorted-backward extras (order=gmap/seg/svals/sex from
    ops.embedding.stack_hybrid_extras) that parallel.sharded_sgd's
    step_hybrid consumes — they shard over `data` like stacked rows.
    """
    from sparkfm_tpu.data.batching import SparseBatch
    specs = M.batch_pspecs(has_mask=batch.mask is not None,
                           has_fields=has_fields,
                           plan_mode=plan_mode if plan is not None else None)
    lift = lambda x, s: None if x is None or s is None \
        else host_local_to_global(mesh, s, np.asarray(x))
    lifted_plan = None
    if plan is not None:
        from sparkfm_tpu.ops.embedding import DedupBatch
        lifted_plan = DedupBatch(
            uids=lift(plan.uids, specs.plan.uids),
            ranks=lift(plan.ranks, specs.plan.ranks),
            count=lift(plan.count, specs.plan.count),
            overflow=lift(plan.overflow, specs.plan.overflow),
            order=lift(plan.order, specs.plan.order),
            seg=lift(plan.seg, specs.plan.seg),
            svals=lift(plan.svals, specs.plan.svals),
            sex=lift(plan.sex, specs.plan.sex))
    return SparseBatch(
        ids=lift(batch.ids, specs.ids),
        vals=lift(batch.vals, specs.vals),
        y=lift(batch.y, specs.y),
        mask=lift(batch.mask, specs.mask),
        # drop field_ids when the model doesn't use fields (plain FM on a
        # fielded dataset) — the step's specs won't carry them either.
        field_ids=(lift(batch.field_ids, specs.field_ids)
                   if has_fields else None),
        plan=lifted_plan)


def collect(x) -> np.ndarray:
    """Fetch a (possibly globally sharded) array to a host numpy value,
    identical on every process.

    Single-process: plain device fetch (handles multi-device shardings).
    Multi-process: process_allgather assembles the non-addressable shards.
    """
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
