"""Device-mesh construction and sharding specs for the (data, model) layout.

The reference's only parallel axis is Spark data-parallelism over examples,
with the whole model replicated to executors via closure serialization
(SURVEY §2.7; reference fm/FMModel.scala:18-19 keeps w and V on the driver
heap — its hard scale ceiling). Here the layout is a 2-D
`jax.sharding.Mesh`:

  data  — batch dimension (examples), the DP axis
  model — feature (row) dimension of the w/V tables, the TP axis; a
          2^24-bucket Criteo table is sharded row-wise so no chip ever holds
          the full table (BASELINE.md config 3)

Collectives ride this mesh inside `shard_map` (parallel/sharded_sgd.py):
`psum` over `model` for active-row gather, `all_gather` over `data` for the
sparse update exchange — replacing the reference's shuffle/collect round-trips
(ALS.scala:34,139) with ICI collectives.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkfm_tpu.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: int = -1, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, model) mesh.

    Args:
      data: size of the data axis; -1 = use all remaining devices.
      model: size of the model (table row-sharding) axis.
      devices: optional explicit device list (default: jax.devices()).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh ({data}x{model}) needs {data*model} devices, "
                         f"have {n}")
    dev = np.asarray(devices[:data * model]).reshape(data, model)
    return Mesh(dev, (DATA_AXIS, MODEL_AXIS))


def mesh_from_config(cfg: MeshConfig,
                     devices: Optional[Sequence] = None) -> Mesh:
    return make_mesh(cfg.data, cfg.model, devices)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n (row-shard size alignment)."""
    return ((n + m - 1) // m) * m


def param_pspecs(ffm: bool = False):
    """PartitionSpecs for FMParams: tables row-sharded over `model`.

    w0 is replicated; w and v shard their leading (feature) dimension.
    """
    from sparkfm_tpu.models.fm import FMParams
    return FMParams(
        w0=P(),
        w=P(MODEL_AXIS),
        # FFM v is stored flat (F, nf*K) — same 2-D spec as plain FM
        v=P(MODEL_AXIS, None),
    )


def state_pspecs(ffm: bool = False):
    """PartitionSpecs for the full SGDState (slots mirror params)."""
    from sparkfm_tpu.solvers.sgd import SGDState
    p = param_pspecs(ffm)
    return SGDState(
        params=p,
        slot_w0=P(), slot_w=p.w, slot_v=p.v,
        slot2_w0=P(), slot2_w=p.w, slot2_v=p.v,
        step=P(),
    )


def batch_pspecs(has_mask: bool = True, has_fields: bool = False,
                 has_plan: bool = False, plan_mode: str = None):
    """PartitionSpecs for a SparseBatch: batch dimension over `data`.

    plan_mode (``has_plan=True`` is legacy shorthand for "stacked"):
      * "stacked" — a *per-data-shard* dedup plan (ops.embedding
        .stack_plans): uids/count/overflow gain a leading (D,) shard axis
        sharded over `data`; ranks concatenate along the batch axis like
        ids. Consumed by the "unique" exchange.
      * "global" — ONE host plan over the whole global batch:
        uids/count/overflow replicated, ranks index the SHARED unique
        space and shard over `data` with the batch rows. Consumed by the
        "global" exchange (aligned per-unique sums -> one psum).
    order/seg/svals/sex are never carried (the sharded steps accumulate
    with the local scatter-add, which needs only ranks).
    """
    from sparkfm_tpu.data.batching import SparseBatch
    if has_plan and plan_mode is None:
        plan_mode = "stacked"
    plan = None
    if plan_mode == "stacked":
        from sparkfm_tpu.ops.embedding import DedupBatch
        plan = DedupBatch(
            uids=P(DATA_AXIS, None),
            ranks=P(DATA_AXIS, None),
            count=P(DATA_AXIS),
            overflow=P(DATA_AXIS),
            order=None, seg=None)
    elif plan_mode == "global":
        from sparkfm_tpu.ops.embedding import DedupBatch
        plan = DedupBatch(
            uids=P(None),
            ranks=P(DATA_AXIS, None),
            count=P(),
            overflow=P(),
            order=None, seg=None)
    elif plan_mode == "global_hybrid":
        # global plan + per-shard sorted-backward extras
        # (ops.embedding.stack_hybrid_extras): seg/svals/sex are the
        # shard-sorted slot streams, `order` carries the (D, U_cap)
        # local-unique -> global-rank scatter map (gmap).
        from sparkfm_tpu.ops.embedding import DedupBatch
        plan = DedupBatch(
            uids=P(None),
            ranks=P(DATA_AXIS, None),
            count=P(),
            overflow=P(),
            order=P(DATA_AXIS, None),
            seg=P(DATA_AXIS, None),
            svals=P(DATA_AXIS, None),
            sex=P(DATA_AXIS, None))
    elif plan_mode is not None:
        raise ValueError(f"unknown plan_mode={plan_mode!r}")
    return SparseBatch(
        ids=P(DATA_AXIS, None),
        vals=P(DATA_AXIS, None),
        y=P(DATA_AXIS),
        mask=P(DATA_AXIS) if has_mask else None,
        field_ids=P(DATA_AXIS, None) if has_fields else None,
        plan=plan,
    )


def named(mesh: Mesh, spec) -> NamedSharding:
    return NamedSharding(mesh, spec)


def shard_pytree(mesh: Mesh, tree, pspecs):
    """Device-put a host pytree with the given PartitionSpecs."""
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, pspecs,
        is_leaf=lambda x: x is None)
