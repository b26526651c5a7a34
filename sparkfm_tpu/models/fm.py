"""FM model: parameter container + batched prediction.

Counterpart of the reference FMModel (fm/FMModel.scala:10-63).
Differences by design:
  * Parameters are a JAX pytree, not a driver-heap object broadcast via
    closures; under pjit the V/w tables shard row-wise over the `model` mesh
    axis (see parallel/sharding.py).
  * Initialization is fully keyed (the reference draws unseeded Gaussians and
    ignores its `seed` param: FMModel.scala:14,19-22).
  * `predict` is batched over fixed-shape padded CSR batches instead of
    per-example activeIterator loops (FMModel.scala:34-55).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from sparkfm_tpu.config import FMConfig, Task
from sparkfm_tpu.ops import interaction as I
from sparkfm_tpu.ops import losses as L


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FMParams:
    """w0: () scalar bias; w: (F,) linear weights; v: (F, K) factors.

    For FFM (num_fields > 0), v is stored FLAT as (F, num_fields * K) —
    one latent vector per (feature, target-field) pair, concatenated per
    row: one row gather fetches a feature's whole factor block. The
    interaction ops accept flat rows and reshape internally (fusion keeps
    the 4-D view out of device memory).
    """

    w0: jnp.ndarray
    w: jnp.ndarray
    v: jnp.ndarray


def init_params(cfg: FMConfig, key: jax.Array | None = None) -> FMParams:
    """N(init_mean, init_stdev) init of V; w0/w zero-initialized.

    Matches the reference init scheme (FMModel.scala:17-22) but deterministic
    under `cfg.seed`.
    """
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    dtype = jnp.dtype(cfg.dtype)
    if cfg.num_fields > 0:
        # FLAT per-row layout (see FMParams doc)
        vshape = (cfg.num_features, cfg.num_fields * cfg.num_factors)
    else:
        vshape = (cfg.num_features, cfg.num_factors)
    v = cfg.init_mean + cfg.init_stdev * jax.random.normal(
        key, vshape, dtype=jnp.float32)
    return FMParams(
        w0=jnp.zeros((), dtype),
        w=jnp.zeros((cfg.num_features,), dtype),
        v=v.astype(dtype),
    )


def scores(params: FMParams, cfg: FMConfig,
           ids: jnp.ndarray, vals: jnp.ndarray,
           field_ids: jnp.ndarray | None = None,
           plan=None) -> jnp.ndarray:
    """Raw (pre-sigmoid) scores for a padded CSR batch.

    For big tables (F >= 2^16) plain-FM scoring goes through a dedup plan:
    the batch's ids are sorted and only unique rows are gathered from the
    multi-million-row table (with the indices_are_sorted gather hint),
    instead of one big-table gather per slot.

    ``plan`` (optional, plain FM): a HOST dedup plan for this batch
    (ops.embedding.host_dedup / batch_iterator(dedup_budget="ladder")).
    The device then does ONE tight unique-row gather — no in-step sorts,
    no worst-case budget. Caller contract: plan.count <= plan budget
    (ladder plans guarantee it), or scores of overflowed ids are wrong.
    """
    cdt = jnp.dtype(cfg.compute_dtype)
    if cfg.num_fields > 0:
        if field_ids is None and not cfg.slot_major_fields:
            raise ValueError(
                "FFM model requires field_ids (or a slot_major_fields "
                "config, where slot l IS field l and they may be omitted)")
        w_rows = params.w[ids]
        v_rows = params.v[ids]      # (B, L, num_fields*K) flat
        return I.ffm_scores_from_gathered(
            params.w0, w_rows, v_rows, vals, field_ids, cfg.num_fields,
            use_bias=cfg.use_bias, use_linear=cfg.use_linear,
            compute_dtype=cdt, slot_major=cfg.slot_major_fields)
    n_slots = ids.shape[0] * ids.shape[1]
    use_dedup = plan is not None
    if plan is None and cfg.num_features >= (1 << 16):
        from sparkfm_tpu.ops import embedding as E
        budget = E.auto_budget(n_slots)
        if budget >= n_slots:   # no-overflow guarantee, exact scores
            plan = E.dedup_ids(ids, budget, fill=cfg.num_features - 1)
            use_dedup = True
    if use_dedup:
        v_u = params.v.at[plan.uids].get(
            indices_are_sorted=True, mode="promise_in_bounds")
        w_u = params.w.at[plan.uids].get(
            indices_are_sorted=True, mode="promise_in_bounds")
        vw_u = jnp.concatenate([v_u, w_u[:, None]], axis=1)
        vw_rows = vw_u[plan.ranks]
        return I.fm_scores_from_gathered(
            params.w0, vw_rows[..., cfg.num_factors],
            vw_rows[..., :cfg.num_factors], vals,
            use_bias=cfg.use_bias, use_linear=cfg.use_linear,
            compute_dtype=cdt)
    return I.fm_scores(params.w0, params.w, params.v, ids, vals,
                       use_bias=cfg.use_bias, use_linear=cfg.use_linear,
                       compute_dtype=cdt)


def predict(params: FMParams, cfg: FMConfig,
            ids: jnp.ndarray, vals: jnp.ndarray,
            field_ids: jnp.ndarray | None = None,
            plan=None) -> jnp.ndarray:
    """Predictions in output space (reference: FMModel.predict).

    Regression: raw score. Classification: P(y=1) via sigmoid — completing
    the head the reference leaves unimplemented.
    """
    s = scores(params, cfg, ids, vals, field_ids, plan=plan)
    return L.predict_for_task(cfg.task, s)


def l2_penalty(params: FMParams, cfg: FMConfig) -> jnp.ndarray:
    """Group L2: reg0*w0^2 + reg_w*|w|^2 + reg_v*|V|^2 (per-coordinate
    strengths matching the reference's reg0/regw/regv: FMModel.scala:29-31)."""
    return (cfg.reg0 * jnp.square(params.w0)
            + cfg.reg_w * jnp.sum(jnp.square(params.w))
            + cfg.reg_v * jnp.sum(jnp.square(params.v)))
