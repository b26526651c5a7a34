"""MCMC (Gibbs) solver: Bayesian FM with sampled hyperparameters.

The libFM solver family is SGD / ALS / MCMC; the reference implements only
ALS (fm/lib/ALS.scala — SURVEY §2.3). This module restores MCMC, built on
the same blocked coordinate machinery as solvers/als.py:

  * ALS draws theta* = (theta*den - num) / (reg + den); MCMC draws from the
    full conditional posterior
        var   = 1 / (alpha * den + lambda_g)
        mean  = var * (alpha * (theta*den - num) + mu_g * lambda_g)
        theta ~ N(mean, var)
    where g is the parameter's group (w; each factor column of V).
  * After each full sweep the hyperparameters are Gibbs-sampled
    (Rendle 2012, "Factorization Machines with libFM", sec. 4.3):
        alpha     ~ Gamma(alpha_0 + n/2,       beta_0 + sum(e^2)/2)
        lambda_g  ~ Gamma(alpha_l + (p_g+1)/2, beta_l + (sum_g (theta-mu_g)^2
                                               + gamma_0*(mu_g-mu_0)^2)/2)
        mu_g      ~ N((sum_g theta + gamma_0*mu_0) / ((p_g+gamma_0)),
                      1/((p_g+gamma_0)*lambda_g))
    so no learning rate and no regularization constants need tuning.
  * Blocks: Jacobi draws within a block at block-start conditionals,
    Gauss-Seidel across blocks with exact e/q patches — a chromatic-style
    blocked Gibbs; block_size=1 recovers exact scalar Gibbs.
  * Prediction is the posterior mean: scores on the evaluation set are
    accumulated each post-burn-in sweep and averaged (libFM semantics),
    which typically beats any single sample.

w0 is treated as a linear parameter with group "w" (libFM groups the bias
with the linear weights under the same lambda).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sparkfm_tpu.config import FMConfig, MCMCConfig, Task
from sparkfm_tpu.data.batching import SparseDataset
from sparkfm_tpu.models.fm import FMParams
from sparkfm_tpu.ops import interaction as I
from sparkfm_tpu.solvers.als import ALSWorkspace, build_workspace


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MCMCState:
    """Parameters + sampled hyperparameters.

    alpha: () noise precision. lam_w/mu_w: (G,) per-attribute-group linear
    priors. lam_v/mu_v: (G, K) per-(group, factor-column) priors — libFM's
    full grouped hyperprior structure (Rendle 2012 sec. 4.3; the
    reference's Metadata groups, fm/bs/Metadata.scala:8-29). G == 1 when no
    groups are configured, recovering the shared-prior behavior; the bias
    w0 always belongs to group 0.
    """

    params: FMParams
    alpha: jnp.ndarray
    lam_w: jnp.ndarray
    mu_w: jnp.ndarray
    lam_v: jnp.ndarray
    mu_v: jnp.ndarray


def init_mcmc_state(params: FMParams, num_groups: int = 1) -> MCMCState:
    k = params.v.shape[-1]
    g = num_groups
    return MCMCState(params=params, alpha=jnp.ones((), jnp.float32),
                     lam_w=jnp.ones((g,), jnp.float32),
                     mu_w=jnp.zeros((g,), jnp.float32),
                     lam_v=jnp.ones((g, k), jnp.float32),
                     mu_v=jnp.zeros((g, k), jnp.float32))


def _draw_theta(key, theta, num, den, alpha, lam, mu):
    """Sample from the conditional posterior; keep old value for empty or
    non-finite columns (mirrors ALS _guarded_theta)."""
    var = 1.0 / (alpha * den + lam)
    mean = var * (alpha * (theta * den - num) + mu * lam)
    draw = mean + jnp.sqrt(var) * jax.random.normal(key, theta.shape)
    ok = jnp.isfinite(draw) & (den > 0)
    return jnp.where(ok, draw, theta)


def _gamma(key, shape_param, rate):
    """Gamma(shape, rate) sample (jax.random.gamma is shape/scale=1)."""
    return jax.random.gamma(key, shape_param) / rate


@partial(jax.jit, static_argnames=("num_blocks", "num_features",
                                   "num_groups",
                                   "use_bias", "use_linear",
                                   "alpha_0", "beta_0", "alpha_l", "beta_l",
                                   "mu_0", "gamma_0", "axis_name"))
def mcmc_sweep(state: MCMCState, ws: ALSWorkspace, key: jax.Array,
               num_blocks: int, num_features: int,
               groups: jnp.ndarray = None, num_groups: int = 1,
               alpha_0: float = 1.0, beta_0: float = 1.0,
               alpha_l: float = 1.0, beta_l: float = 1.0,
               mu_0: float = 0.0, gamma_0: float = 1.0,
               use_bias: bool = True, use_linear: bool = True,
               axis_name: Optional[str] = None) -> MCMCState:
    """One full Gibbs sweep: hyperparameters, w0, w blocks, (factor, block)
    draws, with exact residual/q patching between blocks.

    ``groups``: (F,) int32 attribute-group ids (None = all group 0);
    hyperpriors (lambda, mu) are sampled per group (and per factor column
    for V) — libFM's grouped structure, covering the reference's Metadata
    capability. w0 rides group 0.

    With ``axis_name`` (sharded mode, parallel/sharded_als.py::
    train_mcmc_sharded): examples shard over that mesh axis; every
    EXAMPLE-space reduction (n, Σe², Σe, per-feature num/den) is psum'd
    and den_w arrives pre-divided by the shard count, exactly the
    discipline of als._sweep_impl. Parameters and the PRNG key stay
    replicated, so every shard draws IDENTICAL samples from identical
    psum'd conditionals — the chain is the single-device chain.
    """
    params = state.params
    F = num_features
    G = num_groups
    K = params.v.shape[-1]
    allr = ((lambda x: jax.lax.psum(x, axis_name)) if axis_name
            else (lambda x: x))
    if groups is None:
        groups = jnp.zeros((F,), jnp.int32)
    mask = ws.mask if ws.mask is not None else jnp.ones_like(ws.y)
    n_valid = allr(jnp.sum(mask))
    den_w_g = allr(ws.den_w)

    # residuals from the CSC view alone (the workspace carries no CSR
    # copy — solvers/als.py::build_workspace, VERDICT r2 weak #8)
    n_ex = ws.y.shape[0]

    def _col_q(vf):
        return jax.ops.segment_sum(vf[ws.col_feat] * ws.col_val,
                                   ws.col_row, num_segments=n_ex)

    score = jnp.zeros((n_ex,), jnp.float32)
    if use_bias:
        score = score + params.w0
    if use_linear:
        score = score + _col_q(params.w)

    def _factor_score(f_, s):
        vx = params.v[:, f_][ws.col_feat] * ws.col_val
        qf = jax.ops.segment_sum(vx, ws.col_row, num_segments=n_ex)
        sqf = jax.ops.segment_sum(jnp.square(vx), ws.col_row,
                                  num_segments=n_ex)
        return s + 0.5 * (jnp.square(qf) - sqf)

    score = jax.lax.fori_loop(0, K, _factor_score, score)
    e = (score - ws.y) * mask

    (k_alpha, k_lw, k_muw, k_lv, k_muv, k_w0, k_w,
     k_v) = jax.random.split(key, 8)

    # --- noise precision
    alpha = _gamma(k_alpha, alpha_0 + 0.5 * n_valid,
                   beta_0 + 0.5 * allr(jnp.sum(jnp.square(e))))

    ones_f = jnp.ones((F,), jnp.float32)
    cnt_g = jax.ops.segment_sum(ones_f, groups, num_segments=G)  # (G,)

    # --- per-group linear priors (w0 joins group 0)
    w0_onehot = jnp.zeros((G,), jnp.float32).at[0].add(1.0)
    p_w = cnt_g + w0_onehot
    sum_w_g = (jax.ops.segment_sum(params.w, groups, num_segments=G)
               + w0_onehot * params.w0)
    mu_w_mean = (sum_w_g + gamma_0 * mu_0) / (p_w + gamma_0)
    ssq_w = (jax.ops.segment_sum(
                 jnp.square(params.w - state.mu_w[groups]), groups,
                 num_segments=G)
             + w0_onehot * jnp.square(params.w0 - state.mu_w[0])
             + gamma_0 * jnp.square(state.mu_w - mu_0))
    lam_w = _gamma(k_lw, alpha_l + 0.5 * (p_w + 1), beta_l + 0.5 * ssq_w)
    mu_w = (mu_w_mean + jax.random.normal(k_muw, (G,)) *
            jax.lax.rsqrt((p_w + gamma_0) * lam_w))            # (G,)

    # --- per-(group, factor-column) priors
    sum_v_g = jax.ops.segment_sum(params.v, groups,
                                  num_segments=G)              # (G, K)
    mu_v_mean = (sum_v_g + gamma_0 * mu_0) / (cnt_g[:, None] + gamma_0)
    ssq_v = (jax.ops.segment_sum(
                 jnp.square(params.v - state.mu_v[groups]), groups,
                 num_segments=G)
             + gamma_0 * jnp.square(state.mu_v - mu_0))        # (G, K)
    lam_v = _gamma(k_lv, alpha_l + 0.5 * (cnt_g[:, None] + 1),
                   beta_l + 0.5 * ssq_v)                       # (G, K)
    mu_v = (mu_v_mean + jax.random.normal(k_muv, (G, K)) *
            jax.lax.rsqrt((cnt_g[:, None] + gamma_0) * lam_v))

    lam_w_f = lam_w[groups]                                    # (F,)
    mu_w_f = mu_w[groups]

    # --- w0 (group 0, h == 1)
    if use_bias:
        w0_new = _draw_theta(k_w0, params.w0, allr(jnp.sum(e)),
                             n_valid, alpha, lam_w[0], mu_w[0])
        e = e + (w0_new - params.w0) * mask
    else:
        w0_new = params.w0

    # --- linear weights, blocked
    def w_block(b, carry):
        w, e = carry
        kb = jax.random.fold_in(k_w, b)
        num = allr(jax.ops.segment_sum(
            e[ws.col_row] * ws.col_val, ws.col_feat,
            num_segments=F, indices_are_sorted=True))
        theta_new = _draw_theta(kb, w, num, den_w_g, alpha, lam_w_f,
                                mu_w_f)
        delta = jnp.where(ws.block_of_feat == b, theta_new - w, 0.0)
        w = w + delta
        de = jax.ops.segment_sum(delta[ws.col_feat] * ws.col_val, ws.col_row,
                                 num_segments=ws.y.shape[0])
        return (w, e + de)

    if use_linear:
        w_new, e = jax.lax.fori_loop(0, num_blocks, w_block, (params.w, e))
    else:
        w_new = params.w

    # --- factors
    def factor_body(f, carry):
        v, e = carry
        vf = v[:, f]
        q = _col_q(vf)

        def v_block(b, carry2):
            vf, q, e = carry2
            kb = jax.random.fold_in(jax.random.fold_in(k_v, f), b)
            h = ws.col_val * (q[ws.col_row] - ws.col_val * vf[ws.col_feat])
            num = allr(jax.ops.segment_sum(
                e[ws.col_row] * h, ws.col_feat,
                num_segments=F, indices_are_sorted=True))
            den = allr(jax.ops.segment_sum(
                h * h, ws.col_feat, num_segments=F,
                indices_are_sorted=True))
            theta_new = _draw_theta(kb, vf, num, den, alpha,
                                    lam_v[groups, f], mu_v[groups, f])
            in_block = ws.block_of_feat == b
            delta = jnp.where(in_block, theta_new - vf, 0.0)
            vf_new = vf + delta
            dq = jax.ops.segment_sum(delta[ws.col_feat] * ws.col_val,
                                     ws.col_row, num_segments=ws.y.shape[0])
            q_new = q + dq
            dsq = jnp.where(in_block,
                            jnp.square(vf_new) - jnp.square(vf), 0.0)
            de_sq = jax.ops.segment_sum(dsq[ws.col_feat] * ws.col_val ** 2,
                                        ws.col_row,
                                        num_segments=ws.y.shape[0])
            e_new = (e + 0.5 * (jnp.square(q_new) - jnp.square(q))
                     - 0.5 * de_sq)
            return (vf_new, q_new, e_new)

        vf, q, e = jax.lax.fori_loop(0, num_blocks, v_block, (vf, q, e))
        return (v.at[:, f].set(vf), e)

    v_new, e = jax.lax.fori_loop(0, K, factor_body, (params.v, e))

    return MCMCState(params=FMParams(w0=w0_new, w=w_new, v=v_new),
                     alpha=alpha, lam_w=lam_w, mu_w=mu_w,
                     lam_v=lam_v, mu_v=mu_v)


def train_mcmc(cfg: FMConfig, mcmc_cfg: MCMCConfig, train: SparseDataset,
               eval_ds: Optional[SparseDataset] = None,
               key: Optional[jax.Array] = None,
               params: Optional[FMParams] = None):
    """Gibbs training loop with posterior-mean prediction.

    Returns TrainResult whose params are the LAST sample; ``history``
    carries per-epoch eval metrics of the RUNNING AVERAGED scores (the
    quantity libFM reports), plus the sampled hyperparameters. The averaged
    eval scores are also attached as ``result.extras['avg_scores']``.
    """
    from sparkfm_tpu.config import ALSConfig
    from sparkfm_tpu.models import fm as fm_model
    from sparkfm_tpu.training import trainer as _trainer

    if cfg.task != Task.REGRESSION:
        raise ValueError("MCMC-FM optimizes squared loss (Rendle 2012); "
                         "use SGD for classification")
    if cfg.num_fields > 0:
        raise ValueError("MCMC supports plain FM (not FFM)")

    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    k_init, key = jax.random.split(key)
    if params is None:
        params = fm_model.init_params(cfg, k_init)
    ws, num_blocks = build_workspace(
        train, cfg, ALSConfig(block_size=mcmc_cfg.block_size,
                              feature_blocks=mcmc_cfg.feature_blocks))
    num_groups = cfg.num_groups
    groups = (jnp.asarray(np.asarray(cfg.feature_groups, np.int32))
              if cfg.feature_groups is not None
              else jnp.zeros((cfg.num_features,), jnp.int32))
    state = init_mcmc_state(params, num_groups)

    score_fn = _trainer._eval_scores_fn(cfg)
    avg_scores = None
    n_avg = 0
    history = []
    n_examples = 0
    t0 = time.perf_counter()
    for epoch in range(mcmc_cfg.epochs):
        key, k_sweep = jax.random.split(key)
        state = mcmc_sweep(
            state, ws, k_sweep, num_blocks, cfg.num_features,
            groups=groups, num_groups=num_groups,
            alpha_0=mcmc_cfg.alpha_0, beta_0=mcmc_cfg.beta_0,
            alpha_l=mcmc_cfg.alpha_lambda, beta_l=mcmc_cfg.beta_lambda,
            mu_0=mcmc_cfg.mu_0, gamma_0=mcmc_cfg.gamma_0,
            use_bias=cfg.use_bias, use_linear=cfg.use_linear)
        n_examples += train.num_examples
        rec = {"epoch": epoch,
               "alpha": float(state.alpha),
               "lam_w": float(jnp.mean(state.lam_w))}
        if eval_ds is not None and epoch >= mcmc_cfg.burn_in:
            from sparkfm_tpu.data.batching import batch_iterator
            scores = []
            for b in batch_iterator(eval_ds, 8192, shuffle=False):
                s = score_fn(state.params, b.ids, b.vals, b.field_ids)
                scores.append(np.asarray(s)[:int(np.sum(np.asarray(b.mask)))])
            s = np.concatenate(scores)
            n_avg += 1
            avg_scores = (s if avg_scores is None
                          else avg_scores + (s - avg_scores) / n_avg)
            y = eval_ds.y[:len(avg_scores)]
            rec["eval_rmse_avg"] = float(
                np.sqrt(np.mean(np.square(avg_scores - y))))
            rec["eval_rmse_sample"] = float(
                np.sqrt(np.mean(np.square(s - y))))
        history.append(rec)
        if mcmc_cfg.max_seconds and (time.perf_counter() - t0
                                     >= mcmc_cfg.max_seconds):
            # wall-clock budget (the reference's `timeout`, FM.scala:30)
            break
    jax.block_until_ready(state.params.v)
    eps = n_examples / max(time.perf_counter() - t0, 1e-9)
    result = _trainer.TrainResult(params=state.params, history=history,
                                  examples_per_sec=eps)
    result.extras = {"avg_scores": avg_scores, "mcmc_state": state}
    return result
