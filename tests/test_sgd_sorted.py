"""Sorted-slot SGD path: parity with the fused-record path (same table
layout, same update semantics) over multiple steps, including masks,
duplicate ids, regularization, and both loss heads."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sparkfm_tpu.config import FMConfig, SGDConfig, Task
from sparkfm_tpu.data.batching import SparseBatch
from sparkfm_tpu.solvers import sgd_fused, sgd_sorted


def _batches(rng, B, L, F, steps, dup_heavy=False, with_mask=False):
    out = []
    for _ in range(steps):
        hi = max(2, F // 8) if dup_heavy else F
        ids = rng.integers(0, hi, (B, L)).astype(np.int32)
        vals = rng.normal(size=(B, L)).astype(np.float32)
        # pad a few slots like the real batcher (id 0, val 0)
        pad = rng.random((B, L)) < 0.2
        ids[pad] = 0
        vals[pad] = 0.0
        y = rng.normal(size=(B,)).astype(np.float32)
        mask = (np.ones((B,), bool) if not with_mask
                else rng.random(B) < 0.8)
        out.append(SparseBatch(ids=jnp.asarray(ids), vals=jnp.asarray(vals),
                               y=jnp.asarray(y), mask=jnp.asarray(mask)))
    return out


def _run_parity(cfg, sgd_cfg, batches, rtol=2e-4, atol=2e-5):
    s_f = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(0))
    s_s = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(0))
    step_f = sgd_fused.make_fused_train_step(cfg, sgd_cfg)
    step_s = sgd_sorted.make_sorted_train_step(cfg, sgd_cfg)
    for b in batches:
        s_f, aux_f = step_f(s_f, b)
        s_s, aux_s = step_s(s_s, b)
        np.testing.assert_allclose(float(aux_s["loss"]), float(aux_f["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(np.asarray(aux_s["scores"]),
                                   np.asarray(aux_f["scores"]),
                                   rtol=1e-4, atol=1e-5)
    F = cfg.num_features
    np.testing.assert_allclose(np.asarray(s_s.table[:F]),
                               np.asarray(s_f.table[:F]),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(s_s.w0), float(s_f.w0), rtol=1e-5)


def test_parity_regression_adagrad():
    rng = np.random.default_rng(0)
    cfg = FMConfig(num_features=64, num_factors=4, reg_w=0.01, reg_v=0.02,
                   reg0=0.1, seed=3)
    sgd_cfg = SGDConfig(batch_size=16, learning_rate=0.1,
                        optimizer="adagrad", unique_budget=128)
    _run_parity(cfg, sgd_cfg, _batches(rng, 16, 5, 64, 4))


def test_parity_classification_plain_sgd_dup_heavy():
    rng = np.random.default_rng(1)
    cfg = FMConfig(num_features=32, num_factors=3,
                   task=Task.CLASSIFICATION, reg_v=0.01, seed=7)
    sgd_cfg = SGDConfig(batch_size=8, learning_rate=0.05,
                        optimizer="sgd", unique_budget=64)
    bs = _batches(rng, 8, 6, 32, 4, dup_heavy=True)
    bs = [SparseBatch(ids=b.ids, vals=b.vals,
                      y=jnp.asarray((np.asarray(b.y) > 0).astype(np.float32)),
                      mask=b.mask) for b in bs]
    _run_parity(cfg, sgd_cfg, bs)


def test_parity_with_example_mask():
    rng = np.random.default_rng(2)
    cfg = FMConfig(num_features=48, num_factors=4, reg_w=0.005,
                   reg_v=0.01, seed=11)
    sgd_cfg = SGDConfig(batch_size=16, learning_rate=0.1,
                        optimizer="adagrad", unique_budget=128)
    _run_parity(cfg, sgd_cfg, _batches(rng, 16, 4, 48, 3, with_mask=True))


def test_parity_no_linear_no_bias():
    rng = np.random.default_rng(3)
    cfg = FMConfig(num_features=32, num_factors=2, use_linear=False,
                   use_bias=False, seed=5)
    sgd_cfg = SGDConfig(batch_size=8, learning_rate=0.2,
                        optimizer="adagrad", unique_budget=64)
    _run_parity(cfg, sgd_cfg, _batches(rng, 8, 4, 32, 3))


def test_loss_decreases_end_to_end():
    """Drive the sorted path alone for many steps on a learnable synthetic
    problem and require the loss to drop substantially."""
    rng = np.random.default_rng(4)
    F, B, L = 256, 64, 6
    cfg = FMConfig(num_features=F, num_factors=8, seed=0)
    sgd_cfg = SGDConfig(batch_size=B, learning_rate=0.2,
                        optimizer="adagrad", unique_budget=512)
    true_w = rng.normal(size=F).astype(np.float32)
    state = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(2))
    step = sgd_sorted.make_sorted_train_step(cfg, sgd_cfg)
    first = last = None
    for i in range(60):
        ids = rng.integers(0, F, (B, L)).astype(np.int32)
        vals = np.ones((B, L), np.float32)
        y = true_w[ids].sum(axis=1).astype(np.float32)
        batch = SparseBatch(ids=jnp.asarray(ids), vals=jnp.asarray(vals),
                            y=jnp.asarray(y), mask=jnp.ones((B,), bool))
        state, aux = step(state, batch)
        if i == 0:
            first = float(aux["loss"])
        last = float(aux["loss"])
    assert last < 0.2 * first, (first, last)
