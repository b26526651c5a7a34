"""Hybrid sorted-backward step (solvers/sgd_hybrid.py) parity vs the
jax.grad-based fused step and the direct path, and the [Σg | Σg²]
segment sum."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparkfm_tpu.config import FMConfig, SGDConfig, Task
from sparkfm_tpu.data import synth
from sparkfm_tpu.data.batching import SparseBatch, batch_iterator
from sparkfm_tpu.ops import segsum as SS
from sparkfm_tpu.solvers import sgd_fused, sgd_hybrid


def _run(step_fn, cfg, ds, sgd_cfg, steps=3):
    state = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(5))
    budget = 512
    it = batch_iterator(ds, sgd_cfg.batch_size, shuffle=False,
                        dedup_budget=budget, dedup_fill=cfg.num_features)
    losses = []
    for i, b in enumerate(it):
        if i == steps:
            break
        state, aux = step_fn(state, b)
        losses.append(float(aux["loss"]))
    return state, losses


@pytest.mark.parametrize("task,opt", [
    (Task.REGRESSION, "adagrad"),
    (Task.CLASSIFICATION, "adagrad"),
    (Task.CLASSIFICATION, "adagrad_row"),
    (Task.REGRESSION, "sgd"),
])
def test_hybrid_matches_fused(task, opt):
    """Analytic sorted backward == jax.grad natural backward, including
    masked tail batches and per-appearance L2."""
    ds = synth.synth_movielens(num_users=40, num_items=60,
                               num_examples=700, seed=7)
    if task == Task.CLASSIFICATION:
        ds = dataclasses.replace(ds, y=(ds.y > 3.0).astype(np.float32))
    cfg = FMConfig(num_features=ds.num_features, num_factors=4, task=task,
                   reg0=0.01, reg_w=0.02, reg_v=0.03, seed=7)
    sgd_cfg = SGDConfig(batch_size=256, learning_rate=0.1, optimizer=opt)

    fused = sgd_fused.make_fused_train_step(cfg, sgd_cfg)
    hybrid = sgd_hybrid.make_hybrid_train_step(cfg, sgd_cfg)
    st_f, l_f = _run(fused, cfg, ds, sgd_cfg)
    st_h, l_h = _run(hybrid, cfg, ds, sgd_cfg)
    np.testing.assert_allclose(l_h, l_f, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(st_h.w0), np.asarray(st_f.w0),
                               rtol=1e-5, atol=1e-7)
    f = cfg.num_features
    np.testing.assert_allclose(np.asarray(st_h.table[:f]),
                               np.asarray(st_f.table[:f]),
                               rtol=1e-4, atol=1e-6)


def test_hybrid_requires_host_plan_payloads():
    ds = synth.synth_movielens(num_users=20, num_items=20,
                               num_examples=300, seed=8)
    cfg = FMConfig(num_features=ds.num_features, num_factors=2, seed=8)
    sgd_cfg = SGDConfig(batch_size=128, optimizer="adagrad")
    step = sgd_hybrid.make_hybrid_train_step(cfg, sgd_cfg)
    state = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(0))
    b = next(batch_iterator(ds, 128, shuffle=False))   # no plan
    with pytest.raises(ValueError):
        step(state, b)


def test_segment_rowsum_sq_oracle():
    """[Σg | Σg²] vs a float64 numpy oracle, including overflow ranks
    clipped to the last budget slot."""
    rng = np.random.default_rng(0)
    for n, w, u in [(2048, 33, 300), (4096, 17, 4096), (2048, 64, 5)]:
        incr = (rng.random(n) < 0.15).astype(np.int64)
        incr[0] = 0
        seg = np.minimum(np.cumsum(incr), u - 1).astype(np.int32)
        g = rng.normal(size=(n, w)).astype(np.float32)
        want = np.zeros((u, 2 * w), np.float64)
        np.add.at(want, seg, np.concatenate([g, g * g], 1).astype(np.float64))
        scale = 1 + np.abs(want)
        got = np.asarray(SS.segment_rowsum_sq(
            jnp.asarray(g), jnp.asarray(seg), u))
        assert got.shape == (u, 2 * w)
        assert np.max(np.abs(got - want) / scale) < 5e-5


def test_multi_step_matches_sequential_steps():
    """make_hybrid_multi_step(scan over G stacked batches) produces the
    EXACT state sequence of G single steps (scan is sequential; the
    donated-table dependency chains through)."""
    from sparkfm_tpu.ops import embedding as E
    from sparkfm_tpu.solvers import sgd_fused, sgd_hybrid

    rng = np.random.default_rng(7)
    B, L, F, k = 64, 6, 512, 4
    cfg = FMConfig(num_features=F, num_factors=k,
                   task=Task.CLASSIFICATION, reg_w=1e-4, reg_v=1e-4,
                   seed=7)
    sgd_cfg = SGDConfig(batch_size=B, learning_rate=0.1,
                        optimizer="adagrad", unique_budget=512)

    def mk():
        ids = rng.integers(0, F, (B, L)).astype(np.int32)
        vals = np.ones((B, L), np.float32)
        hp = E.host_dedup(ids, 512, F, vals=vals)
        plan = E.DedupBatch(
            uids=jnp.asarray(hp.uids), ranks=jnp.asarray(hp.ranks),
            count=jnp.asarray(hp.count), overflow=jnp.asarray(hp.overflow),
            order=jnp.asarray(hp.order), seg=jnp.asarray(hp.seg),
            svals=jnp.asarray(hp.svals), sex=jnp.asarray(hp.sex))
        return SparseBatch(
            ids=jnp.asarray(ids), vals=jnp.asarray(vals),
            y=jnp.asarray(rng.integers(0, 2, (B,)).astype(np.float32)),
            mask=jnp.ones((B,), bool), plan=plan)

    batches = [mk() for _ in range(4)]

    s1 = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(1))
    step = sgd_hybrid.make_hybrid_train_step(cfg, sgd_cfg)
    losses = []
    for b in batches:
        s1, aux = step(s1, b)
        losses.append(float(aux["loss"]))

    s2 = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(1))
    multi = sgd_hybrid.make_hybrid_multi_step(cfg, sgd_cfg, group=4)
    s2, maux = multi(s2, sgd_hybrid.stack_batches(batches))

    np.testing.assert_array_equal(np.asarray(s1.table),
                                  np.asarray(s2.table))
    np.testing.assert_allclose(float(s1.w0), float(s2.w0), rtol=1e-6)
    assert abs(float(maux["loss"]) - losses[-1]) < 1e-6
    assert abs(float(maux["loss_mean"]) - np.mean(losses)) < 1e-6
    assert not bool(maux["unique_overflow"])


def test_trainer_steps_per_dispatch_matches_single():
    """train_sgd with steps_per_dispatch=2 (hybrid multi-step grouping)
    reproduces the single-step run's final params bit-for-bit."""
    from sparkfm_tpu.config import FMConfig as FC, SGDConfig as SC
    from sparkfm_tpu.training import trainer

    ds = synth.synth_ctr(num_examples=1024, num_fields=5,
                         num_buckets=1 << 17, seed=9)
    cfg = FC(num_features=1 << 17, num_factors=4,
             task=Task.CLASSIFICATION, reg_v=1e-4, seed=9)
    common = dict(batch_size=128, learning_rate=0.1, optimizer="adagrad",
                  epochs=2, shuffle_each_epoch=True,
                  update_path="hybrid")
    r1 = trainer.train_sgd(cfg, SC(**common), ds,
                           key=jax.random.PRNGKey(9))
    r2 = trainer.train_sgd(cfg, SC(steps_per_dispatch=2, **common), ds,
                           key=jax.random.PRNGKey(9))
    np.testing.assert_array_equal(np.asarray(r1.params.v),
                                  np.asarray(r2.params.v))
    np.testing.assert_array_equal(np.asarray(r1.params.w),
                                  np.asarray(r2.params.w))
    l1 = [h["train_loss"] for h in r1.history]
    l2 = [h["train_loss"] for h in r2.history]
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
