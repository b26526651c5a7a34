"""Sharded-training tests on the 8-device virtual CPU mesh (conftest.py).

The core claim: the shard_map (data x model) train step computes the SAME
update as the single-device step — the mesh only changes where arrays live
and which collectives move them (SURVEY §2.7). Verified for pure-DP, pure-TP
and mixed meshes, for FM and FFM, including uneven tail batches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparkfm_tpu.config import FMConfig, SGDConfig, Task
from sparkfm_tpu.data import synth
from sparkfm_tpu.data.batching import SparseBatch, batch_iterator
from sparkfm_tpu.models import fm as fm_model
from sparkfm_tpu.parallel import mesh as M
from sparkfm_tpu.parallel import sharded_sgd
from sparkfm_tpu.solvers import sgd as sgd_solver


def _unshard(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_pair(mesh_shape, cfg, sgd_cfg, ds, steps=3):
    """Run N steps sharded and single-device from identical init; return
    both final states (with the sharded table truncated back to true F)."""
    mesh = M.make_mesh(*mesh_shape)
    state_sh, pcfg = sharded_sgd.init_sharded_state(cfg, mesh, key=jax.random.PRNGKey(3))
    step_sh = sharded_sgd.make_sharded_train_step(pcfg, sgd_cfg, mesh)

    # identical init for the reference path (truncate padded rows)
    params0 = fm_model.init_params(pcfg, jax.random.PRNGKey(3))
    state_ref = sgd_solver.init_state(params0)
    step_ref = sgd_solver.make_train_step(pcfg, sgd_cfg)

    it1 = batch_iterator(ds, sgd_cfg.batch_size, shuffle=False)
    it2 = batch_iterator(ds, sgd_cfg.batch_size, shuffle=False)
    losses_sh, losses_ref = [], []
    for _ in range(steps):
        b1, b2 = next(it1), next(it2)
        state_sh, aux1 = step_sh(state_sh, b1)
        state_ref, aux2 = step_ref(state_ref, b2)
        losses_sh.append(float(aux1["loss"]))
        losses_ref.append(float(aux2["loss"]))
    return state_sh, state_ref, losses_sh, losses_ref


@pytest.mark.parametrize("mesh_shape", [(8, 1), (1, 8), (4, 2), (2, 4)])
def test_sharded_step_matches_single_device(mesh_shape):
    ds = synth.synth_movielens(num_users=50, num_items=70,
                               num_examples=2000, seed=0)
    cfg = FMConfig(num_features=ds.num_features, num_factors=4,
                   reg_w=0.01, reg_v=0.05, seed=0)
    sgd_cfg = SGDConfig(batch_size=256, learning_rate=0.1,
                        optimizer="adagrad")
    st_sh, st_ref, l_sh, l_ref = _run_pair(mesh_shape, cfg, sgd_cfg, ds)
    np.testing.assert_allclose(l_sh, l_ref, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(st_sh.params.w0),
                               np.asarray(st_ref.params.w0), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(st_sh.params.w),
                               np.asarray(st_ref.params.w),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(st_sh.params.v),
                               np.asarray(st_ref.params.v),
                               rtol=1e-4, atol=1e-6)


def test_sharded_tail_batch_mask_exact():
    """Tail batch (masked padding rows) must not perturb the update."""
    ds = synth.synth_movielens(num_users=30, num_items=30,
                               num_examples=300, seed=1)
    cfg = FMConfig(num_features=ds.num_features, num_factors=2, seed=1)
    sgd_cfg = SGDConfig(batch_size=256, learning_rate=0.05, optimizer="sgd")
    st_sh, st_ref, l_sh, l_ref = _run_pair((4, 2), cfg, sgd_cfg, ds, steps=2)
    np.testing.assert_allclose(l_sh, l_ref, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(st_sh.params.v),
                               np.asarray(st_ref.params.v),
                               rtol=1e-4, atol=1e-6)


def test_sharded_ffm_matches_single_device():
    ds = synth.synth_ctr(num_examples=1024, num_fields=4, num_buckets=64,
                         seed=2)
    cfg = FMConfig(num_features=ds.num_features, num_factors=3, num_fields=4,
                   task=Task.CLASSIFICATION, reg_v=0.01, seed=2)
    sgd_cfg = SGDConfig(batch_size=256, learning_rate=0.05,
                        optimizer="adagrad")
    st_sh, st_ref, l_sh, l_ref = _run_pair((2, 4), cfg, sgd_cfg, ds, steps=3)
    np.testing.assert_allclose(l_sh, l_ref, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(st_sh.params.v),
                               np.asarray(st_ref.params.v),
                               rtol=1e-4, atol=1e-6)


def test_sharded_scores_match_dense_gather():
    ds = synth.synth_movielens(num_users=40, num_items=40,
                               num_examples=512, seed=3)
    mesh = M.make_mesh(2, 4)
    cfg = FMConfig(num_features=ds.num_features, num_factors=4, seed=3)
    state, pcfg = sharded_sgd.init_sharded_state(cfg, mesh)
    score_fn = sharded_sgd.make_sharded_score_fn(pcfg, mesh)
    b = next(batch_iterator(ds, 256, shuffle=False))
    s_sh = np.asarray(score_fn(state.params, b.ids, b.vals))
    s_ref = np.asarray(fm_model.scores(
        jax.tree_util.tree_map(np.asarray, state.params), pcfg,
        b.ids, b.vals))
    np.testing.assert_allclose(s_sh, s_ref, rtol=1e-5, atol=1e-6)


def test_sharded_training_improves_ctr_auc():
    """End-to-end sharded logistic FM on power-law CTR data improves AUC."""
    from sparkfm_tpu.data.split import split_by_random
    from sparkfm_tpu.ops import metrics as MM

    ds = synth.synth_ctr(num_examples=6000, num_fields=8, num_buckets=2048,
                         seed=4)
    coll = split_by_random(ds, 0.8, 0.2, seed=4)
    mesh = M.make_mesh(2, 4)
    cfg = FMConfig(num_features=ds.num_features, num_factors=8,
                   task=Task.CLASSIFICATION, reg_v=1e-4, seed=4)
    sgd_cfg = SGDConfig(batch_size=512, learning_rate=0.1,
                        optimizer="adagrad", epochs=3)
    state, pcfg = sharded_sgd.init_sharded_state(cfg, mesh)
    step = sharded_sgd.make_sharded_train_step(pcfg, sgd_cfg, mesh)
    score_fn = sharded_sgd.make_sharded_score_fn(pcfg, mesh)

    def auc_now(params):
        scores = []
        for b in batch_iterator(coll.test, 512, shuffle=False):
            s = np.asarray(score_fn(params, b.ids, b.vals))
            scores.append(s[np.asarray(b.mask)])
        s = np.concatenate(scores)
        return float(MM.auc(jnp.asarray(s), jnp.asarray(coll.test.y[:len(s)])))

    auc0 = auc_now(state.params)
    for epoch in range(sgd_cfg.epochs):
        for b in batch_iterator(coll.training, sgd_cfg.batch_size,
                                shuffle=True, seed=4, epoch=epoch):
            state, _ = step(state, b)
    auc1 = auc_now(state.params)
    assert auc1 > max(auc0, 0.55), (auc0, auc1)


def test_unique_vs_dense_exchange_parity():
    """Both exchange strategies compute the same update (float order aside)."""
    ds = synth.synth_ctr(num_examples=2048, num_fields=6, num_buckets=512,
                         seed=5)
    cfg = FMConfig(num_features=ds.num_features, num_factors=4,
                   task=Task.CLASSIFICATION, reg_w=1e-4, reg_v=1e-4, seed=5)
    sgd_cfg = SGDConfig(batch_size=256, learning_rate=0.1,
                        optimizer="adagrad")
    mesh = M.make_mesh(4, 2)
    states, losses = [], []
    for exchange in ("unique", "dense"):
        state, pcfg = sharded_sgd.init_sharded_state(
            cfg, mesh, key=jax.random.PRNGKey(7))
        step = sharded_sgd.make_sharded_train_step(
            pcfg, sgd_cfg, mesh, exchange=exchange)
        ls = []
        for i, b in enumerate(batch_iterator(ds, 256, shuffle=False)):
            if i == 4:
                break
            state, aux = step(state, b)
            ls.append(float(aux["loss"]))
        states.append(_unshard(state))
        losses.append(ls)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    np.testing.assert_allclose(states[0].params.w, states[1].params.w,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(states[0].params.v, states[1].params.v,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(states[0].slot_v, states[1].slot_v,
                               rtol=1e-4, atol=1e-6)


def test_unique_exchange_host_plan_matches_device_dedup():
    """Batches carrying stacked host plans (ops.embedding.stack_plans) give
    the same result as on-device dedup inside shard_map."""
    import dataclasses
    from sparkfm_tpu.ops import embedding as E

    ds = synth.synth_movielens(num_users=60, num_items=80,
                               num_examples=1500, seed=6)
    cfg = FMConfig(num_features=ds.num_features, num_factors=4,
                   reg_w=0.01, reg_v=0.01, seed=6)
    sgd_cfg = SGDConfig(batch_size=256, learning_rate=0.1,
                        optimizer="adagrad", unique_budget=256)
    mesh = M.make_mesh(4, 2)
    d = mesh.shape[M.DATA_AXIS]

    finals = []
    for with_plan in (False, True):
        state, pcfg = sharded_sgd.init_sharded_state(
            cfg, mesh, key=jax.random.PRNGKey(8))
        fill = pcfg.num_features - 1
        step = sharded_sgd.make_sharded_train_step(pcfg, sgd_cfg, mesh,
                                                   exchange="unique")
        for i, b in enumerate(batch_iterator(ds, 256, shuffle=False)):
            if i == 3:
                break
            if with_plan:
                plan = E.stack_plans(np.asarray(b.ids), d,
                                     budget=256, fill=fill)
                plan = jax.tree_util.tree_map(jnp.asarray, plan)
                b = dataclasses.replace(b, plan=plan)
            state, aux = step(state, b)
            assert not bool(aux["unique_overflow"])
        finals.append(_unshard(state))
    np.testing.assert_allclose(finals[0].params.w, finals[1].params.w,
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(finals[0].params.v, finals[1].params.v,
                               rtol=1e-5, atol=1e-7)


def test_sharded_adam_routes_dense_and_matches():
    """exchange='auto' must route adam to the dense exchange and still match
    the single-device adam step."""
    ds = synth.synth_movielens(num_users=40, num_items=50,
                               num_examples=1000, seed=9)
    cfg = FMConfig(num_features=ds.num_features, num_factors=3, seed=9)
    sgd_cfg = SGDConfig(batch_size=256, learning_rate=0.01, optimizer="adam")
    # Lazy adam's .at[].set of moments is last-writer-wins on duplicate ids
    # within a batch, and the sharded all_gather changes the write order —
    # so adam params are reproduced only up to duplicate-id moment races
    # (the same caveat the single-device direct path carries). Assert the
    # routing (dense exchange => no unique_count aux) and loss-level
    # agreement, not per-parameter equality.
    st_sh, st_ref, l_sh, l_ref = _run_pair((4, 2), cfg, sgd_cfg, ds, steps=3)
    np.testing.assert_allclose(l_sh, l_ref, rtol=5e-3)
    assert l_sh[-1] < l_sh[0]
    assert np.all(np.isfinite(np.asarray(st_sh.params.v)))


def test_unique_exchange_rejects_momentum():
    cfg = FMConfig(num_features=100, num_factors=2)
    sgd_cfg = SGDConfig(optimizer="sgd", momentum=0.9)
    mesh = M.make_mesh(4, 2)
    with pytest.raises(ValueError):
        sharded_sgd.make_sharded_train_step(cfg, sgd_cfg, mesh,
                                            exchange="unique")


def test_sharded_groups_parity_and_padding():
    """Per-group regularization on the mesh path (VERDICT r2 weak #3):
    init_sharded_state must pad feature_groups alongside num_features so
    cfg.reg_vectors() works under the padded config, padding/dummy rows
    carry ZERO reg, and the sharded step matches single-device exactly."""
    ds = synth.synth_movielens(num_users=30, num_items=40,
                               num_examples=1200, seed=1)
    F = ds.num_features
    groups = tuple(int(g) for g in np.r_[np.zeros(30, int),
                                         np.ones(F - 30, int)])
    cfg = FMConfig(num_features=F, num_factors=4, seed=0,
                   feature_groups=groups,
                   group_reg_w=(0.01, 0.2), group_reg_v=(0.05, 0.3))
    sgd_cfg = SGDConfig(batch_size=128, learning_rate=0.1,
                        optimizer="adagrad")

    mesh = M.make_mesh(2, 4)
    _, pcfg = sharded_sgd.init_sharded_state(cfg, mesh,
                                             key=jax.random.PRNGKey(0))
    rw, rv = pcfg.reg_vectors()   # crashed before the r3 fix
    assert rw.shape == (pcfg.num_features,)
    # padding rows (incl. the dedup dummy) sit in a zero-reg extra group
    np.testing.assert_array_equal(rw[F:], 0.0)
    np.testing.assert_array_equal(rv[F:], 0.0)
    np.testing.assert_allclose(rw[:30], 0.01)
    np.testing.assert_allclose(rv[30:F], 0.3)

    st_sh, st_ref, l_sh, l_ref = _run_pair((2, 4), cfg, sgd_cfg, ds)
    np.testing.assert_allclose(l_sh, l_ref, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(st_sh.params.v),
                               np.asarray(st_ref.params.v),
                               rtol=1e-4, atol=1e-6)


def test_global_exchange_matches_unique_and_dense():
    """The global-plan exchange (ONE psum of aligned per-unique sums —
    the pod-scale replacement for the all_gather backward) computes the
    same update as the unique and dense exchanges, on plain FM and FFM."""
    import dataclasses
    from sparkfm_tpu.ops import embedding as E

    for fields, mesh_shape in ((0, (4, 2)), (3, (2, 4))):
        ds = synth.synth_ctr(num_examples=1024,
                             num_fields=max(fields, 4),
                             num_buckets=512, seed=11)
        cfg = FMConfig(num_features=ds.num_features, num_factors=4,
                       num_fields=fields, task=Task.CLASSIFICATION,
                       reg_w=1e-4, reg_v=1e-4, seed=11)
        sgd_cfg = SGDConfig(batch_size=256, learning_rate=0.1,
                            optimizer="adagrad", unique_budget=512)
        mesh = M.make_mesh(*mesh_shape)
        states, losses = [], []
        for exchange in ("global", "unique"):
            state, pcfg = sharded_sgd.init_sharded_state(
                cfg, mesh, key=jax.random.PRNGKey(12))
            fill = pcfg.num_features - 1
            step = sharded_sgd.make_sharded_train_step(
                pcfg, sgd_cfg, mesh, exchange=exchange)
            ls = []
            for i, b in enumerate(batch_iterator(ds, 256, shuffle=False)):
                if i == 3:
                    break
                if exchange == "global":
                    hp = E.host_dedup(np.asarray(b.ids), 512, fill)
                    plan = E.DedupBatch(
                        uids=jnp.asarray(hp.uids),
                        ranks=jnp.asarray(hp.ranks),
                        count=jnp.asarray(hp.count),
                        overflow=jnp.asarray(hp.overflow),
                        order=None, seg=None)
                    b = dataclasses.replace(b, plan=plan)
                state, aux = step(state, b)
                assert not bool(aux["unique_overflow"])
                ls.append(float(aux["loss"]))
            states.append(_unshard(state))
            losses.append(ls)
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
        for fld in ("w", "v"):
            np.testing.assert_allclose(
                np.asarray(getattr(states[0].params, fld)),
                np.asarray(getattr(states[1].params, fld)),
                rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(states[0].slot_v),
                                   np.asarray(states[1].slot_v),
                                   rtol=1e-4, atol=1e-6)


def test_global_exchange_requires_global_plan():
    from sparkfm_tpu.ops import embedding as E

    ds = synth.synth_movielens(num_users=30, num_items=40,
                               num_examples=256, seed=13)
    cfg = FMConfig(num_features=ds.num_features, num_factors=2, seed=13)
    sgd_cfg = SGDConfig(batch_size=128, learning_rate=0.1)
    mesh = M.make_mesh(4, 2)
    state, pcfg = sharded_sgd.init_sharded_state(cfg, mesh)
    step = sharded_sgd.make_sharded_train_step(pcfg, sgd_cfg, mesh,
                                               exchange="global")
    b = next(iter(batch_iterator(ds, 128)))
    with pytest.raises(ValueError, match="global"):
        step(state, b)   # no plan at all
    import dataclasses
    stacked = E.stack_plans(np.asarray(b.ids), 4, budget=64,
                            fill=pcfg.num_features - 1)
    stacked = jax.tree_util.tree_map(
        lambda x: None if x is None else jnp.asarray(x), stacked,
        is_leaf=lambda x: x is None)
    with pytest.raises(ValueError, match="global"):
        step(state, dataclasses.replace(b, plan=stacked))


def test_global_exchange_groups_parity():
    """Global exchange with per-group regularization matches the unique
    exchange (groups ride _loss_sums_from_rows the same way)."""
    import dataclasses
    from sparkfm_tpu.ops import embedding as E

    ds = synth.synth_movielens(num_users=50, num_items=60,
                               num_examples=1024, seed=14)
    F = ds.num_features
    cfg = FMConfig(num_features=F, num_factors=4, seed=14,
                   feature_groups=tuple([0] * 50 + [1] * (F - 50)),
                   group_reg_w=(0.01, 0.1), group_reg_v=(0.02, 0.2))
    sgd_cfg = SGDConfig(batch_size=256, learning_rate=0.1,
                        optimizer="adagrad", unique_budget=512)
    mesh = M.make_mesh(2, 4)
    finals = []
    for exchange in ("global", "unique"):
        state, pcfg = sharded_sgd.init_sharded_state(
            cfg, mesh, key=jax.random.PRNGKey(15))
        fill = pcfg.num_features - 1
        step = sharded_sgd.make_sharded_train_step(pcfg, sgd_cfg, mesh,
                                                   exchange=exchange)
        for i, b in enumerate(batch_iterator(ds, 256, shuffle=False)):
            if i == 3:
                break
            if exchange == "global":
                hp = E.host_dedup(np.asarray(b.ids), 512, fill)
                b = dataclasses.replace(b, plan=E.DedupBatch(
                    uids=jnp.asarray(hp.uids), ranks=jnp.asarray(hp.ranks),
                    count=jnp.asarray(hp.count),
                    overflow=jnp.asarray(hp.overflow),
                    order=None, seg=None))
            state, _ = step(state, b)
        finals.append(_unshard(state))
    np.testing.assert_allclose(np.asarray(finals[0].params.v),
                               np.asarray(finals[1].params.v),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(finals[0].params.w),
                               np.asarray(finals[1].params.w),
                               rtol=1e-4, atol=1e-6)


def test_global_hybrid_extras_match_plain_global():
    """The per-shard analytic sorted backward (global exchange, hybrid
    extras from stack_hybrid_extras) computes the same update as the
    jax.grad-based plain global exchange."""
    import dataclasses
    from sparkfm_tpu.ops import embedding as E

    ds = synth.synth_ctr(num_examples=1024, num_fields=5, num_buckets=512,
                         seed=19)
    cfg = FMConfig(num_features=ds.num_features, num_factors=4,
                   task=Task.CLASSIFICATION, reg_w=1e-4, reg_v=1e-4,
                   seed=19)
    sgd_cfg = SGDConfig(batch_size=256, learning_rate=0.1,
                        optimizer="adagrad", unique_budget=512)
    for mesh_shape in ((4, 2), (2, 4)):
        mesh = M.make_mesh(*mesh_shape)
        d = mesh.shape[M.DATA_AXIS]
        finals, losses = [], []
        for hybrid in (True, False):
            state, pcfg = sharded_sgd.init_sharded_state(
                cfg, mesh, key=jax.random.PRNGKey(20))
            fill = pcfg.num_features - 1
            step = sharded_sgd.make_sharded_train_step(
                pcfg, sgd_cfg, mesh, exchange="global")
            ls = []
            for i, b in enumerate(batch_iterator(ds, 256, shuffle=False)):
                if i == 3:
                    break
                hp = E.host_dedup(np.asarray(b.ids), 512, fill,
                                  vals=np.asarray(b.vals))
                if hybrid:
                    seg, sv, sex, gmap, _ = E.stack_hybrid_extras(
                        hp.ranks, np.asarray(b.vals), d)
                    plan = E.DedupBatch(
                        uids=jnp.asarray(hp.uids),
                        ranks=jnp.asarray(hp.ranks),
                        count=jnp.asarray(hp.count),
                        overflow=jnp.asarray(hp.overflow),
                        order=jnp.asarray(gmap), seg=jnp.asarray(seg),
                        svals=jnp.asarray(sv), sex=jnp.asarray(sex))
                else:
                    plan = E.DedupBatch(
                        uids=jnp.asarray(hp.uids),
                        ranks=jnp.asarray(hp.ranks),
                        count=jnp.asarray(hp.count),
                        overflow=jnp.asarray(hp.overflow),
                        order=None, seg=None)
                b2 = dataclasses.replace(b, plan=plan)
                state, aux = step(state, b2)
                ls.append(float(aux["loss"]))
            finals.append(_unshard(state))
            losses.append(ls)
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
        np.testing.assert_allclose(np.asarray(finals[0].params.v),
                                   np.asarray(finals[1].params.v),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(finals[0].params.w),
                                   np.asarray(finals[1].params.w),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(finals[0].slot_v),
                                   np.asarray(finals[1].slot_v),
                                   rtol=1e-4, atol=1e-6)


def test_trainer_global_hybrid_end_to_end():
    """train_sgd(mesh=...) auto-builds hybrid extras for eligible configs
    and matches the pinned-unique exchange to the same quality."""
    from sparkfm_tpu.config import MeshConfig
    from sparkfm_tpu.data.split import split_by_random
    from sparkfm_tpu.training import trainer

    ds = synth.synth_movielens(num_users=50, num_items=60,
                               num_examples=1600, seed=23)
    coll = split_by_random(ds, 0.8, 0.2, seed=23)
    cfg = FMConfig(num_features=ds.num_features, num_factors=4,
                   reg_v=0.01, seed=23)
    sgd_cfg = SGDConfig(batch_size=256, learning_rate=0.1,
                        optimizer="adagrad", epochs=2,
                        shuffle_each_epoch=False)
    res_g = trainer.train_sgd(cfg, sgd_cfg, coll.training, coll.test,
                              mesh=MeshConfig(data=4, model=2))
    res_u = trainer.train_sgd(cfg, sgd_cfg, coll.training, coll.test,
                              mesh=MeshConfig(data=4, model=2,
                                              exchange="unique"))
    rg = res_g.history[-1]["eval_rmse"]
    ru = res_u.history[-1]["eval_rmse"]
    assert abs(rg - ru) < 1e-3, (rg, ru)


def test_global_batch_lifts_hybrid_extras():
    """multihost.global_batch(plan_mode="global_hybrid") must carry the
    sorted-backward extras (order=gmap/seg/svals/sex) through to the
    device batch — in round 3 it hardcoded order=None/seg=None, so the
    trainer's sharded-hybrid path silently fell back to jax.grad."""
    from sparkfm_tpu.ops import embedding as E
    from sparkfm_tpu.parallel import multihost as MH

    mesh = M.make_mesh(4, 2)
    d = mesh.shape[M.DATA_AXIS]
    rng = np.random.default_rng(0)
    B, L = 32, 4
    ids = rng.integers(0, 50, (B, L)).astype(np.int32)
    vals = rng.normal(size=(B, L)).astype(np.float32)
    b = SparseBatch(ids=jnp.asarray(ids), vals=jnp.asarray(vals),
                    y=jnp.zeros((B,), jnp.float32),
                    mask=jnp.ones((B,), bool))
    hp = E.host_dedup(ids, 64, 63)
    seg, sv, sex, gmap, _ = E.stack_hybrid_extras(hp.ranks, vals, d)
    plan = hp._replace(order=gmap, seg=seg, svals=sv, sex=sex)
    gb = MH.global_batch(mesh, b, plan=plan, plan_mode="global_hybrid")
    assert gb.plan.seg is not None and gb.plan.svals is not None
    assert gb.plan.sex is not None and gb.plan.order is not None
    np.testing.assert_array_equal(np.asarray(gb.plan.seg), seg)
    np.testing.assert_array_equal(np.asarray(gb.plan.order), gmap)
    np.testing.assert_allclose(np.asarray(gb.plan.svals), sv)
    np.testing.assert_array_equal(np.asarray(gb.plan.sex), sex)


def test_trainer_mesh_auto_path_runs_hybrid_backward(monkeypatch):
    """train_sgd(mesh=...) on an eligible config (plain FM, f32, adagrad,
    host plans) must actually trace the analytic sorted backward
    (fm_grad_segsum), not silently fall back to jax.grad."""
    from sparkfm_tpu.config import MeshConfig
    from sparkfm_tpu.ops import segsum as SS
    from sparkfm_tpu.training import trainer

    calls = []
    real = SS.fm_grad_segsum

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(SS, "fm_grad_segsum", spy)
    ds = synth.synth_movielens(num_users=30, num_items=40,
                               num_examples=512, seed=5)
    cfg = FMConfig(num_features=ds.num_features, num_factors=4,
                   reg_v=0.01, seed=5)
    sgd_cfg = SGDConfig(batch_size=128, learning_rate=0.1,
                        optimizer="adagrad", epochs=1,
                        shuffle_each_epoch=False)
    res = trainer.train_sgd(cfg, sgd_cfg, ds,
                            mesh=MeshConfig(data=4, model=2))
    assert calls, ("the sharded auto path never traced fm_grad_segsum — "
                   "hybrid extras were dropped before the step")
    assert np.isfinite(res.history[-1]["train_loss"])


def test_sharded_ffm_slot_major_matches_single_device():
    """cfg.slot_major_fields flows through the sharded loss/score (round
    5): identical updates to the single-device step on fixed-column CTR
    data, and identical to the aggregated-form sharded step."""
    ds = synth.synth_ctr(num_examples=512, num_fields=4, num_buckets=64,
                         seed=9)
    sgd_cfg = SGDConfig(batch_size=128, learning_rate=0.05,
                        optimizer="adagrad")
    outs = {}
    for sm in (False, True):
        cfg = FMConfig(num_features=ds.num_features, num_factors=3,
                       num_fields=4, task=Task.CLASSIFICATION,
                       reg_v=0.01, seed=9, slot_major_fields=sm)
        st_sh, st_ref, l_sh, l_ref = _run_pair((2, 4), cfg, sgd_cfg, ds,
                                               steps=2)
        np.testing.assert_allclose(l_sh, l_ref, rtol=1e-5)
        outs[sm] = np.asarray(st_sh.params.v)
    np.testing.assert_allclose(outs[True], outs[False],
                               rtol=1e-4, atol=1e-6)
