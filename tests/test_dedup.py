"""Dedup table-access path tests (ops/embedding.py + the dedup SGD step).

The dedup path must be an exact drop-in for the direct XLA gather/scatter
path: same math, one big-table touch per unique id.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sparkfm_tpu as sfm
from sparkfm_tpu.config import FMConfig, SGDConfig, Task
from sparkfm_tpu.data.batching import SparseBatch
from sparkfm_tpu.models import fm as fm_model
from sparkfm_tpu.ops import embedding as E
from sparkfm_tpu.solvers import sgd as sgd_solver


class TestDedupIds:
    def test_plan_reconstructs_ids(self):
        rng = np.random.default_rng(0)
        ids = jnp.asarray(rng.integers(0, 50, (16, 7)).astype(np.int32))
        plan = E.dedup_ids(ids, budget=64, fill=100)
        uids = np.asarray(plan.uids)
        ranks = np.asarray(plan.ranks)
        np.testing.assert_array_equal(uids[ranks], np.asarray(ids))
        assert int(plan.count) == len(np.unique(np.asarray(ids)))
        assert not bool(plan.overflow)
        # budget slots beyond count hold the fill id
        assert (uids[int(plan.count):] == 100).all()
        # unique section is sorted ascending
        u = uids[:int(plan.count)]
        assert (np.diff(u) > 0).all()

    def test_overflow_flag(self):
        ids = jnp.asarray(np.arange(128, dtype=np.int32).reshape(8, 16))
        plan = E.dedup_ids(ids, budget=32, fill=999)
        assert bool(plan.overflow)
        # ranks are clamped into the budget
        assert int(jnp.max(plan.ranks)) == 31

    def test_spread_accumulate_adjoint(self):
        rng = np.random.default_rng(1)
        ids = jnp.asarray(rng.integers(0, 30, (8, 5)).astype(np.int32))
        plan = E.dedup_ids(ids, budget=32, fill=40)
        rows_u = jnp.asarray(rng.normal(size=(32, 4)).astype(np.float32))
        g = jnp.asarray(rng.normal(size=(8, 5, 4)).astype(np.float32))
        # <spread(rows), g> == <rows, accumulate(g)>
        lhs = jnp.sum(E.spread(rows_u, plan) * g)
        rhs = jnp.sum(rows_u * E.accumulate_to_unique(g, plan, 32))
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-5)


def _mk_batch(rng, B, L, F):
    return SparseBatch(
        ids=jnp.asarray(rng.integers(0, F, (B, L)).astype(np.int32)),
        vals=jnp.asarray(rng.normal(size=(B, L)).astype(np.float32)),
        y=jnp.asarray(rng.normal(size=(B,)).astype(np.float32)),
        mask=jnp.ones((B,), bool))


class TestDedupStepParity:
    @pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
    def test_one_step_matches_direct(self, optimizer):
        F, B, L, K = 200, 32, 6, 4
        cfg = FMConfig(num_features=F, num_factors=K, reg_w=0.01,
                       reg_v=0.01, seed=0)
        base = SGDConfig(learning_rate=0.1, optimizer=optimizer,
                         batch_size=B)
        rng = np.random.default_rng(2)
        batch = _mk_batch(rng, B, L, F)
        params = fm_model.init_params(cfg, jax.random.PRNGKey(0))
        copy = lambda p: jax.tree_util.tree_map(jnp.array, p)

        s_d = sgd_solver.init_state(copy(params))
        step_d = sgd_solver.make_train_step(
            cfg, sgd_solver.dataclasses.replace(base, update_path="direct"))
        s_d, aux_d = step_d(s_d, batch)

        s_u = sgd_solver.pad_state_for_dedup(
            sgd_solver.init_state(copy(params)))
        step_u = sgd_solver.make_train_step(
            cfg, sgd_solver.dataclasses.replace(base, update_path="dedup"))
        s_u, aux_u = step_u(s_u, batch)

        np.testing.assert_allclose(float(aux_d["loss"]),
                                   float(aux_u["loss"]), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(s_u.params.w[:F]),
                                   np.asarray(s_d.params.w), atol=2e-6)
        np.testing.assert_allclose(np.asarray(s_u.params.v[:F]),
                                   np.asarray(s_d.params.v), atol=2e-6)
        np.testing.assert_allclose(np.asarray(s_u.slot_w[:F]),
                                   np.asarray(s_d.slot_w), atol=2e-6)

    def test_multi_step_parity_adagrad(self):
        F, B, L, K = 128, 16, 4, 3
        cfg = FMConfig(num_features=F, num_factors=K, reg_v=0.01, seed=1)
        rng = np.random.default_rng(3)
        batches = [_mk_batch(rng, B, L, F) for _ in range(5)]
        params = fm_model.init_params(cfg, jax.random.PRNGKey(1))
        copy = lambda p: jax.tree_util.tree_map(jnp.array, p)

        s_d = sgd_solver.init_state(copy(params))
        step_d = sgd_solver.make_train_step(
            cfg, SGDConfig(learning_rate=0.1, update_path="direct"))
        s_u = sgd_solver.pad_state_for_dedup(
            sgd_solver.init_state(copy(params)))
        step_u = sgd_solver.make_train_step(
            cfg, SGDConfig(learning_rate=0.1, update_path="dedup"))
        for b in batches:
            s_d, _ = step_d(s_d, b)
            s_u, _ = step_u(s_u, b)
        np.testing.assert_allclose(np.asarray(s_u.params.v[:F]),
                                   np.asarray(s_d.params.v), atol=1e-5)

    def test_ffm_dedup_parity(self):
        F, B, L, K, NF = 96, 16, 6, 4, 6
        cfg = FMConfig(num_features=F, num_factors=K, num_fields=NF,
                       reg_v=0.01, seed=0)
        rng = np.random.default_rng(5)
        b = _mk_batch(rng, B, L, F)
        batch = SparseBatch(ids=b.ids, vals=b.vals, y=b.y, mask=b.mask,
                            field_ids=jnp.asarray(
                                rng.integers(0, NF, (B, L)).astype(np.int32)))
        params = fm_model.init_params(cfg, jax.random.PRNGKey(2))
        copy = lambda p: jax.tree_util.tree_map(jnp.array, p)
        s_d = sgd_solver.init_state(copy(params))
        step_d = sgd_solver.make_train_step(
            cfg, SGDConfig(learning_rate=0.1, update_path="direct"))
        s_d, _ = step_d(s_d, batch)
        s_u = sgd_solver.pad_state_for_dedup(
            sgd_solver.init_state(copy(params)))
        step_u = sgd_solver.make_train_step(
            cfg, SGDConfig(learning_rate=0.1, update_path="dedup"))
        s_u, _ = step_u(s_u, batch)
        np.testing.assert_allclose(np.asarray(s_u.params.v[:F]),
                                   np.asarray(s_d.params.v), atol=2e-6)


class TestFusedPath:
    def test_fused_step_matches_direct_adagrad(self):
        from sparkfm_tpu.solvers import sgd_fused
        F, B, L, K = 180, 32, 6, 4
        cfg = FMConfig(num_features=F, num_factors=K, reg_w=0.01,
                       reg_v=0.01, seed=0)
        rng = np.random.default_rng(11)
        batches = [_mk_batch(rng, B, L, F) for _ in range(3)]
        params = fm_model.init_params(cfg, jax.random.PRNGKey(0))
        copy = lambda p: jax.tree_util.tree_map(jnp.array, p)

        s_d = sgd_solver.init_state(copy(params))
        step_d = sgd_solver.make_train_step(
            cfg, SGDConfig(learning_rate=0.1, update_path="direct"))
        s_f = sgd_fused.fused_from_params(copy(params), cfg)
        step_f = sgd_fused.make_fused_train_step(
            cfg, SGDConfig(learning_rate=0.1, update_path="fused"))
        for b in batches:
            s_d, aux_d = step_d(s_d, b)
            s_f, aux_f = step_f(s_f, b)
        np.testing.assert_allclose(float(aux_f["loss"]),
                                   float(aux_d["loss"]), rtol=1e-6)
        p_f = sgd_fused.params_from_fused(s_f, cfg)
        np.testing.assert_allclose(np.asarray(p_f.w), np.asarray(s_d.params.w),
                                   atol=2e-6)
        np.testing.assert_allclose(np.asarray(p_f.v), np.asarray(s_d.params.v),
                                   atol=2e-6)
        np.testing.assert_allclose(float(p_f.w0), float(s_d.params.w0),
                                   rtol=1e-5)

    def test_fused_roundtrip_params(self):
        from sparkfm_tpu.solvers import sgd_fused
        cfg = FMConfig(num_features=50, num_factors=6, seed=3)
        params = fm_model.init_params(cfg, jax.random.PRNGKey(3))
        st = sgd_fused.fused_from_params(params, cfg)
        assert st.table.shape == (51, 128)
        back = sgd_fused.params_from_fused(st, cfg)
        np.testing.assert_allclose(np.asarray(back.v), np.asarray(params.v))
        np.testing.assert_allclose(np.asarray(back.w), np.asarray(params.w))

    def test_fused_end_to_end_training(self):
        from sparkfm_tpu.data import synth
        from sparkfm_tpu.training import trainer
        ds = synth.synth_movielens(num_users=40, num_items=50,
                                   num_examples=2000, seed=0)
        cfg = FMConfig(num_features=ds.num_features, num_factors=4,
                       reg_v=0.01, seed=0)
        res = trainer.train_sgd(
            cfg, SGDConfig(batch_size=256, epochs=8, learning_rate=0.1,
                           update_path="fused"),
            ds, eval_ds=ds, eval_every=7)
        rmses = [h["eval_rmse"] for h in res.history if "eval_rmse" in h]
        assert rmses[-1] < 0.6
        assert res.params.w.shape[0] == ds.num_features

    def test_fused_rejects_adam_accepts_ffm(self):
        from sparkfm_tpu.solvers import sgd_fused
        cfg = FMConfig(num_features=32, num_factors=4)
        with pytest.raises(ValueError):
            sgd_fused.make_fused_train_step(
                cfg, SGDConfig(optimizer="adam"))
        # FFM is supported since round 5 (flat v block widens the record);
        # record: [v (nf*k) | slot_v | w | slot_w | pad]
        st = sgd_fused.init_fused_state(cfg.replace(num_fields=3))
        assert st.table.shape == (33, sgd_fused.record_width(4, 3))
        assert sgd_fused.record_width(4, 3) == 128  # 2*12+2 -> 128


def test_train_sgd_dedup_end_to_end():
    from sparkfm_tpu.data import synth
    from sparkfm_tpu.training import trainer

    ds = synth.synth_movielens(num_users=40, num_items=50,
                               num_examples=2000, seed=0)
    cfg = FMConfig(num_features=ds.num_features, num_factors=4,
                   reg_v=0.01, seed=0)
    res = trainer.train_sgd(
        cfg, SGDConfig(batch_size=256, epochs=8, learning_rate=0.1,
                       update_path="dedup"),
        ds, eval_ds=ds, eval_every=7)
    rmses = [h["eval_rmse"] for h in res.history if "eval_rmse" in h]
    assert rmses[-1] < 0.6
    # returned params are trimmed back to logical size
    assert res.params.w.shape[0] == ds.num_features


def test_host_dedup_matches_device_plan():
    """ops.embedding.host_dedup must equal dedup_ids element-for-element."""
    import numpy as np
    import jax.numpy as jnp
    from sparkfm_tpu.ops import embedding as E
    rng = np.random.default_rng(11)
    for trial in range(4):
        b, l = int(rng.integers(2, 20)), int(rng.integers(1, 9))
        f = int(rng.integers(4, 200))
        budget = int(rng.integers(2, b * l + 8))
        ids = rng.integers(0, f, (b, l)).astype(np.int32)
        hp = E.host_dedup(ids, budget, fill=f)
        dp = E.dedup_ids(jnp.asarray(ids), budget, fill=f)
        np.testing.assert_array_equal(hp.uids, np.asarray(dp.uids))
        np.testing.assert_array_equal(hp.ranks, np.asarray(dp.ranks))
        assert int(hp.count) == int(dp.count)
        assert bool(hp.overflow) == bool(dp.overflow)


def test_fused_step_with_host_plan_matches_device_plan():
    import numpy as np
    import jax
    import jax.numpy as jnp
    from sparkfm_tpu.config import FMConfig, SGDConfig
    from sparkfm_tpu.data.batching import SparseBatch
    from sparkfm_tpu.ops import embedding as E
    from sparkfm_tpu.solvers import sgd_fused
    rng = np.random.default_rng(3)
    cfg = FMConfig(num_features=64, num_factors=4, reg_v=0.01, seed=1)
    sgd_cfg = SGDConfig(batch_size=8, learning_rate=0.1,
                        optimizer="adagrad", unique_budget=32)
    step = sgd_fused.make_fused_train_step(cfg, sgd_cfg)
    s_dev = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(0))
    s_host = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(0))
    for _ in range(3):
        ids = rng.integers(0, 64, (8, 5)).astype(np.int32)
        vals = rng.normal(size=(8, 5)).astype(np.float32)
        y = rng.normal(size=(8,)).astype(np.float32)
        base = dict(ids=jnp.asarray(ids), vals=jnp.asarray(vals),
                    y=jnp.asarray(y), mask=jnp.ones((8,), bool))
        hp = E.host_dedup(ids, 32, fill=64)
        plan = E.DedupBatch(uids=jnp.asarray(hp.uids),
                            ranks=jnp.asarray(hp.ranks),
                            count=jnp.asarray(hp.count),
                            overflow=jnp.asarray(hp.overflow))
        s_dev, _ = step(s_dev, SparseBatch(**base))
        s_host, _ = step(s_host, SparseBatch(**base, plan=plan))
    np.testing.assert_allclose(np.asarray(s_host.table[:64]),
                               np.asarray(s_dev.table[:64]),
                               rtol=1e-6, atol=1e-7)


def test_prefetch_iterator_equivalence():
    import numpy as np
    from sparkfm_tpu.data import synth
    from sparkfm_tpu.data.batching import batch_iterator, prefetch
    ds = synth.synth_movielens(num_users=10, num_items=10,
                               num_examples=100, seed=0)
    a = list(batch_iterator(ds, 16, shuffle=True, seed=1, epoch=2))
    b = list(prefetch(batch_iterator(ds, 16, shuffle=True, seed=1,
                                     epoch=2)))
    assert len(a) == len(b)
    for x, z in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x.ids), np.asarray(z.ids))


def test_plan_order_seg_consistency():
    """Both plan builders emit the sort permutation + sorted dense ranks:
    ids[order] must be non-decreasing and seg must equal ranks[order]."""
    import numpy as np
    import jax.numpy as jnp
    from sparkfm_tpu.ops import embedding as E
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 50, (6, 7)).astype(np.int32)
    for plan in (E.dedup_ids(jnp.asarray(ids), 64, fill=50),
                 E.host_dedup(ids, 64, fill=50)):
        order = np.asarray(plan.order)
        seg = np.asarray(plan.seg)
        flat = ids.reshape(-1)
        assert sorted(order.tolist()) == list(range(flat.size))
        sid = flat[order]
        assert np.all(np.diff(sid) >= 0)
        np.testing.assert_array_equal(
            seg, np.asarray(plan.ranks).reshape(-1)[order])


def test_accumulate_sorted_matches_scatter():
    import numpy as np
    import jax.numpy as jnp
    from sparkfm_tpu.ops import embedding as E
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 40, (5, 6)).astype(np.int32)
    g = rng.normal(size=(5, 6, 9)).astype(np.float32)
    plan = E.dedup_ids(jnp.asarray(ids), 48, fill=40)
    a = E.accumulate_to_unique(jnp.asarray(g), plan, 48)
    b = E.accumulate_to_unique_sorted(jnp.asarray(g), plan, 48)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-5, atol=1e-6)


def test_fused_step_segsum_matches_scatter():
    """accumulate='segsum' (hybrid permute + segment-sum) changes only
    float summation order vs the scatter-add accumulate."""
    import dataclasses
    import numpy as np
    import jax
    import jax.numpy as jnp
    from sparkfm_tpu.config import FMConfig, SGDConfig
    from sparkfm_tpu.data.batching import SparseBatch
    from sparkfm_tpu.ops import embedding as E
    from sparkfm_tpu.solvers import sgd_fused
    rng = np.random.default_rng(13)
    cfg = FMConfig(num_features=64, num_factors=4, reg_v=0.01, seed=1)
    for opt in ("adagrad", "adagrad_row", "sgd"):
        base_cfg = SGDConfig(batch_size=8, learning_rate=0.1,
                             optimizer=opt, unique_budget=32)
        states = {}
        for acc in ("scatter", "segsum"):
            sgd_cfg = dataclasses.replace(base_cfg, accumulate=acc)
            step = sgd_fused.make_fused_train_step(cfg, sgd_cfg)
            s = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(0))
            r = np.random.default_rng(5)
            for _ in range(3):
                ids = r.integers(0, 64, (8, 5)).astype(np.int32)
                hp = E.host_dedup(ids, 32, fill=64)
                plan = jax.tree.map(jnp.asarray, hp)
                b = SparseBatch(ids=jnp.asarray(ids),
                                vals=jnp.asarray(
                                    r.normal(size=(8, 5)).astype(np.float32)),
                                y=jnp.asarray(
                                    r.normal(size=(8,)).astype(np.float32)),
                                mask=jnp.ones((8,), bool), plan=plan)
                s, _ = step(s, b)
            states[acc] = np.asarray(s.table[:64])
        np.testing.assert_allclose(states["segsum"], states["scatter"],
                                   rtol=1e-5, atol=1e-6)


def test_adagrad_row_rejected_off_fused_path():
    """optimizer='adagrad_row' exists only on the fused-record layout;
    the direct/dedup element-wise paths must raise instead of silently
    training with un-normalized plain-SGD steps (VERDICT r1 item 4)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import pytest
    from sparkfm_tpu.config import FMConfig, SGDConfig
    from sparkfm_tpu.data.batching import SparseBatch
    from sparkfm_tpu.models import fm as fm_model
    from sparkfm_tpu.solvers import sgd as sgd_solver
    cfg = FMConfig(num_features=32, num_factors=4, seed=0)
    b = SparseBatch(ids=jnp.zeros((4, 3), jnp.int32),
                    vals=jnp.ones((4, 3), jnp.float32),
                    y=jnp.zeros((4,), jnp.float32),
                    mask=jnp.ones((4,), bool))
    for path in ("direct", "dedup"):
        sgd_cfg = SGDConfig(batch_size=4, optimizer="adagrad_row",
                            update_path=path, unique_budget=16)
        step = sgd_solver.make_train_step(cfg, sgd_cfg)
        state = sgd_solver.init_state(fm_model.init_params(cfg))
        if path == "dedup":
            state = sgd_solver.pad_state_for_dedup(state)
        with pytest.raises(ValueError, match="adagrad_row"):
            step(state, b)


def test_adagrad_row_auto_routes_to_fused_layout():
    """auto path selection must send adagrad_row to the fused-record
    layout even for small tables (where auto would otherwise pick
    'direct'): hybrid with host plans, fused without."""
    from sparkfm_tpu.config import FMConfig, SGDConfig
    from sparkfm_tpu.solvers import sgd as sgd_solver
    cfg = FMConfig(num_features=32, num_factors=4)
    sgd_cfg = SGDConfig(batch_size=4, optimizer="adagrad_row",
                        update_path="auto")
    assert sgd_solver.resolve_update_path(cfg, sgd_cfg) == "hybrid"
    sgd_cfg = SGDConfig(batch_size=4, optimizer="adagrad_row",
                        update_path="auto", host_plan=False)
    assert sgd_solver.resolve_update_path(cfg, sgd_cfg) == "fused"


def test_auto_routes_big_tables_to_hybrid():
    """Big tables + host plans -> hybrid (the measured-fastest path);
    each hybrid restriction falls back to fused/dedup (VERDICT r2 item 1)."""
    from sparkfm_tpu.config import FMConfig, SGDConfig
    from sparkfm_tpu.solvers import sgd as sgd_solver
    big = FMConfig(num_features=1 << 20, num_factors=8)
    mk = lambda **kw: SGDConfig(batch_size=4, **kw)
    assert sgd_solver.resolve_update_path(big, mk()) == "hybrid"
    assert sgd_solver.resolve_update_path(big, mk(host_plan=False)) == "fused"
    assert sgd_solver.resolve_update_path(big, mk(momentum=0.9)) == "dedup"
    assert sgd_solver.resolve_update_path(big, mk(optimizer="adam")) == "dedup"
    groups = FMConfig(num_features=1 << 20, num_factors=8,
                      feature_groups=tuple([0] * (1 << 20)))
    assert sgd_solver.resolve_update_path(groups, mk()) == "fused"
    ffm = FMConfig(num_features=1 << 20, num_factors=8, num_fields=3)
    assert sgd_solver.resolve_update_path(ffm, mk()) == "fused"   # round 5
    assert sgd_solver.resolve_update_path(
        ffm, mk(optimizer="adam")) == "dedup"
    small = FMConfig(num_features=64, num_factors=8)
    assert sgd_solver.resolve_update_path(small, mk()) == "direct"


def test_fused_step_validates_accumulate():
    """Unknown accumulate values and segsum-without-order plans must raise
    instead of silently selecting the scatter path (ADVICE r1 item 1)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import pytest
    from sparkfm_tpu.config import FMConfig, SGDConfig
    from sparkfm_tpu.data.batching import SparseBatch
    from sparkfm_tpu.ops import embedding as E
    from sparkfm_tpu.solvers import sgd_fused
    cfg = FMConfig(num_features=64, num_factors=4, seed=1)
    with pytest.raises(ValueError, match="accumulate"):
        sgd_fused.make_fused_train_step(
            cfg, SGDConfig(batch_size=8, accumulate="segsumm"))

    # Forced segsum with a plan built without order/seg: loud error.
    sgd_cfg = SGDConfig(batch_size=8, optimizer="adagrad",
                        unique_budget=32, accumulate="segsum")
    step = sgd_fused.make_fused_train_step(cfg, sgd_cfg)
    state = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(0))
    ids = np.arange(40, dtype=np.int32).reshape(8, 5) % 64
    hp = E.host_dedup(ids, 32, fill=64)
    plan = E.DedupBatch(uids=jnp.asarray(hp.uids),
                        ranks=jnp.asarray(hp.ranks),
                        count=jnp.asarray(hp.count),
                        overflow=jnp.asarray(hp.overflow),
                        order=None, seg=None)
    b = SparseBatch(ids=jnp.asarray(ids), vals=jnp.ones((8, 5), jnp.float32),
                    y=jnp.zeros((8,), jnp.float32),
                    mask=jnp.ones((8,), bool), plan=plan)
    with pytest.raises(ValueError, match="order"):
        step(state, b)


def test_accumulate_sorted_scalar_payload():
    """Per-slot scalar payloads (shape == ids shape) ride the sorted
    accumulate as a width-1 column (ADVICE r1 item 3); ndim > 2 trailing
    shapes are rejected."""
    import numpy as np
    import jax.numpy as jnp
    import pytest
    from sparkfm_tpu.ops import embedding as E
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 40, (5, 6)).astype(np.int32)
    g = rng.normal(size=(5, 6)).astype(np.float32)   # scalar per slot
    plan = E.dedup_ids(jnp.asarray(ids), 48, fill=40)
    a = E.accumulate_to_unique(jnp.asarray(g), plan, 48)
    b = E.accumulate_to_unique_sorted(jnp.asarray(g), plan, 48)
    assert b.shape == (48,)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-5, atol=1e-6)
    g3 = rng.normal(size=(5, 6, 2, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="payload"):
        E.accumulate_to_unique_sorted(jnp.asarray(g3), plan, 48)


def test_accumulate_sorted_fused_shapes():
    """The sorted accumulate on fused-step payload shapes (k+3 and 2k+2
    lanes, N << U) matches the scatter-add accumulate and a float64
    NumPy oracle (ADVICE r1 item 2)."""
    import numpy as np
    import jax.numpy as jnp
    from sparkfm_tpu.ops import embedding as E
    rng = np.random.default_rng(17)
    k = 4
    ids = rng.integers(0, 30, (8, 5)).astype(np.int32)
    plan = E.dedup_ids(jnp.asarray(ids), 32, fill=30)
    for width in (k + 3, 2 * k + 2):
        g = rng.normal(size=(8, 5, width)).astype(np.float32)
        a = E.accumulate_to_unique(jnp.asarray(g), plan, 32)
        b = E.accumulate_to_unique_sorted(jnp.asarray(g), plan, 32)
        want = np.zeros((32, width), np.float64)
        np.add.at(want, np.asarray(plan.ranks).reshape(-1),
                  g.reshape(-1, width).astype(np.float64))
        assert b.shape == (32, width)
        np.testing.assert_allclose(np.asarray(b), want, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_fill_slot_writes_identical():
    """Guard for the unique_indices=True scatter hint (ADVICE r2,
    ops/embedding.write_rows): dedup plans repeat the fill id in unused
    budget slots, so uniqueness is violated on the dummy row. That is
    benign ONLY while every duplicate fill slot writes an identical row.
    Assert that invariant on the real dedup step by intercepting
    write_rows under disable_jit."""
    from sparkfm_tpu.ops import embedding as E

    rng = np.random.default_rng(5)
    F, K, B, L = 40, 4, 8, 5
    cfg = FMConfig(num_features=F, num_factors=K, seed=0)
    sgd_cfg = SGDConfig(learning_rate=0.1, optimizer="adagrad",
                        update_path="dedup", unique_budget=64)
    params = fm_model.init_params(cfg, jax.random.PRNGKey(0))
    state = sgd_solver.pad_state_for_dedup(sgd_solver.init_state(params))
    step = sgd_solver.make_train_step(cfg, sgd_cfg)
    ids = jnp.asarray(rng.integers(0, F, (B, L)).astype(np.int32))
    batch = SparseBatch(ids=ids, vals=jnp.ones((B, L), jnp.float32),
                        y=jnp.asarray(rng.normal(size=(B,)),
                                      jnp.float32),
                        mask=jnp.ones((B,), bool))

    recorded = []
    orig = E.write_rows

    def spy(table, sids, rows, **kw):
        sids_np = np.asarray(sids)
        fill_rows = np.asarray(rows)[sids_np == F]  # dummy row id is F
        recorded.append(fill_rows)
        return orig(table, sids, rows, **kw)

    E.write_rows = spy
    try:
        with jax.disable_jit():
            step(state, batch)
    finally:
        E.write_rows = orig

    assert recorded, "dedup step never hit write_rows"
    saw_dupes = False
    for fill_rows in recorded:
        if fill_rows.shape[0] > 1:
            saw_dupes = True
            np.testing.assert_array_equal(
                fill_rows, np.broadcast_to(fill_rows[:1], fill_rows.shape))
    assert saw_dupes, "budget never exceeded uniques; invariant untested"


def test_ladder_budget_rungs():
    """ladder_budget returns the smallest quarter-octave rung (m*2^k,
    m in 4..7) >= count, capped — so plans pad <= 25% over the true
    unique count (VERDICT r2 #1)."""
    from sparkfm_tpu.ops.embedding import ladder_budget
    rungs = sorted({1, 2, 3, 4} |
                   {m << k for m in (4, 5, 6, 7) for k in range(17)})
    for c in (0, 1, 2, 3, 4, 5, 6, 7, 9, 100, 1000, 32768, 33000,
              40287, 40960, 40961, 49152, 49153, 68392, 100000):
        r = ladder_budget(c, cap=1 << 18)
        assert r >= min(max(c, 1), 1 << 18)
        assert r in rungs or r == (1 << 18), (c, r)
        # tightness: the next rung down is below count
        smaller = [x for x in rungs if x < r]
        if smaller and c > 4 and r < (1 << 18):
            assert max(smaller) < c, (c, r)
        if c > 4:
            assert r <= 1.25 * c or r == (1 << 18), (c, r)
    assert ladder_budget(40287) == 40960          # the measured case
    assert ladder_budget(68392) == 81920
    assert ladder_budget(10 ** 9, cap=1 << 18) == 1 << 18


def test_batch_iterator_ladder_plans():
    """dedup_budget='ladder': plan budgets are tight rungs >= the actual
    count, monotonic across batches, and can never overflow."""
    import numpy as np
    from sparkfm_tpu.data.batching import SparseDataset, batch_iterator
    from sparkfm_tpu.ops.embedding import ladder_budget
    rng = np.random.default_rng(0)
    n, L, F = 64, 5, 4096
    # first batches have few uniques, later ones many -> rung must grow
    ids = np.concatenate([
        rng.integers(0, 8, (n // 2, L)),
        rng.integers(0, F, (n // 2, L))]).astype(np.int32)
    ds = SparseDataset(ids=ids, vals=np.ones((n, L), np.float32),
                       y=np.zeros((n,), np.float32), num_features=F)
    rungs = []
    for b in batch_iterator(ds, 16, dedup_budget="ladder", dedup_fill=F):
        assert b.plan is not None
        u = b.plan.uids.shape[0]
        cnt = int(b.plan.count)
        assert u >= cnt and not bool(b.plan.overflow)
        assert u >= ladder_budget(cnt)
        rungs.append(u)
    assert rungs == sorted(rungs), rungs          # monotonic
    assert rungs[0] < rungs[-1]                   # actually grew


def test_eval_scoring_exact_on_plan_overflow(monkeypatch):
    """Ladder plans are capped (auto_budget cap); a batch with more
    distinct ids than the cap overflows and host_dedup aliases the excess
    ranks onto the last slot — scoring through such a plan is WRONG.
    evaluate/predict_dataset must detect plan.overflow and fall back to
    exact plan-free scoring for that batch (ADVICE r3 medium)."""
    import jax
    import jax.numpy as jnp

    from sparkfm_tpu.api import FMModel
    from sparkfm_tpu.config import FMConfig
    from sparkfm_tpu.data.batching import SparseDataset
    from sparkfm_tpu.models import fm as fm_model
    from sparkfm_tpu.ops import embedding as E
    from sparkfm_tpu.training import trainer

    F = 1 << 16   # big-table threshold: the ladder branch activates
    cfg = FMConfig(num_features=F, num_factors=4, seed=0)
    params = fm_model.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    n, L = 64, 6
    ids = rng.choice(F, size=(n, L), replace=False).reshape(n, L) \
        .astype(np.int32)                       # all-distinct ids
    vals = rng.normal(size=(n, L)).astype(np.float32)
    ds = SparseDataset(ids=ids, vals=vals,
                       y=rng.normal(size=(n,)).astype(np.float32),
                       num_features=F)

    # Exact reference scores (no plan anywhere).
    exact = np.asarray(fm_model.scores(
        params, cfg, jnp.asarray(ids), jnp.asarray(vals)))

    # Force a tiny plan cap so every batch overflows its ladder plan.
    monkeypatch.setattr(E, "auto_budget",
                        lambda n_slots, cap=1 << 18: 8)
    m = FMModel(params=params, cfg=cfg)
    pred = m.predict_dataset(ds, batch_size=32)
    np.testing.assert_allclose(pred, exact, rtol=1e-5, atol=1e-6)

    ev = trainer.evaluate(params, cfg, ds, batch_size=32)
    want_rmse = float(np.sqrt(np.mean((exact - ds.y) ** 2)))
    assert abs(ev["rmse"] - want_rmse) < 1e-5


def test_fused_multi_step_matches_single_steps():
    """make_fused_multi_step(scan of G) == G single fused steps, FM and
    FFM shapes."""
    import jax
    import jax.numpy as jnp
    from sparkfm_tpu.data.batching import SparseBatch
    from sparkfm_tpu.ops import embedding as E
    from sparkfm_tpu.solvers import sgd_fused, sgd_hybrid

    rng = np.random.default_rng(6)
    for nf in (0, 3):
        L = 3 if nf else 4
        cfg = FMConfig(num_features=128, num_factors=4, num_fields=nf,
                       reg_v=0.01, seed=0,
                       slot_major_fields=bool(nf))
        sgd_cfg = SGDConfig(batch_size=16, learning_rate=0.1,
                            optimizer="adagrad")
        batches = []
        per = 128 // L
        for _ in range(4):
            ids = (rng.integers(0, per, (16, L)).astype(np.int32)
                   + per * np.arange(L, dtype=np.int32)[None, :])
            hp = E.host_dedup(ids, 64, fill=128)
            plan = E.DedupBatch(*[None if x is None else jnp.asarray(x)
                                  for x in hp])
            batches.append(SparseBatch(
                ids=jnp.asarray(ids),
                vals=jnp.asarray(rng.normal(size=(16, L)).astype(
                    np.float32)),
                y=jnp.asarray(rng.normal(size=(16,)).astype(np.float32)),
                mask=jnp.ones((16,), bool),
                field_ids=(jnp.asarray(np.broadcast_to(
                    np.arange(L, dtype=np.int32), (16, L)))
                    if nf else None),
                plan=plan))
        s1 = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(1))
        step = sgd_fused.make_fused_train_step(cfg, sgd_cfg)
        for b in batches:
            s1, a1 = step(s1, b)
        s2 = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(1))
        multi = sgd_fused.make_fused_multi_step(cfg, sgd_cfg)
        stacked = sgd_hybrid.stack_batches(batches)
        s2, a2 = multi(s2, stacked)
        np.testing.assert_allclose(float(a1["loss"]), float(a2["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(s1.table[:128]),
                                   np.asarray(s2.table[:128]),
                                   rtol=1e-5, atol=1e-7)
