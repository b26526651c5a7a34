"""FFM interaction op tests.

The field-aggregated O(B·F²·K) path (ops/interaction.py::
ffm_interaction_from_rows, VERDICT r1 item 7) against the direct per-pair
O(B·L²·K) oracle and a slot-loop brute force.
"""

import jax.numpy as jnp
import numpy as np

from sparkfm_tpu.ops import interaction as I


def _brute_ffm(w0, wr, vr, vals, fids):
    """Per-pair python loop: sum_{a<b} <v_a[f_b], v_b[f_a]> x_a x_b."""
    B, L = vals.shape
    out = np.zeros((B,), np.float64)
    for b in range(B):
        for a in range(L):
            for c in range(a + 1, L):
                out[b] += (vr[b, a, fids[b, c]] @ vr[b, c, fids[b, a]]
                           ) * vals[b, a] * vals[b, c]
        out[b] += w0 + np.sum(wr[b] * vals[b])
    return out


def _rand_case(seed, B=5, L=9, F=4, K=3):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(B, L)).astype(np.float32)
    vals[:, -2:] = 0.0                       # padding slots
    fids = rng.integers(0, F, (B, L)).astype(np.int32)
    vr = rng.normal(size=(B, L, F, K)).astype(np.float32)
    wr = rng.normal(size=(B, L)).astype(np.float32)
    return vals, fids, vr, wr


def test_field_aggregated_matches_pairwise():
    """Aggregated == pairwise, with multi-hot fields (several slots share a
    field) and padded slots."""
    vals, fids, vr, wr = _rand_case(0)
    w0 = jnp.float32(0.37)
    agg = I.ffm_scores_from_gathered(
        w0, jnp.asarray(wr), jnp.asarray(vr), jnp.asarray(vals),
        jnp.asarray(fids), 4)
    pair = I.ffm_scores_pairwise(
        w0, jnp.asarray(wr), jnp.asarray(vr), jnp.asarray(vals),
        jnp.asarray(fids), 4)
    np.testing.assert_allclose(np.asarray(agg), np.asarray(pair),
                               rtol=2e-5, atol=2e-5)


def test_field_aggregated_matches_brute_force():
    vals, fids, vr, wr = _rand_case(1)
    w0 = 0.11
    agg = I.ffm_scores_from_gathered(
        jnp.float32(w0), jnp.asarray(wr), jnp.asarray(vr), jnp.asarray(vals),
        jnp.asarray(fids), 4)
    brute = _brute_ffm(w0, wr, vr, vals, fids)
    np.testing.assert_allclose(np.asarray(agg), brute, rtol=1e-4, atol=1e-4)


def test_slot_major_matches_aggregated_and_grads():
    """slot-major transpose form == aggregated form when field_ids ==
    arange (one slot per field), values AND gradients."""
    import jax
    rng = np.random.default_rng(2)
    B, F, K = 4, 6, 3
    L = F
    vals = rng.normal(size=(B, L)).astype(np.float32)
    vals[:, -1] = 0.0
    fids = np.broadcast_to(np.arange(F, dtype=np.int32), (B, L)).copy()
    vr = rng.normal(size=(B, L, F, K)).astype(np.float32)
    wr = rng.normal(size=(B, L)).astype(np.float32)
    w0 = jnp.float32(0.2)

    def score_sum(vr_, slot_major):
        s = I.ffm_scores_from_gathered(
            w0, jnp.asarray(wr), vr_, jnp.asarray(vals),
            jnp.asarray(fids), F, slot_major=slot_major)
        return jnp.sum(jnp.square(s)), s

    (_, s_sm), g_sm = jax.value_and_grad(
        lambda v: score_sum(v, True), has_aux=True)(jnp.asarray(vr))
    (_, s_ag), g_ag = jax.value_and_grad(
        lambda v: score_sum(v, False), has_aux=True)(jnp.asarray(vr))
    np.testing.assert_allclose(np.asarray(s_sm), np.asarray(s_ag),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(g_sm), np.asarray(g_ag),
                               rtol=2e-5, atol=2e-5)
    # field_ids may be omitted entirely on the slot-major path
    s_none = I.ffm_scores_from_gathered(
        w0, jnp.asarray(wr), jnp.asarray(vr), jnp.asarray(vals),
        None, F, slot_major=True)
    np.testing.assert_allclose(np.asarray(s_none), np.asarray(s_ag),
                               rtol=2e-5, atol=2e-5)


def test_slot_major_rejects_ragged_shapes():
    import pytest
    vals, fids, vr, wr = _rand_case(3)     # L=9 != F=4
    with pytest.raises(ValueError, match="slot-major"):
        I.ffm_scores_from_gathered(
            jnp.float32(0.0), jnp.asarray(wr), jnp.asarray(vr),
            jnp.asarray(vals), jnp.asarray(fids), 4, slot_major=True)


def test_fused_ffm_step_matches_dedup():
    """The fused-record FFM step (round 5) == the dedup-path FFM step,
    adagrad, host plans, several steps."""
    import jax
    from sparkfm_tpu.config import FMConfig, SGDConfig, Task
    from sparkfm_tpu.data.batching import SparseBatch
    from sparkfm_tpu.models import fm as fm_model
    from sparkfm_tpu.ops import embedding as E
    from sparkfm_tpu.solvers import sgd as sgd_solver
    from sparkfm_tpu.solvers import sgd_fused

    rng = np.random.default_rng(4)
    Fq, K, R, B = 5, 3, 64, 8
    L = Fq
    cfg = FMConfig(num_features=R, num_factors=K, num_fields=Fq,
                   task=Task.CLASSIFICATION, reg_w=0.01, reg_v=0.02,
                   seed=0, slot_major_fields=True)
    sgd_cfg = SGDConfig(batch_size=B, learning_rate=0.05,
                        optimizer="adagrad")
    assert sgd_solver.resolve_update_path(cfg, sgd_cfg) == "direct"  # small
    params = fm_model.init_params(cfg, jax.random.PRNGKey(0))

    # deep-copy one side: both steps donate their state, and the two
    # states would otherwise share the initial w0 buffer
    s_ded = sgd_solver.pad_state_for_dedup(
        sgd_solver.init_state(jax.tree.map(jnp.copy, params),
                              optimizer="adagrad"))
    step_ded = sgd_solver._make_dedup_train_step(cfg, sgd_cfg)
    s_fus = sgd_fused.fused_from_params(params, cfg)
    step_fus = sgd_fused.make_fused_train_step(cfg, sgd_cfg)

    per = R // Fq
    budget = 32
    for i in range(4):
        ids = (rng.integers(0, per, (B, L)).astype(np.int32)
               + per * np.arange(L, dtype=np.int32)[None, :])
        vals = rng.normal(size=(B, L)).astype(np.float32)
        y = rng.integers(0, 2, (B,)).astype(np.float32)
        fid = np.broadcast_to(np.arange(Fq, dtype=np.int32), (B, L))
        hp = E.host_dedup(ids, budget, fill=R, vals=vals)
        plan = E.DedupBatch(*[None if x is None else jnp.asarray(x)
                              for x in hp])
        batch = SparseBatch(ids=jnp.asarray(ids), vals=jnp.asarray(vals),
                            y=jnp.asarray(y), mask=jnp.ones((B,), bool),
                            field_ids=jnp.asarray(fid), plan=plan)
        s_ded, aux_d = step_ded(s_ded, batch)
        s_fus, aux_f = step_fus(s_fus, batch)
        np.testing.assert_allclose(float(aux_d["loss"]),
                                   float(aux_f["loss"]),
                                   rtol=1e-5, atol=1e-6)
    p_d = sgd_solver.trim_params(s_ded.params, R)
    p_f = sgd_fused.params_from_fused(s_fus, cfg)
    np.testing.assert_allclose(np.asarray(p_d.w0), np.asarray(p_f.w0),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(p_d.w), np.asarray(p_f.w),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(p_d.v), np.asarray(p_f.v),
                               rtol=1e-5, atol=1e-6)


def test_resolve_update_path_ffm_fused():
    """Big-table FFM resolves to fused (round 5); adam still to dedup."""
    from sparkfm_tpu.config import FMConfig, SGDConfig
    from sparkfm_tpu.solvers import sgd as sgd_solver
    cfg = FMConfig(num_features=1 << 20, num_fields=22, num_factors=8)
    assert sgd_solver.resolve_update_path(
        cfg, SGDConfig(optimizer="adagrad")) == "fused"
    assert sgd_solver.resolve_update_path(
        cfg, SGDConfig(optimizer="adam")) == "dedup"


def test_facade_autodetects_slot_major_fields():
    """FM.fit routes fixed-column CTR data to the slot-major interaction
    automatically; ragged field layouts stay on the aggregated form."""
    from sparkfm_tpu.api import FM, _detect_slot_major
    from sparkfm_tpu.data import synth
    ds = synth.synth_ctr(num_examples=512, num_fields=4, num_buckets=64,
                         seed=0)
    assert _detect_slot_major(ds, 4)
    assert not _detect_slot_major(ds, 3)          # wrong field count
    fm = FM(num_factors=2, solver="sgd", max_iter=1, num_fields=4,
            task="classification", batch_size=128)
    cfg = fm._cfg(ds)
    assert cfg.slot_major_fields
    # ragged: shuffle one row's fields
    import dataclasses as dc
    fids = np.array(ds.field_ids)
    fids[0] = fids[0][::-1]
    ragged = dc.replace(ds, field_ids=fids)
    assert not _detect_slot_major(ragged, 4)


def test_ffm_bf16_compute_trains_close_to_f32():
    """compute_dtype='bfloat16' on the fused FFM path: trains, and the
    first-step loss sits within bf16 tolerance of f32."""
    import jax
    from sparkfm_tpu.config import FMConfig, SGDConfig, Task
    from sparkfm_tpu.data.batching import SparseBatch
    from sparkfm_tpu.ops import embedding as E
    from sparkfm_tpu.solvers import sgd_fused

    rng = np.random.default_rng(8)
    Fq, K, R, B = 4, 2, 64, 16
    per = R // Fq
    ids = (rng.integers(0, per, (B, Fq)).astype(np.int32)
           + per * np.arange(Fq, dtype=np.int32)[None, :])
    hp = E.host_dedup(ids, 64, fill=R)
    plan = E.DedupBatch(*[None if x is None else jnp.asarray(x)
                          for x in hp])
    batch = SparseBatch(
        ids=jnp.asarray(ids), vals=jnp.ones((B, Fq), jnp.float32),
        y=jnp.asarray(rng.integers(0, 2, (B,)).astype(np.float32)),
        mask=jnp.ones((B,), bool),
        field_ids=jnp.asarray(np.broadcast_to(
            np.arange(Fq, dtype=np.int32), (B, Fq))), plan=plan)
    losses = {}
    for cdt in ("float32", "bfloat16"):
        cfg = FMConfig(num_features=R, num_factors=K, num_fields=Fq,
                       task=Task.CLASSIFICATION, reg_v=0.01, seed=0,
                       slot_major_fields=True, compute_dtype=cdt)
        st = sgd_fused.init_fused_state(cfg, jax.random.PRNGKey(0))
        step = sgd_fused.make_fused_train_step(
            cfg, SGDConfig(batch_size=B, learning_rate=0.1))
        st, aux = step(st, batch)
        losses[cdt] = float(aux["loss"])
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"],
                               rtol=2e-2)
