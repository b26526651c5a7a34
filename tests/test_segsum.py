"""Per-unique-row reductions over sorted runs (ops/segsum.py) against a
float64 NumPy oracle: long runs, runs on power-of-two boundaries, unused
budget, every slot unique, odd widths and lengths, random stress, and the
FM gradient reduce in both its per-slot and unique-row forms."""

import numpy as np
import jax.numpy as jnp

from sparkfm_tpu.ops import segsum as S


def _ref(g, seg, u):
    out = np.zeros((u,) + g.shape[1:], np.float64)
    np.add.at(out, seg, g.astype(np.float64))
    return out


def _run(g, seg, u):
    out = S.segment_rowsum(jnp.asarray(g), jnp.asarray(seg), u)
    assert out.shape == (u, g.shape[1])
    np.testing.assert_allclose(np.asarray(out), _ref(g, seg, u),
                               rtol=1e-5, atol=1e-5)


def _dense_ranks(rng, n):
    incr = rng.integers(0, 2, n)
    incr[0] = 0
    return np.cumsum(incr).astype(np.int32)


def test_basic_runs():
    rng = np.random.default_rng(0)
    n, w = 64, 128
    seg = _dense_ranks(rng, n)
    u = int(seg[-1]) + 3
    g = rng.normal(size=(n, w)).astype(np.float32)
    _run(g, seg, u)


def test_one_run_over_all_slots():
    rng = np.random.default_rng(1)
    n, w = 64, 128
    seg = np.zeros(n, np.int32)          # one run over every slot
    g = rng.normal(size=(n, w)).astype(np.float32)
    _run(g, seg, 4)


def test_equal_length_runs():
    rng = np.random.default_rng(2)
    n, w, tile = 64, 128, 8
    seg = np.repeat(np.arange(n // tile), tile).astype(np.int32)
    g = rng.normal(size=(n, w)).astype(np.float32)
    _run(g, seg, n // tile)


def test_unused_budget_above_count_is_zero():
    """Dense ranks (dedup contract: start 0, increments of <=1) with a
    budget far above the rank count — unused slots must read zero."""
    rng = np.random.default_rng(3)
    n, w, u = 32, 128, 50
    seg = _dense_ranks(rng, n)                  # max ~16
    g = rng.normal(size=(n, w)).astype(np.float32)
    _run(g, seg, u)
    out = np.asarray(S.segment_rowsum(jnp.asarray(g), jnp.asarray(seg), u))
    assert not out[int(seg[-1]) + 1:].any()


def test_every_slot_unique():
    rng = np.random.default_rng(4)
    n, w = 64, 128
    seg = np.arange(n, dtype=np.int32)
    g = rng.normal(size=(n, w)).astype(np.float32)
    _run(g, seg, n)


def test_odd_width_and_length():
    rng = np.random.default_rng(5)
    n, w = 50, 66          # neither a power of two
    seg = _dense_ranks(rng, n)
    u = int(seg[-1]) + 5
    g = rng.normal(size=(n, w)).astype(np.float32)
    _run(g, seg, u)


def test_sorted_ids_with_gaps():
    """Sorted ids with gaps (not dense ranks) also reduce exactly."""
    rng = np.random.default_rng(6)
    n, w, u = 40, 16, 12
    seg = np.sort(rng.integers(0, u, n)).astype(np.int32)
    g = rng.normal(size=(n, w)).astype(np.float32)
    _run(g, seg, u)


def test_random_stress():
    rng = np.random.default_rng(7)
    for trial in range(5):
        n = int(rng.integers(17, 200))
        w = int(rng.choice([1, 33, 128]))
        seg = _dense_ranks(rng, n)
        u = int(seg[-1]) + int(rng.integers(1, 20))
        g = rng.normal(size=(n, w)).astype(np.float32)
        _run(g, seg, u)


def _fm_grad_ref(vw, ex, x, seg, u, cv, cw):
    """NumPy oracle for fm_grad_segsum: explicit gradient pack + segsum."""
    vw, ex, x = (a.astype(np.float64) for a in (vw, ex, x))
    k = vw.shape[1] - 1
    v, w = vw[:, :k], vw[:, k]
    s, ds, wt = ex[:, :k], ex[:, k], ex[:, k + 1]
    active = np.where(x != 0, wt, 0.0)
    dsx = ds * x
    g_v = dsx[:, None] * (s - v * x[:, None]) + cv * v * active[:, None]
    g_w = dsx + cw * w * active
    gpack = np.concatenate([g_v, g_w[:, None]], axis=1)
    packed = np.concatenate([gpack, np.square(gpack)], axis=1)
    return _ref(packed, seg, u)


def _mk_fm_grad_case(rng, n, k, u_extra=3):
    seg = _dense_ranks(rng, n)
    u = int(seg[-1]) + u_extra
    vw = rng.normal(size=(n, k + 1)).astype(np.float32)
    ex = rng.normal(size=(n, k + 2)).astype(np.float32)
    ex[:, k + 1] = rng.integers(0, 2, n)          # wt in {0,1}
    x = np.where(rng.random(n) < 0.2, 0.0,
                 rng.normal(size=n)).astype(np.float32)
    return vw, ex, x, seg, u


def test_fm_grad_segsum_matches_oracle():
    """The FM backward + reduce matches the explicit gradient-pack +
    segment-sum oracle at rank 4 and the Criteo rank 32."""
    rng = np.random.default_rng(11)
    cv, cw = 3e-3, 7e-3
    for k in (4, 32):
        vw, ex, x, seg, u = _mk_fm_grad_case(rng, 96, k)
        out = S.fm_grad_segsum(
            jnp.asarray(vw), jnp.asarray(ex), jnp.asarray(x),
            jnp.asarray(seg), u, cv, cw)
        assert out.shape == (u, 2 * k + 2)
        np.testing.assert_allclose(np.asarray(out),
                                   _fm_grad_ref(vw, ex, x, seg, u, cv, cw),
                                   rtol=1e-5, atol=1e-5)


def test_fm_grad_segsum_with_reg_matches_oracle():
    rng = np.random.default_rng(12)
    vw, ex, x, seg, u = _mk_fm_grad_case(rng, 50, 8)
    cv, cw = 1e-2, 2e-2
    out = S.fm_grad_segsum(jnp.asarray(vw), jnp.asarray(ex), jnp.asarray(x),
                           jnp.asarray(seg), u, cv, cw)
    np.testing.assert_allclose(np.asarray(out),
                               _fm_grad_ref(vw, ex, x, seg, u, cv, cw),
                               rtol=1e-5, atol=1e-5)


def test_fm_grad_segsum_long_runs():
    """Few long runs over an odd slot count, no regularization."""
    rng = np.random.default_rng(13)
    n, k = 70, 8
    seg = np.sort(rng.integers(0, 5, n)).astype(np.int32)
    # densify ranks (dedup contract): re-rank to consecutive
    _, seg = np.unique(seg, return_inverse=True)
    seg = seg.astype(np.int32)
    u = int(seg[-1]) + 2
    vw = rng.normal(size=(n, k + 1)).astype(np.float32)
    ex = rng.normal(size=(n, k + 2)).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    cv, cw = 0.0, 0.0
    out = S.fm_grad_segsum(jnp.asarray(vw), jnp.asarray(ex), jnp.asarray(x),
                           jnp.asarray(seg), u, cv, cw)
    np.testing.assert_allclose(np.asarray(out),
                               _fm_grad_ref(vw, ex, x, seg, u, cv, cw),
                               rtol=1e-5, atol=1e-5)


def _mk_factored_case(rng, n, k, u_extra=3):
    """Case where per-slot rows are consistent with a (U, k+1) unique
    matrix (the factored form's contract: one row per run)."""
    seg = _dense_ranks(rng, n)
    u = int(seg[-1]) + u_extra
    vw_u = rng.normal(size=(u, k + 1)).astype(np.float32)
    ex = rng.normal(size=(n, k + 2)).astype(np.float32)
    ex[:, k + 1] = rng.integers(0, 2, n)
    x = np.where(rng.random(n) < 0.2, 0.0,
                 rng.normal(size=n)).astype(np.float32)
    return vw_u, ex, x, seg, u


def test_fm_grad_factored_matches_oracle():
    """The unique-row form matches the explicit per-slot oracle."""
    rng = np.random.default_rng(21)
    cv, cw = 3e-3, 7e-3
    for k in (4, 32):
        vw_u, ex, x, seg, u = _mk_factored_case(rng, 96, k)
        ref = _fm_grad_ref(vw_u[seg], ex, x, seg, u, cv, cw)
        out = S.fm_grad_segsum_factored(
            jnp.asarray(vw_u), jnp.asarray(ex), jnp.asarray(x),
            jnp.asarray(seg), u, cv, cw)
        np.testing.assert_allclose(np.asarray(out), ref,
                                   rtol=1e-4, atol=1e-4)


def test_fm_grad_factored_equals_per_slot_form():
    """The unique-row form is the per-slot form fed vw_u[seg] —
    bit-identical (the parity contract the sharded tests rely on)."""
    rng = np.random.default_rng(22)
    vw_u, ex, x, seg, u = _mk_factored_case(rng, 50, 8)
    cv, cw = 1e-2, 2e-2
    a = S.fm_grad_segsum_factored(
        jnp.asarray(vw_u), jnp.asarray(ex), jnp.asarray(x),
        jnp.asarray(seg), u, cv, cw)
    b = S.fm_grad_segsum(
        jnp.asarray(vw_u[seg]), jnp.asarray(ex), jnp.asarray(x),
        jnp.asarray(seg), u, cv, cw)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fm_grad_factored_long_runs():
    rng = np.random.default_rng(23)
    n, k = 70, 8
    seg = np.sort(rng.integers(0, 5, n)).astype(np.int32)
    _, seg = np.unique(seg, return_inverse=True)
    seg = seg.astype(np.int32)
    u = int(seg[-1]) + 2
    vw_u = rng.normal(size=(u, k + 1)).astype(np.float32)
    ex = rng.normal(size=(n, k + 2)).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    cv, cw = 5e-3, 0.0
    out = S.fm_grad_segsum_factored(
        jnp.asarray(vw_u), jnp.asarray(ex), jnp.asarray(x),
        jnp.asarray(seg), u, cv, cw)
    np.testing.assert_allclose(
        np.asarray(out), _fm_grad_ref(vw_u[seg], ex, x, seg, u, cv, cw),
        rtol=1e-4, atol=1e-4)


def test_segment_colsums_matches_numpy():
    rng = np.random.default_rng(31)
    n = 90
    seg = _dense_ranks(rng, n)
    u = int(seg[-1]) + 3
    streams = [rng.normal(size=n).astype(np.float32) for _ in range(5)]
    ref = _ref(np.stack(streams, axis=1), seg, u)
    out = S.segment_colsums([jnp.asarray(s) for s in streams],
                            jnp.asarray(seg), u)
    assert out.shape == (u, 5)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-5)
