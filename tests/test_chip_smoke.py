"""CPU tests of what chip_smoke.py and the benchmarks rely on: the
compile-cache location, the card line, the no-GPU failure, and every
comparison function the smoke run applies on the card, at tiny widths."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as C
from sparkfm_tpu.utils import compile_cache
from sparkfm_tpu.utils.device import parse_gpu_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, env_extra, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


_COMPILE = ("from sparkfm_tpu.utils.compile_cache import "
            "enable_compile_cache as e; d = e(); import jax, jax.numpy as "
            "jnp; jax.jit(lambda x: x * 3 + 1)(jnp.ones(5))."
            "block_until_ready(); print(d); "
            "print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_env_set_is_used_as_is(tmp_path):
    cache = tmp_path / "cache"
    r = _python(_COMPILE, {"JAX_PLATFORMS": "cpu",
                           "JAX_COMPILATION_CACHE_DIR": str(cache),
                           "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
                           "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "0"})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(cache), str(cache)]
    assert any(p.name.endswith("-cache") for p in cache.iterdir())


def test_compile_cache_env_unset_uses_checkout():
    r = _python(_COMPILE, {"JAX_PLATFORMS": "cpu"},
                drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    want = os.path.join(REPO, ".jax_cache")
    assert r.stdout.split() == [want, want]
    assert compile_cache.CHECKOUT_CACHE == want


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n", ("NVIDIA H100 80GB HBM3",
                                           "700.00 W")),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n",
     ("NVIDIA H100 80GB HBM3", "500.00 W")),
    ("  Some, Card, 350 W  ", ("Some, Card", "350 W")),
])
def test_parse_gpu_line(text, want):
    assert parse_gpu_line(text) == want


@pytest.mark.parametrize("text", ["", "\n", "no comma here", ", 700 W"])
def test_parse_gpu_line_rejects(text):
    with pytest.raises(ValueError):
        parse_gpu_line(text)


def test_chip_smoke_fails_without_gpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_rel_err_and_check():
    assert C.rel_err([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert C.rel_err([3.0], [1.0]) == pytest.approx(1.0)
    C.check("same", 0.0, lambda m: None)
    with pytest.raises(AssertionError):
        C.check("far", 2 * C.TOL, lambda m: None)
    with pytest.raises(AssertionError):
        C.rel_err(np.zeros(3), np.zeros(4))


def test_segment_sum_oracle_matches_add_at():
    rng = np.random.default_rng(0)
    seg = C.dense_ranks(np.sort(rng.integers(0, 30, 200)))
    rows = rng.normal(size=(200, 3))
    want = np.zeros((40, 3))
    np.add.at(want, seg, rows)
    np.testing.assert_allclose(C.segment_sum_np(rows, seg, 40), want)


def test_fm_grad_segsum_and_colsums_errors_small():
    rng = np.random.default_rng(1)
    seg = C.dense_ranks(np.sort(rng.integers(0, 500, 3000)))
    u = int(seg[-1]) + 7                          # unused budget rows
    assert C.fm_grad_segsum_error(seg, u, k=4) < C.TOL
    assert C.colsums_error(seg, u) < C.TOL


def test_padded_plan_has_fill_slot():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 100, (16, 39)).astype(np.int32)
    hp, rung = C.padded_plan(ids, np.ones_like(ids, np.float32), fill=100)
    assert rung > int(hp.count)
    assert hp.uids.shape == (rung,) and hp.uids[-1] == 100


def _tiny_cfg(num_features=1 << 16, k=4, reg=1e-2):
    import sparkfm_tpu as sfm
    cfg = sfm.FMConfig(num_features=num_features, num_factors=k,
                       task=sfm.Task.CLASSIFICATION, reg_w=reg, reg_v=reg,
                       seed=3)
    return cfg, sfm.SGDConfig(batch_size=64, learning_rate=0.05,
                              optimizer="adagrad")


def test_hybrid_vs_direct_criteo_layout():
    """The hybrid step's plain reduce matches the direct path after one
    step on the Criteo layout (39 one-hot fields), tiny widths."""
    from sparkfm_tpu.data import synth
    from sparkfm_tpu.models import fm as fm_model
    cfg, sgd_cfg = _tiny_cfg()
    ds = synth.synth_ctr(num_examples=64, num_fields=39,
                         num_buckets=cfg.num_features, seed=5)
    params = fm_model.init_params(cfg, jax.random.PRNGKey(3))
    errs = C.hybrid_vs_direct(cfg, sgd_cfg, params, ds.ids, ds.vals, ds.y)
    assert set(errs) == {"loss", "w0", "w", "v"}
    assert max(errs.values()) < C.TOL, errs


def test_serve_error_small():
    import sparkfm_tpu as sfm
    from sparkfm_tpu.data import synth
    from sparkfm_tpu.models import fm as fm_model
    cfg, _ = _tiny_cfg()
    params = fm_model.init_params(cfg.replace(init_stdev=0.3),
                                  jax.random.PRNGKey(1))
    model = sfm.FMModel(params=params, cfg=cfg)
    ds = synth.synth_ctr(num_examples=80, num_fields=39,
                         num_buckets=cfg.num_features, seed=6)
    reqs = [(ds.ids[:1], ds.vals[:1]), (ds.ids[1:80], ds.vals[1:80])]
    assert C.serve_error(model, reqs) < C.TOL


def test_mesh_vs_single_four_devices():
    """The sharded (data=2, model=2) step with global exchange + hybrid
    extras matches the one-device hybrid step, on 4 of the 8 virtual CPU
    devices."""
    from sparkfm_tpu.data import synth
    from sparkfm_tpu.parallel import mesh as M
    cfg, sgd_cfg = _tiny_cfg(reg=1e-6)
    mesh = M.make_mesh(2, 2, devices=jax.devices()[:4])
    ds = synth.synth_ctr(num_examples=3 * 64, num_fields=39,
                         num_buckets=cfg.num_features, seed=7)
    batches = [(ds.ids[i:i + 64], ds.vals[i:i + 64], ds.y[i:i + 64])
               for i in range(0, 3 * 64, 64)]
    errs, state = C.mesh_vs_single(cfg, sgd_cfg, mesh, batches,
                                   jax.random.PRNGKey(0))
    assert len(state.params.v.sharding.device_set) == 4
    assert max(errs.values()) < C.TOL, errs


def test_trace_scope_parsing():
    """benchmarks/hybrid_trace.py attributes operations to the segment
    reduce by the named scope in the compiled HLO's metadata."""
    from benchmarks import hybrid_trace as H
    text = "\n".join([
        '  %wrapped_scatter = f32[8,2]{1,0} fusion(%a), kind=kInput, '
        'metadata={op_name="jit(step)/fm_grad_segsum/scatter-add"}',
        '  ROOT %gather.3 = f32[4]{0} gather(%b), '
        'metadata={op_name="jit(step)/fm_grad_segsum/fm_grad_segsum/gather"}',
        '  %other = f32[4]{0} add(%c, %d), '
        'metadata={op_name="jit(step)/fm_grad_segsum_x/add"}',
        '  %plain = f32[4]{0} add(%c, %d)',
    ])
    assert H.scoped_ops(text) == {"wrapped_scatter", "gather_3"}
