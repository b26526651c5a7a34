"""High-level facade: build -> fit -> model, with a pluggable solver.

Mirrors the reference's trainer facade (fm/FM.scala:25-33 `FM.apply` +
`learnWith(fml): FMModel`, fm/impl/FactorizationMachines.scala:30-49) as an
sklearn-flavored builder. One object configures everything; ``fit`` runs the
chosen solver (the reference's `learnWith` takes any FMLearn — here the
solver slot takes "sgd" | "als" or a callable); the returned :class:`FMModel`
predicts and computes metrics (reference: DS/Model.scala — with true MAE and
float-division accuracy, fixing Model.scala:22 and :29).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from sparkfm_tpu.config import ALSConfig, FMConfig, SGDConfig, Task
from sparkfm_tpu.data.batching import SparseDataset, batch_iterator
from sparkfm_tpu.models import fm as fm_core
from sparkfm_tpu.models.fm import FMParams
from sparkfm_tpu.training import trainer as _trainer


@dataclasses.dataclass
class FMModel:
    """A fitted model: parameters + config + metric helpers.

    The reference exposes predict/computeRMSE/computeMAE/computeAccuracy on
    its model object (FMModel.scala:34, Model.scala:13-30); same surface
    here, plus AUC/logloss for classification, batched and jitted.
    """

    params: FMParams
    cfg: FMConfig
    history: list = dataclasses.field(default_factory=list)
    examples_per_sec: float = 0.0

    def predict(self, ids, vals, field_ids=None) -> np.ndarray:
        """Predictions in output space: raw score (regression) or P(y=1)."""
        return np.asarray(fm_core.predict(
            self.params, self.cfg, jnp.asarray(ids), jnp.asarray(vals),
            None if field_ids is None else jnp.asarray(field_ids)))

    def predict_dataset(self, ds: SparseDataset,
                        batch_size: int = 8192) -> np.ndarray:
        # Big plain-FM tables: host ladder dedup plans -> one tight
        # unique-row gather per batch (the serving hot path; see
        # models/fm.scores).
        dedup_budget = dedup_fill = None
        if self.cfg.num_fields == 0 and self.cfg.num_features >= (1 << 16):
            # fill with the LAST row id: fill entries trail the sorted
            # uniques, so fill must compare >= every uid or the
            # indices_are_sorted gather promise in fm.scores is violated
            # (fill=0 put zeros after larger ids — undefined behavior)
            dedup_budget, dedup_fill = "ladder", self.cfg.num_features - 1
        outs = []
        for b in batch_iterator(ds, batch_size, shuffle=False,
                                dedup_budget=dedup_budget,
                                dedup_fill=dedup_fill):
            plan = b.plan
            if plan is not None and bool(plan.overflow):
                # capped ladder plan overflowed: aliased rows would score
                # wrong — use exact scoring for this batch (ADVICE r3)
                plan = None
            p = fm_core.predict(self.params, self.cfg, b.ids, b.vals,
                                b.field_ids, plan=plan)
            nvalid = int(np.sum(np.asarray(b.mask)))
            outs.append(np.asarray(p)[:nvalid])
        return np.concatenate(outs) if outs else np.zeros((0,))

    def evaluate(self, ds: SparseDataset,
                 batch_size: int = 8192) -> Dict[str, float]:
        return _trainer.evaluate(self.params, self.cfg, ds, batch_size)

    # Reference metric surface (Model.scala:13-30), corrected.
    def compute_rmse(self, ds: SparseDataset) -> float:
        p = self.predict_dataset(ds)
        return float(np.sqrt(np.mean(np.square(p - ds.y[:len(p)]))))

    def compute_mae(self, ds: SparseDataset) -> float:
        """True mean |error| (the reference's MAE lacks abs:
        Model.scala:22)."""
        p = self.predict_dataset(ds)
        return float(np.mean(np.abs(p - ds.y[:len(p)])))

    def compute_accuracy(self, ds: SparseDataset) -> float:
        """Float-division accuracy (the reference's Long division truncates
        to 0 or 1: Model.scala:29)."""
        p = self.predict_dataset(ds)
        if self.cfg.task == Task.CLASSIFICATION:
            pred_pos = p >= 0.5
        else:
            pred_pos = p > 0
        return float(np.mean(pred_pos == (ds.y[:len(p)] > 0)))

    def save(self, directory: str) -> None:
        from sparkfm_tpu.utils.checkpoint import Checkpointer
        with Checkpointer(directory, max_to_keep=1) as ck:
            ck.save(0, self.params,
                    extra={"cfg": _cfg_to_json(self.cfg)})

    @classmethod
    def load(cls, directory: str) -> "FMModel":
        from sparkfm_tpu.utils.checkpoint import Checkpointer
        with Checkpointer(directory, max_to_keep=1) as ck:
            raw, extra = ck.restore()
        cfg = _cfg_from_json(extra["cfg"])
        # Without a template, orbax restores the dataclass as a plain dict.
        if isinstance(raw, dict):
            params = FMParams(w0=jnp.asarray(raw["w0"]),
                              w=jnp.asarray(raw["w"]),
                              v=jnp.asarray(raw["v"]))
        else:
            params = raw
        return cls(params=params, cfg=cfg)


@dataclasses.dataclass
class DeepFMModel:
    """A fitted DeepFM (models/deepfm.py): FM tables + MLP tower.

    Same metric surface as :class:`FMModel`; predictions run both heads.
    """

    params: object                      # models.deepfm.DeepFMParams
    cfg: object                         # models.deepfm.DeepFMConfig
    history: list = dataclasses.field(default_factory=list)
    examples_per_sec: float = 0.0

    def predict(self, ids, vals, field_ids=None) -> np.ndarray:
        from sparkfm_tpu.models import deepfm as _d
        return np.asarray(_d.predict(self.params, self.cfg,
                                     jnp.asarray(ids), jnp.asarray(vals)))

    def predict_dataset(self, ds: SparseDataset,
                        batch_size: int = 8192) -> np.ndarray:
        from sparkfm_tpu.models import deepfm as _d
        outs = []
        for b in batch_iterator(ds, batch_size, shuffle=False):
            p = _d.predict(self.params, self.cfg, b.ids, b.vals)
            nvalid = int(np.sum(np.asarray(b.mask)))
            outs.append(np.asarray(p)[:nvalid])
        return np.concatenate(outs) if outs else np.zeros((0,))

    def evaluate(self, ds: SparseDataset,
                 batch_size: int = 8192) -> Dict[str, float]:
        from sparkfm_tpu.ops import metrics as MM
        p = self.predict_dataset(ds, batch_size)
        y = ds.y[:len(p)]
        if self.cfg.fm.task == Task.REGRESSION:
            return {"rmse": float(np.sqrt(np.mean(np.square(p - y)))),
                    "mae": float(np.mean(np.abs(p - y)))}
        eps = 1e-7
        pc = np.clip(p, eps, 1 - eps)
        y01 = (y > 0).astype(np.float64)
        return {
            "logloss": float(-np.mean(y01 * np.log(pc)
                                      + (1 - y01) * np.log1p(-pc))),
            "accuracy": float(np.mean((p >= 0.5) == (y01 > 0.5))),
            # AUC is rank-based: probabilities and raw scores give the
            # same ordering, so feeding probabilities is exact.
            "auc": float(MM.auc(jnp.asarray(p.astype(np.float32)),
                                jnp.asarray(y))),
        }

    def compute_rmse(self, ds: SparseDataset) -> float:
        p = self.predict_dataset(ds)
        return float(np.sqrt(np.mean(np.square(p - ds.y[:len(p)]))))

    def compute_mae(self, ds: SparseDataset) -> float:
        p = self.predict_dataset(ds)
        return float(np.mean(np.abs(p - ds.y[:len(p)])))

    def compute_accuracy(self, ds: SparseDataset) -> float:
        p = self.predict_dataset(ds)
        thr = 0.5 if self.cfg.fm.task == Task.CLASSIFICATION else 0.0
        return float(np.mean((p >= thr) == (ds.y[:len(p)] > 0)))

    def save(self, directory: str) -> None:
        from sparkfm_tpu.utils.checkpoint import Checkpointer
        with Checkpointer(directory, max_to_keep=1) as ck:
            ck.save(0, {"fm": self.params.fm,
                        "mlp_w": list(self.params.mlp_w),
                        "mlp_b": list(self.params.mlp_b)},
                    extra={"cfg": _cfg_to_json(self.cfg.fm),
                           "hidden": list(self.cfg.hidden),
                           "model": "deepfm"})

    @classmethod
    def load(cls, directory: str) -> "DeepFMModel":
        from sparkfm_tpu.models.deepfm import DeepFMConfig, DeepFMParams
        from sparkfm_tpu.utils.checkpoint import Checkpointer
        with Checkpointer(directory, max_to_keep=1) as ck:
            raw, extra = ck.restore()
        cfg = DeepFMConfig(fm=_cfg_from_json(extra["cfg"]),
                           hidden=tuple(extra["hidden"]))
        fm_raw = raw["fm"]
        if isinstance(fm_raw, dict):
            fm = FMParams(w0=jnp.asarray(fm_raw["w0"]),
                          w=jnp.asarray(fm_raw["w"]),
                          v=jnp.asarray(fm_raw["v"]))
        else:
            fm = fm_raw
        params = DeepFMParams(
            fm=fm,
            mlp_w=tuple(jnp.asarray(x) for x in raw["mlp_w"]),
            mlp_b=tuple(jnp.asarray(x) for x in raw["mlp_b"]))
        return cls(params=params, cfg=cfg)


def _parse_mesh(mesh, exchange: str = "auto"):
    """Accept None | Mesh | MeshConfig | "DxM" string.

    Returns a MeshConfig when one was given or an exchange preference must
    ride along (the trainer reads MeshConfig.exchange — converting to a
    raw Mesh here would silently drop it), else the Mesh as-is.
    """
    if mesh is None:
        return None
    from jax.sharding import Mesh as _Mesh

    from sparkfm_tpu.config import MeshConfig
    if isinstance(mesh, _Mesh):
        if exchange != "auto":
            raise ValueError(
                "exchange= with a raw jax Mesh is ambiguous — pass a "
                "MeshConfig(data, model, exchange=...) or a 'DxM' string")
        return mesh
    if isinstance(mesh, MeshConfig):
        if exchange != "auto" and mesh.exchange != exchange:
            mesh = dataclasses.replace(mesh, exchange=exchange)
        return mesh
    if isinstance(mesh, str):
        d, m = (int(x) for x in mesh.lower().split("x"))
        return MeshConfig(data=d, model=m, exchange=exchange)
    raise ValueError(f"mesh must be None, Mesh, MeshConfig or 'DxM' string; "
                     f"got {mesh!r}")


def _coordinate_mesh(mesh):
    """ALS/MCMC shard EXAMPLES over `data` with replicated params; an
    exchange pin has no meaning there — honor-or-reject."""
    from jax.sharding import Mesh as _Mesh

    from sparkfm_tpu.config import MeshConfig
    from sparkfm_tpu.parallel import mesh as _M
    if isinstance(mesh, MeshConfig):
        if mesh.exchange != "auto":
            raise ValueError(
                "exchange= applies to the sharded SGD/DeepFM paths; "
                "ALS/MCMC shard examples with replicated parameters "
                f"(got exchange={mesh.exchange!r})")
        return _M.mesh_from_config(mesh)
    assert isinstance(mesh, _Mesh)
    return mesh


def _als_mesh(cfg, als_cfg, train, eval_ds, eval_every, key, mesh):
    from sparkfm_tpu.parallel.sharded_als import train_als_sharded
    return train_als_sharded(cfg, als_cfg, train, _coordinate_mesh(mesh),
                             eval_ds, eval_every, key)


def _mcmc_mesh(cfg, mcmc_cfg, train, eval_ds, key, mesh):
    from sparkfm_tpu.parallel.sharded_als import train_mcmc_sharded
    return train_mcmc_sharded(cfg, mcmc_cfg, train,
                              _coordinate_mesh(mesh), eval_ds, key)


def _detect_slot_major(train, num_fields: int) -> bool:
    """True iff every example's slot l holds a field-l feature
    (field_ids == broadcast arange — the fixed-column hashed-CTR layout
    synth_ctr and the Avazu/Criteo loaders emit). A host-side one-pass
    check at fit time; when true the FFM interaction takes the static
    transpose form (ops/interaction.py::ffm_interaction_slot_major)
    with identical math (parity-tested incl. gradients)."""
    if num_fields <= 0:
        return False
    fids = getattr(train, "field_ids", None)
    if fids is None:
        return False
    fids = np.asarray(fids)
    if fids.ndim != 2 or fids.shape[1] != num_fields:
        return False
    return bool((fids == np.arange(num_fields,
                                   dtype=fids.dtype)[None, :]).all())


def _cfg_to_json(cfg: FMConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["task"] = cfg.task.value
    return d


def _cfg_from_json(d: dict) -> FMConfig:
    d = dict(d)
    d["task"] = Task(d["task"])
    return FMConfig(**d)


class FM:
    """Builder facade (reference FM.apply, FM.scala:25-33).

    Example::

        model = FM(num_factors=8, task=Task.REGRESSION, max_iter=20,
                   solver="als", reg_v=0.5).fit(train, eval_ds=test)
        rmse = model.compute_rmse(test)

    The reference's `learnWith(fml)` pluggable-solver slot maps to
    ``solver``: "sgd", "als", "mcmc" (the full libFM solver family — the
    reference ships only ALS), or any callable
    ``(cfg, train, eval_ds, eval_every, key) -> TrainResult``.
    """

    def __init__(self, num_factors: int = 8,
                 task: Task = Task.REGRESSION,
                 max_iter: int = 100,
                 solver: Union[str, Callable] = "als",
                 timeout: float = 0.0,
                 num_features: Optional[int] = None,
                 reg0: float = 0.0, reg_w: float = 0.0, reg_v: float = 10.0,
                 init_stdev: float = 0.01, init_mean: float = 0.0,
                 seed: int = 0,
                 learning_rate: float = 0.05, batch_size: int = 8192,
                 optimizer: str = "adagrad", num_fields: int = 0,
                 block_size: int = 4096,
                 eval_every: int = 1,
                 update_path: str = "auto",
                 steps_per_dispatch: int = 1,
                 mesh=None,
                 exchange: str = "auto",
                 model: str = "fm",
                 hidden: tuple = (128, 64),
                 feature_groups=None,
                 group_reg_w: Optional[tuple] = None,
                 group_reg_v: Optional[tuple] = None):
        self.num_factors = num_factors
        self.task = Task(task)   # accept 'regression'/'classification' strings
        self.max_iter = max_iter
        self.solver = solver
        # Wall-clock training budget in seconds; 0 = unlimited. The
        # reference accepts the same knob and drops it (FM.scala:30,
        # stored at impl/FactorizationMachines.scala:14, never read);
        # here it stops training at the next epoch/sweep boundary
        # (checkpoint-safe) — SGDConfig/ALSConfig/MCMCConfig.max_seconds.
        self.timeout = float(timeout)
        self.num_features = num_features
        self.reg0, self.reg_w, self.reg_v = reg0, reg_w, reg_v
        self.init_stdev = init_stdev
        self.init_mean = init_mean
        self.seed = seed
        self.learning_rate = learning_rate
        self.batch_size = batch_size
        self.optimizer = optimizer
        self.num_fields = num_fields
        self.block_size = block_size
        self.eval_every = eval_every
        # How SGD batch rows touch the parameter tables
        # (config.SGDConfig.update_path; auto picks hybrid/fused/dedup/
        # direct by table size and model).
        self.update_path = update_path
        # Hybrid path: scan this many staged batches per jitted dispatch
        # (SGDConfig.steps_per_dispatch; amortizes the launch cost).
        self.steps_per_dispatch = steps_per_dispatch
        # Device-mesh training (solver="sgd" only): a jax.sharding.Mesh, a
        # config.MeshConfig, or a "DATAxMODEL" string like "4x2". None =
        # single device. `exchange` pins the sharded sparse exchange
        # (MeshConfig.exchange: auto|unique|global|dense).
        self.mesh = _parse_mesh(mesh, exchange)
        # model: "fm" (default) or "deepfm" (FM heads + MLP tower; BASELINE
        # config 5). deepfm requires solver="sgd" and num_fields set (slots
        # per example). It honors the mesh: with one set, training runs the
        # sharded step (FM tables row-sharded over `model` with the
        # unique/global exchange, tower data-parallel over `data` —
        # parallel/sharded_deepfm.py); exchange pins apply (dense is
        # rejected: DeepFM table updates are per-unique-row).
        if model not in ("fm", "deepfm"):
            raise ValueError(f"unknown model {model!r}")
        self.model = model
        self.hidden = tuple(hidden)
        # Attribute-group regularization (reference Metadata.scala:8-29):
        # feature_groups is a per-feature group-id tuple, OR a fitted
        # Vectorizer — one group per source column, via
        # data.vectorizer.feature_groups_of. group_reg_w/group_reg_v are
        # per-group lambdas (len = num_groups); None broadcasts reg_w/reg_v.
        self.feature_groups = feature_groups
        self.group_reg_w = (None if group_reg_w is None
                            else tuple(float(x) for x in group_reg_w))
        self.group_reg_v = (None if group_reg_v is None
                            else tuple(float(x) for x in group_reg_v))

    def _resolved_groups(self) -> Optional[tuple]:
        fg = self.feature_groups
        if fg is None:
            return None
        if hasattr(fg, "offsets"):      # a fitted Vectorizer
            from sparkfm_tpu.data.vectorizer import feature_groups_of
            return feature_groups_of(fg)
        if isinstance(fg, str):
            raise ValueError(
                "feature_groups='auto' needs the fitted Vectorizer itself: "
                "FM(feature_groups=vec) (one group per source column)")
        return tuple(int(g) for g in fg)

    def _cfg(self, train: SparseDataset) -> FMConfig:
        groups = self._resolved_groups()
        num_features = self.num_features or train.num_features
        if groups is not None:
            if len(groups) > num_features and self.num_features is None:
                # groups carry the vectorizer's authoritative layout; a
                # libFM file infers dim from max active index, which is
                # short when trailing (e.g. OOV) features never fire
                num_features = len(groups)
            elif len(groups) != num_features:
                raise ValueError(
                    f"feature_groups length {len(groups)} != num_features "
                    f"{num_features} (was the Vectorizer fitted on this "
                    "data?)")
        return FMConfig(
            num_features=num_features,
            num_factors=self.num_factors, task=self.task,
            reg0=self.reg0, reg_w=self.reg_w, reg_v=self.reg_v,
            init_stdev=self.init_stdev, init_mean=self.init_mean,
            seed=self.seed, num_fields=self.num_fields,
            slot_major_fields=_detect_slot_major(train, self.num_fields),
            feature_groups=groups,
            group_reg_w=self.group_reg_w, group_reg_v=self.group_reg_v)

    def fit(self, train: SparseDataset,
            eval_ds: Optional[SparseDataset] = None,
            checkpoint_dir: Optional[str] = None,
            init_params=None) -> FMModel:
        """Fit on a SparseDataset OR a block-structure RelationalDataset.

        ``init_params`` warm-starts from an existing model (an FMParams
        or a fitted FMModel) instead of a fresh keyed init — the
        reference's ``FMLearn.learn(fm, data)`` signature takes the
        current model the same way (FMLearn.scala:12). Supported for
        solver sgd/als/mcmc on a single device.

        Relational input is the facade analog of the reference's
        `FM.withRelation(...)` (FM.scala:17): SGD trains directly on the
        non-materialized form (batch-time gather join); other solvers
        materialize first (the reference's 'Method 1').
        """
        from sparkfm_tpu.data.relational import RelationalDataset
        if init_params is not None:
            if isinstance(init_params, FMModel):
                init_params = init_params.params
            if self.model == "deepfm" or isinstance(train,
                                                    RelationalDataset):
                raise ValueError("init_params warm start supports plain "
                                 "FM on a SparseDataset")
        if self.mesh is not None and (self.solver not in ("sgd", "als",
                                                          "mcmc")
                                      or isinstance(train,
                                                    RelationalDataset)):
            raise ValueError("mesh training supports solver='sgd' (FM or "
                             "DeepFM), 'als' or 'mcmc' on a SparseDataset "
                             "(materialize relational data first)")
        if self.model == "deepfm":
            if self.solver != "sgd":
                raise ValueError("model='deepfm' requires solver='sgd'")
            if isinstance(train, RelationalDataset):
                train = train.materialize()
                if eval_ds is not None and hasattr(eval_ds, "materialize"):
                    eval_ds = eval_ds.materialize()
            from sparkfm_tpu.models import deepfm as _deepfm
            base = self._cfg(train)
            dcfg = _deepfm.DeepFMConfig(fm=base, hidden=self.hidden)
            sgd_cfg = SGDConfig(learning_rate=self.learning_rate,
                                optimizer=self.optimizer,
                                batch_size=self.batch_size,
                                epochs=self.max_iter,
                                max_seconds=self.timeout)
            res = _deepfm.train_deepfm(dcfg, sgd_cfg, train, eval_ds,
                                       self.eval_every,
                                       jax.random.PRNGKey(self.seed),
                                       mesh=self.mesh,
                                       checkpoint_dir=checkpoint_dir)
            return DeepFMModel(params=res.params, cfg=dcfg,
                               history=res.history,
                               examples_per_sec=res.examples_per_sec)
        if isinstance(train, RelationalDataset):
            cfg = self._cfg(train)
            key = jax.random.PRNGKey(self.seed)
            if self.solver == "sgd":
                sgd_cfg = SGDConfig(learning_rate=self.learning_rate,
                                    optimizer=self.optimizer,
                                    batch_size=self.batch_size,
                                    epochs=self.max_iter,
                                    update_path=self.update_path,
                                    max_seconds=self.timeout)
                res = _trainer.train_sgd_relational(
                    cfg, sgd_cfg, train, eval_ds, self.eval_every, key)
                return FMModel(params=res.params, cfg=cfg,
                               history=res.history,
                               examples_per_sec=res.examples_per_sec)
            if self.solver == "als":
                # BS-ALS: the reference's 'Method 2' (ALS.scala:77-136,
                # unreachable there) — no materialization (solvers/als_bs)
                from sparkfm_tpu.solvers import als_bs as _als_bs
                # feature_blocks=None -> slot-aligned blocks derived from
                # the BS structure (Jacobi == Gauss-Seidel; see
                # solvers/als_bs._prep)
                res = _als_bs.train_als_relational(
                    cfg, ALSConfig(epochs=self.max_iter,
                                   max_seconds=self.timeout),
                    train, eval_ds, self.eval_every, key)
                return FMModel(params=res.params, cfg=cfg,
                               history=res.history,
                               examples_per_sec=res.examples_per_sec)
            train = train.materialize()
            if eval_ds is not None and hasattr(eval_ds, "materialize"):
                eval_ds = eval_ds.materialize()
        cfg = self._cfg(train)
        key = jax.random.PRNGKey(self.seed)
        if callable(self.solver):
            res = self.solver(cfg, train, eval_ds, self.eval_every, key)
        elif self.solver == "sgd":
            sgd_cfg = SGDConfig(learning_rate=self.learning_rate,
                                optimizer=self.optimizer,
                                batch_size=self.batch_size,
                                epochs=self.max_iter,
                                update_path=self.update_path,
                                steps_per_dispatch=self.steps_per_dispatch,
                                max_seconds=self.timeout)
            res = _trainer.train_sgd(cfg, sgd_cfg, train, eval_ds,
                                     self.eval_every, key,
                                     checkpoint_dir=checkpoint_dir,
                                     mesh=self.mesh,
                                     init_params=init_params)
        elif self.solver == "als":
            from sparkfm_tpu.solvers.als import slot_blocks, train_als
            # Slot-aligned blocks: features sharing a CSR slot never
            # co-occur, so within-block Jacobi is exact Gauss-Seidel —
            # stable on coupled layouts where the old contiguous
            # arange//block heuristic diverged (e.g. materialized
            # relational data), and faster (max_nnz blocks per sweep).
            als_cfg = ALSConfig(epochs=self.max_iter,
                                feature_blocks=slot_blocks(train),
                                max_seconds=self.timeout)
            if self.mesh is not None:
                if init_params is not None:
                    raise ValueError("init_params warm start is "
                                     "single-device for now")
                res = _als_mesh(cfg, als_cfg, train, eval_ds,
                                self.eval_every, key, self.mesh)
            else:
                res = train_als(cfg, als_cfg, train, eval_ds,
                                self.eval_every, key, params=init_params)
        elif self.solver == "mcmc":
            from sparkfm_tpu.config import MCMCConfig
            from sparkfm_tpu.solvers.mcmc import train_mcmc
            from sparkfm_tpu.solvers.als import slot_blocks
            mcmc_cfg = MCMCConfig(epochs=self.max_iter,
                                  burn_in=max(1, self.max_iter // 10),
                                  feature_blocks=slot_blocks(train),
                                  max_seconds=self.timeout)
            if self.mesh is not None:
                if init_params is not None:
                    raise ValueError("init_params warm start is "
                                     "single-device for now")
                res = _mcmc_mesh(cfg, mcmc_cfg, train, eval_ds, key,
                                 self.mesh)
            else:
                res = train_mcmc(cfg, mcmc_cfg, train, eval_ds, key,
                                 params=init_params)
        else:
            raise ValueError(f"unknown solver {self.solver!r}")
        return FMModel(params=res.params, cfg=cfg, history=res.history,
                       examples_per_sec=res.examples_per_sec)
