"""Configuration tree for the FM framework.

Replaces the reference's hardcoded hyperparameters and mutable model fields
(reference: fm/FMModel.scala:10-31, fm/FM.scala:25-33, driver.scala:115) with a
single dataclass-based config. Every knob the reference exposes — num factors,
task, max iterations, regularization (reg0/regw/regv), init mean/stdev/seed —
is honored here — including `timeout` (SGDConfig/ALSConfig/MCMCConfig
.max_seconds; the reference's `seed`, `task` and `timeout` params are dead
code: FMModel.scala:14, impl/FactorizationMachines.scala:12-14).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Task(enum.Enum):
    """Learning task (reference: Task.scala:5).

    Unlike the reference — which stores the task but never branches on it —
    the task selects the loss head: squared loss for REGRESSION, logistic
    loss for CLASSIFICATION.
    """

    REGRESSION = "regression"
    CLASSIFICATION = "classification"


class Solver(enum.Enum):
    SGD = "sgd"
    ALS = "als"


@dataclasses.dataclass(frozen=True)
class FMConfig:
    """Model shape + initialization + regularization.

    Mirrors the knobs of the reference FMModel (FMModel.scala:10-31) but all
    of them are live and keyed:
      * ``use_bias`` / ``use_linear`` = the reference's hardcoded k0/k1
        (FMModel.scala:25-26), now configurable.
      * ``init_stdev``/``init_mean``/``seed`` are honored (the reference draws
        unseeded Gaussians: FMModel.scala:19-22).
      * ``reg0``/``reg_w``/``reg_v`` are per-group L2 strengths used by both
        solvers (reference defaults 0/0/10: FMModel.scala:29-31).
    """

    num_features: int
    num_factors: int = 8
    task: Task = Task.REGRESSION
    use_bias: bool = True           # k0
    use_linear: bool = True         # k1
    init_mean: float = 0.0
    init_stdev: float = 0.01
    seed: int = 0
    reg0: float = 0.0
    reg_w: float = 0.0
    reg_v: float = 10.0
    dtype: str = "float32"          # parameter dtype
    compute_dtype: str = "float32"  # dtype used inside the interaction kernel
    # Field-aware extension (FFM): number of fields. 0 = plain FM.
    num_fields: int = 0
    # FFM only: promise that slot l of EVERY example holds a feature of
    # field l (so L == num_fields and field_ids == arange — the fixed-
    # column hashed-CTR layout Avazu/Criteo loaders emit). A STATIC bit:
    # the interaction drops its one-hot field-aggregation matmuls for a
    # transpose multiply (ops/interaction.py::ffm_interaction_slot_major)
    # and batches may omit
    # field_ids entirely. Leave False for ragged/multi-hot field layouts.
    slot_major_fields: bool = False
    # Attribute groups (the reference's Metadata capability,
    # fm/bs/Metadata.scala:8-29; libFM's per-group lambdas): a per-feature
    # group id tuple of length num_features. With groups set:
    #   * SGD/ALS use per-group L2 strengths group_reg_w / group_reg_v
    #     (tuples of length num_groups) in place of the scalar reg_w/reg_v;
    #   * MCMC samples per-group (lambda, mu) hyperpriors per factor column
    #     (solvers/mcmc.py) instead of one shared pair.
    # Build from a fitted vectorizer with
    # data.vectorizer.feature_groups_of (one group per source column).
    feature_groups: Optional[tuple] = None
    group_reg_w: Optional[tuple] = None
    group_reg_v: Optional[tuple] = None

    def replace(self, **kw) -> "FMConfig":
        return dataclasses.replace(self, **kw)

    @property
    def num_groups(self) -> int:
        if self.feature_groups is None:
            return 1
        return int(max(self.feature_groups)) + 1

    def reg_vectors(self):
        """(reg_w_vec, reg_v_vec): per-feature L2 strengths as numpy (F,)
        f32 arrays — per-group values spread to features when groups are
        configured, else the scalars broadcast."""
        import numpy as _np
        if self.feature_groups is None:
            return (_np.full((self.num_features,), self.reg_w, _np.float32),
                    _np.full((self.num_features,), self.reg_v, _np.float32))
        groups = _np.asarray(self.feature_groups, _np.int64)
        if groups.shape != (self.num_features,):
            raise ValueError(
                f"feature_groups must have length num_features="
                f"{self.num_features}, got {groups.shape}")
        gw = (_np.asarray(self.group_reg_w, _np.float32)
              if self.group_reg_w is not None
              else _np.full((self.num_groups,), self.reg_w, _np.float32))
        gv = (_np.asarray(self.group_reg_v, _np.float32)
              if self.group_reg_v is not None
              else _np.full((self.num_groups,), self.reg_v, _np.float32))
        for name, arr in (("group_reg_w", gw), ("group_reg_v", gv)):
            if arr.shape != (self.num_groups,):
                raise ValueError(
                    f"{name} must have length num_groups={self.num_groups}"
                    f" (= max(feature_groups)+1), got {arr.shape}")
        return gw[groups], gv[groups]


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    learning_rate: float = 0.05
    # Wall-clock training budget in seconds; 0 = unlimited. Checked at
    # epoch boundaries: the epoch in flight completes, a final
    # checkpoint is written (when checkpointing is on), and the loop
    # stops. Honors the reference's `timeout` knob (FM.scala:30, stored
    # at impl/FactorizationMachines.scala:14 but never read there).
    max_seconds: float = 0.0
    optimizer: str = "adagrad"      # adagrad | sgd | adam
    batch_size: int = 8192
    epochs: int = 10
    momentum: float = 0.0
    adagrad_eps: float = 1e-8
    # If True use the sparse gather/scatter update path (only touches rows
    # active in the batch); if False, dense optax-style updates.
    sparse_updates: bool = True
    shuffle_each_epoch: bool = True
    # How batch rows touch the parameter tables:
    #   "direct" — XLA gather/scatter straight on the (F, K) tables.
    #   "dedup"  — sort + unique-compact the batch ids first; the big table
    #              is touched once per *unique* id and all per-slot math runs
    #              against a small (U, K) matrix (ops/embedding.py). The
    #              only path offering adam/momentum.
    #   "fused"  — dedup plus the fused record layout [v|slot_v|w|slot_w]
    #              in one row (solvers/sgd_fused.py): ONE sorted-hint
    #              unique-row gather + ONE write-back per step. adagrad /
    #              adagrad_row / plain sgd. Covers FFM too (v block widens
    #              to num_fields*K).
    #   "sorted" — slots re-sorted by feature id once per batch; per-unique
    #              reductions become segment sums over sorted runs
    #              (solvers/sgd_sorted.py).
    #   "hybrid" — natural-order forward + ANALYTIC id-sorted backward
    #              (solvers/sgd_hybrid.py): gradients are evaluated
    #              directly in sorted slot order from the closed-form FM
    #              gradient and reduced over sorted runs, so the
    #              per-slot scatter-add/permute of "fused" disappears.
    #              Restrictions: requires host plans carrying
    #              order/seg/svals/sex (batch_iterator(dedup_budget=...)
    #              emits them), plain FM only, float32 only,
    #              adagrad/adagrad_row/sgd, no momentum, no
    #              attribute-group regularization.
    #   "auto"   — direct below 2^16 features; above: hybrid when host
    #              plans + the model/optimizer fit its restrictions,
    #              else fused, else dedup
    #              (solvers/sgd.py::resolve_update_path).
    update_path: str = "auto"
    # Static unique-id budget U for the dedup-plan paths. 0 = auto:
    # host-plan paths use the budget LADDER (each batch's plan is sized to
    # its actual unique count rounded up to a coarse rung — overflow
    # impossible, unique-row costs tight; see ops.embedding.ladder_budget);
    # device-plan paths use the next power of two >= batch nnz slots
    # (no overflow possible), capped at 2^18. A positive value pins one
    # static budget (required for the sharded paths).
    unique_budget: int = 0
    # Compute the dedup plan on the HOST in the input pipeline (overlapped
    # with device compute via data.batching.prefetch) instead of sorting
    # on device inside the step.
    host_plan: bool = True
    # How per-slot gradients reduce to per-unique-row gradients in the
    # dedup/fused paths:
    #   "scatter" — XLA scatter-add by rank.
    #   "segsum"  — permute slots into id-sorted order (the plan carries
    #               the permutation) + segment sum over sorted runs.
    #   "auto"    — scatter.
    accumulate: str = "auto"
    # Hybrid path only: scan this many staged batches per jitted dispatch
    # (solvers/sgd_hybrid.py::make_hybrid_multi_step). Each dispatch pays
    # a fixed launch/donation cost; grouping amortizes it. The update
    # sequence is EXACTLY the single-step one (lax.scan is sequential);
    # batches whose ladder plans land on different rungs are stepped
    # singly (shape mismatch), so rung growth mid-epoch degrades
    # gracefully.
    steps_per_dispatch: int = 1


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    """Blocked coordinate-descent (Rendle ALS) config.

    The reference's ALS (fm/lib/ALS.scala:15-75) is strictly sequential
    Gauss-Seidel on the driver. This formulation processes features in
    blocks: Jacobi within a block, exact Gauss-Seidel across blocks (residual
    and q-cache are patched *exactly* after every block — see
    solvers/als.py). ``block_size`` trades parallelism against staleness; if
    features are grouped by field (one-hot columns never co-occur in an
    example), within-field Jacobi is exactly Gauss-Seidel.
    """

    epochs: int = 10
    block_size: int = 4096
    # Wall-clock budget in seconds, checked between sweeps; 0 =
    # unlimited (the reference's dead `timeout` knob, FM.scala:30).
    max_seconds: float = 0.0
    # Optional explicit feature->block assignment (e.g. by field); if None,
    # contiguous blocks of block_size are used.
    feature_blocks: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class MCMCConfig:
    """Gibbs-sampled Bayesian FM (libFM's MCMC solver; Rendle 2012).

    Same blocked-sweep machinery as ALS, but every coordinate draw samples
    from its conditional posterior N(theta*, 1/(alpha*den + lambda)) and
    the regularization hyperparameters (per-group lambda, mu and the noise
    precision alpha) are themselves Gibbs-sampled — no learning rate and
    no reg tuning, the classic reason to use FM-MCMC. The reference ships
    only ALS (SURVEY §2.3); this restores the missing member of the libFM
    solver family. Predictions are averaged over post-burn-in samples
    (libFM semantics: test scores accumulate during training).
    """

    epochs: int = 50
    burn_in: int = 5
    block_size: int = 4096
    feature_blocks: Optional[tuple] = None
    # Wall-clock budget in seconds, checked between samples; 0 =
    # unlimited (the reference's dead `timeout` knob, FM.scala:30).
    max_seconds: float = 0.0
    # Gamma hyperpriors (libFM defaults: alpha_0 = beta_0 = 1, etc.)
    alpha_0: float = 1.0
    beta_0: float = 1.0
    alpha_lambda: float = 1.0
    beta_lambda: float = 1.0
    # Gaussian hyperprior on group means: mu ~ N(mu_0, 1/(gamma_0*lambda))
    mu_0: float = 0.0
    gamma_0: float = 1.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: (data, model) axes.

    data  — batch dimension (examples), the reference's only parallel axis
            (RDD partitions; SURVEY §2.7).
    model — feature dimension of the V/w tables (row sharding), the axis the
            reference lacked (whole model lived on the driver heap:
            FMModel.scala:18-19).
    """

    data: int = 1
    model: int = 1
    data_axis: str = "data"
    model_axis: str = "model"
    # Sparse gradient exchange for the sharded SGD step
    # (parallel/sharded_sgd.py): "auto" lets the trainer choose (global
    # when host plans are on — backward comm independent of the data-axis
    # size — else unique/dense by optimizer); "unique" | "global" |
    # "dense" pin a strategy.
    exchange: str = "auto"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    fm: FMConfig = None
    sgd: SGDConfig = dataclasses.field(default_factory=SGDConfig)
    als: ALSConfig = dataclasses.field(default_factory=ALSConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    solver: Solver = Solver.SGD
    eval_every: int = 1             # epochs between evals (reference evals every
                                    # epoch unconditionally: FactorizationMachines.scala:43)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0       # steps; 0 = only at end
    log_every: int = 100            # steps
