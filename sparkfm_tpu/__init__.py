"""sparkfm_tpu — a JAX factorization-machine framework.

Brand-new JAX/XLA/Pallas/pjit implementation of the capabilities of the
reference SparkFM (edmundhung/SparkFM, studied in SURVEY.md): second-order FM
with the full libFM solver family (SGD / ALS / MCMC), regression + logistic
classification heads, libFM I/O, schema-driven (incl. relational)
vectorization, metrics, sharded training over a (data, model) device mesh,
and checkpointing.
"""

from sparkfm_tpu.api import FM, FMModel
from sparkfm_tpu.config import (ALSConfig, FMConfig, MCMCConfig, MeshConfig,
                                SGDConfig, Solver, Task, TrainConfig)
from sparkfm_tpu.models.fm import FMParams, init_params, predict, scores
from sparkfm_tpu.serving import MicroBatcher

__all__ = [
    "FM", "FMModel",
    "ALSConfig", "FMConfig", "MCMCConfig", "MeshConfig", "SGDConfig",
    "Solver", "Task", "TrainConfig", "FMParams", "init_params", "predict",
    "scores", "MicroBatcher",
]

__version__ = "0.1.0"
