"""paddle_tpu_torch.parallel: the hybrid-parallel building blocks.

- pipeline.spmd_pipeline — pipeline parallelism over the ranks of a
  mesh's pp axis (point-to-point messages inside autograd functions)
- trainer.SpmdTrainStep — the hybrid dp×pp×mp(×sharding)(+sp) train step
"""

from .pipeline import spmd_pipeline  # noqa: F401
from .trainer import SpmdTrainStep  # noqa: F401
