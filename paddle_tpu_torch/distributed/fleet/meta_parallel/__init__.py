"""meta_parallel: TP/PP wrappers and sequence/context parallelism
(reference python/paddle/distributed/fleet/meta_parallel/); port of the
JAX package's ``meta_parallel``."""

from . import mp_layers  # noqa: F401
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from .tensor_parallel import TensorParallel  # noqa: F401
from .pipeline_parallel import (  # noqa: F401
    LayerDesc,
    PipelineLayer,
    PipelineParallel,
    SharedLayerDesc,
)
from .sequence_parallel import (  # noqa: F401
    context_parallel_attention,
    mark_replicated,
    mark_sequence_sharded,
    ring_attention,
    ulysses_attention,
)
