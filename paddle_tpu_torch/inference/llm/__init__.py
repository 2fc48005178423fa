"""LLM serving: continuous batching over a paged KV cache.

- ``BlockManager`` — paged KV block allocator with prefix caching;
- ``Scheduler`` — admission + chunked prefill + preemption;
- ``paged_ragged_attention`` — the ragged attention entry point (the
  CUDA kernel for CUDA tensors, the plain version for CPU tensors);
- ``apply_logits_pipeline`` and friends — the per-row sampling suite;
- ``LLMEngine`` — add_request / step / generate over a GPT model.
"""

from .block_manager import BlockManager, NoFreeBlocksError
from .engine import LLMEngine, RequestOutput
from .faults import FinishReason
from .paged_attention import (
    paged_ragged_attention,
    paged_ragged_attention_plain,
    token_descriptors,
)
from .sampling import (
    FILTERED,
    apply_logits_pipeline,
    neutral_row_params,
    token_counts,
    validate_sampling,
)
from .scheduler import RaggedRow, Request, Scheduler, bucket_size

__all__ = [
    "BlockManager", "NoFreeBlocksError", "LLMEngine", "RequestOutput",
    "FinishReason", "paged_ragged_attention",
    "paged_ragged_attention_plain", "token_descriptors", "FILTERED",
    "apply_logits_pipeline", "neutral_row_params", "token_counts",
    "validate_sampling", "RaggedRow", "Request", "Scheduler",
    "bucket_size",
]
