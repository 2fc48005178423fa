"""LLM serving: continuous batching over a paged KV cache.

- ``BlockManager`` — paged KV block allocator with prefix caching;
- ``Scheduler`` — admission + chunked prefill + preemption, deadlines
  and aborts;
- ``paged_ragged_attention`` — the ragged attention entry point (the
  CUDA kernel for CUDA tensors, the plain version for CPU tensors),
  ``paged_ragged_attention_quant``, its int8-pool twin, and the
  decode / verify / prefill forms over the same call;
- ``SpeculativeConfig``, ``NgramDrafter``, ``DraftModelDrafter`` —
  ``LLMEngine(speculative=)`` (``spec.py``);
- ``ServingQuantConfig`` — ``LLMEngine(quantize=)`` (``quant.py``), and
  ``quality.py``, the quality report of an approximate engine;
- ``apply_logits_pipeline`` and friends — the per-row sampling suite,
  plus host-side stop strings and logprobs;
- ``structured`` — grammar-constrained decoding through the pipeline's
  bias channel;
- ``faults`` — the request-lifecycle vocabulary (``FinishReason``) and
  deterministic fault injection (``FaultInjector``, ``RetryPolicy``,
  ``StepWatchdog``); ``events`` — the event-log record schema;
  ``interleave`` — the seeded interleaving scheduler for the async host;
- ``LLMEngine`` — add_request / step / generate over a GPT model, with
  abort, deadlines, bounded admission and step isolation, and
  ``AsyncLLMEngine`` for servers;
- ``HttpLLMServer`` — the HTTP/SSE front end over an engine.
"""

from .block_manager import (
    BlockManager,
    NoFreeBlocksError,
    hash_block_tokens,
    prefix_block_hashes,
)
from .engine import AsyncLLMEngine, LLMEngine, RequestOutput
from .events import (
    EVENT_FIELDS,
    SCHEMA_VERSION,
    assert_wall_clock_free,
    to_records,
)
from .faults import (
    Fault,
    FaultInjector,
    FinishReason,
    InjectedFault,
    MigrationError,
    PoolLostError,
    RetryPolicy,
    StepWatchdog,
)
from .http_server import HttpLLMServer
from .interleave import (
    InterleavingScheduler,
    interleave_point,
    interleave_wait,
)
from .paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
    paged_ragged_attention,
    paged_ragged_attention_plain,
    paged_ragged_attention_quant,
    paged_ragged_attention_quant_plain,
    paged_verify_attention,
    paged_verify_attention_plain,
    token_descriptors,
)
from .quant import ServingQuantConfig
from .sampling import (
    FILTERED,
    StopStringWatcher,
    apply_logits_pipeline,
    neutral_row_params,
    token_counts,
    top_logprobs,
    validate_sampling,
)
from .scheduler import (
    PrefillChunk,
    RaggedRow,
    Request,
    ScheduledBatch,
    Scheduler,
    bucket_size,
)
from .spec import (
    DraftModelDrafter,
    NgramDrafter,
    SpeculativeConfig,
    rollback_draft_reservation,
)
from .structured import (
    ConstraintState,
    DfaTokenGrammar,
    Grammar,
    grammar_from_spec,
    json_array_grammar,
)

__all__ = [
    "BlockManager", "NoFreeBlocksError", "hash_block_tokens",
    "prefix_block_hashes", "LLMEngine", "AsyncLLMEngine", "RequestOutput",
    "HttpLLMServer", "EVENT_FIELDS", "SCHEMA_VERSION",
    "assert_wall_clock_free", "to_records", "Fault", "FaultInjector",
    "FinishReason", "InjectedFault", "MigrationError", "PoolLostError",
    "RetryPolicy", "StepWatchdog", "InterleavingScheduler",
    "interleave_point", "interleave_wait", "paged_ragged_attention",
    "paged_ragged_attention_plain", "paged_ragged_attention_quant",
    "paged_ragged_attention_quant_plain", "paged_decode_attention",
    "paged_decode_attention_plain", "paged_verify_attention",
    "paged_verify_attention_plain", "paged_prefill_attention",
    "paged_prefill_attention_plain", "DraftModelDrafter", "NgramDrafter",
    "SpeculativeConfig", "rollback_draft_reservation", "ServingQuantConfig",
    "token_descriptors", "FILTERED", "StopStringWatcher",
    "apply_logits_pipeline", "neutral_row_params", "token_counts",
    "top_logprobs", "validate_sampling", "PrefillChunk", "RaggedRow",
    "Request", "ScheduledBatch", "Scheduler", "bucket_size",
    "ConstraintState", "DfaTokenGrammar", "Grammar", "grammar_from_spec",
    "json_array_grammar",
]
