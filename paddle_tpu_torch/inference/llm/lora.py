"""Multi-LoRA serving — packed per-tenant adapter pools.

Port of ``paddle_tpu/inference/llm/lora.py``.  ``LoRAConfig``,
``AdapterManager``, ``lora_key`` and ``LORA_TARGET_LEAVES`` are the JAX
module's, verbatim; ``init_adapter_pools`` allocates the pools with
torch.

One base model serves many tenants in a single mixed batch: every
request carries an ``adapter_id``, and the engine's step body gathers
a per-token adapter slot through the token->row map and adds
``(x @ A_g) @ B_g`` beside each of the four block GEMMs.  Nothing about
the step depends on WHICH adapters are resident — the pools are
ordinary params leaves and the slot indices an ordinary int32 operand —
so the one captured graph per token bucket stays the only one.

**Pool layout.**  Stacked block leaves ``lora.<key>.A`` ``[L, A, in,
r]`` and ``lora.<key>.B`` ``[L, A, r, out]`` (A adapter slots), with
per-layer views beside each layer's base weights.  Slot 0 is reserved
and stays all-zero forever: it is the EXACT base-model identity, so
requests with ``adapter_id=None`` — and padding and warmup rows — add
float zeros.

**Load/evict.**  :class:`AdapterManager` is pure host bookkeeping: an
LRU over the device pool slots.  The engine writes a slot in place
(``copy_`` into the pool tensors, on the engine's stream), so the
captured graphs, which read the pools by address, see the new adapter
at their next replay.
"""

# noqa-module: H001 (the manager is host bookkeeping by design — slot
# assignment, LRU ticks, and registration shapes are python state; the
# device-side delta lives in engine.py's step body)

import numpy as np

from .quant import QUANT_BLOCK_LEAVES

__all__ = [
    "LORA_TARGET_LEAVES", "LoRAConfig", "AdapterManager", "lora_key",
    "init_adapter_pools",
]

# the four block GEMMs are the targetable leaves — the same set the
# int8 weight path quantizes, because they are the O(hidden^2) matmuls
LORA_TARGET_LEAVES = QUANT_BLOCK_LEAVES


def lora_key(key, side):
    """Pool-leaf name for a target GEMM: ``lora.<key>.A`` / ``.B``."""
    return f"lora.{key}.{side}"


class LoRAConfig:
    """Resolved form of ``LLMEngine(lora=)``.

    Accepts ``None`` (off), an int (``max_adapters`` with default
    rank), a dict (keyword form), or another LoRAConfig.

    ``max_adapters`` counts device POOL SLOTS including the reserved
    all-zero base slot 0, so it must be >= 2 and the engine can hold at
    most ``max_adapters - 1`` distinct adapters resident at once (the
    scheduler's admission gate).  ``alpha`` defaults to ``rank`` (scale
    1.0); the ``alpha / rank`` scale is folded into the stored B half
    at registration so the jitted step never multiplies by it.
    ``tenant_quota`` bounds live same-adapter requests at admission —
    the per-tenant fairness knob on top of bounded admission/shed."""

    def __init__(self, rank=8, max_adapters=8,
                 targets=LORA_TARGET_LEAVES, alpha=None,
                 tenant_quota=None):
        self.rank = int(rank)
        if self.rank < 1:
            raise ValueError(f"lora rank must be >= 1, got {rank!r}")
        self.max_adapters = int(max_adapters)
        if self.max_adapters < 2:
            raise ValueError(
                f"lora max_adapters must be >= 2 (slot 0 is the "
                f"reserved base-model identity), got {max_adapters!r}")
        targets = tuple(targets)
        bad = [t for t in targets if t not in LORA_TARGET_LEAVES]
        if bad or not targets:
            raise ValueError(
                f"lora targets must be a non-empty subset of "
                f"{LORA_TARGET_LEAVES}, got {targets!r}")
        # canonical order (the base-leaf order), deduped
        self.targets = tuple(t for t in LORA_TARGET_LEAVES
                             if t in targets)
        self.alpha = float(alpha) if alpha is not None \
            else float(self.rank)
        self.tenant_quota = None if tenant_quota is None \
            else int(tenant_quota)
        if self.tenant_quota is not None and self.tenant_quota < 1:
            raise ValueError(
                f"lora tenant_quota must be >= 1 or None, "
                f"got {tenant_quota!r}")

    @property
    def scale(self):
        return self.alpha / self.rank

    @classmethod
    def resolve(cls, spec):
        if spec is None:
            return None
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, bool):
            raise TypeError(
                "lora= accepts None, an int (max_adapters), a dict, "
                "or a LoRAConfig; got a bool")
        if isinstance(spec, int):
            return cls(max_adapters=spec)
        if isinstance(spec, dict):
            return cls(**spec)
        raise TypeError(
            f"lora= accepts None, an int (max_adapters), a dict, or "
            f"a LoRAConfig; got {type(spec)}")

    def __repr__(self):
        return (f"LoRAConfig(rank={self.rank}, "
                f"max_adapters={self.max_adapters}, "
                f"targets={self.targets}, alpha={self.alpha}, "
                f"tenant_quota={self.tenant_quota})")


def init_adapter_pools(blocks, config, dtype, device=None):
    """Zero pool leaves for the stacked block params.

    Reads each target's [L, in, out] base-weight shape (shape-stable
    under int8 weight quantization — the int8 leaf keeps the float
    leaf's shape) and returns ``{lora.<key>.A: zeros[L, A, in, r],
    lora.<key>.B: zeros[L, A, r, out]}`` in ``dtype`` on ``device``
    (the base leaf's device by default).  All-zero pools make EVERY
    slot the base identity until an adapter is loaded into it.  The
    engine allocates them once and writes slots in place."""
    import torch

    out = {}
    for key in config.targets:
        L, d_in, d_out = blocks[key].shape
        dev = blocks[key].device if device is None else device
        out[lora_key(key, "A")] = torch.zeros(
            (L, config.max_adapters, d_in, config.rank), dtype=dtype,
            device=dev)
        out[lora_key(key, "B")] = torch.zeros(
            (L, config.max_adapters, config.rank, d_out), dtype=dtype,
            device=dev)
    return out


class AdapterManager:
    """Host-side adapter registry + LRU over the device pool slots.

    ``register`` validates and keeps a host copy of each adapter's
    stacked A/B halves (the ``alpha/rank`` scale folded into B);
    ``acquire`` maps an adapter_id to a resident slot, evicting the
    least-recently-used non-pinned resident when the pool is full.
    The manager never touches the device — the engine performs the
    actual slot write when ``acquire`` reports a load is needed —
    which is what keeps failover/restart cheap: re-registering the
    host copies fully reconstitutes a rebuilt replica."""

    _BASE = object()          # sentinel occupying reserved slot 0

    def __init__(self, config, shapes):
        self.config = config
        # target key -> (L, d_in, d_out) expected base-weight dims
        self._shapes = dict(shapes)
        self._adapters = {}   # adapter_id -> {key: (A f32, B f32)}
        self._slot_of = {}    # adapter_id -> resident slot
        self._slots = [None] * config.max_adapters
        self._slots[0] = self._BASE
        self._tick = 0        # LRU clock
        self._last_used = {}  # adapter_id -> tick
        self.stats = {"loads": 0, "evictions": 0, "hits": 0}

    # -- registry ------------------------------------------------------
    def known(self, adapter_id):
        return adapter_id in self._adapters

    def ids(self):
        return sorted(self._adapters, key=repr)

    def register(self, adapter_id, weights):
        """Validate and store one adapter's stacked halves.

        ``weights`` maps every configured target key to ``(A, B)``
        arrays of shape [L, in, r] / [L, r, out].  Stored as float32
        numpy host copies with the LoRA scale folded into B."""
        if adapter_id is None:
            raise ValueError(
                "adapter_id None is the implicit base model — it "
                "cannot be registered")
        try:
            hash(adapter_id)
        except TypeError:
            raise ValueError(
                f"adapter_id must be hashable, got "
                f"{type(adapter_id).__name__}")
        if adapter_id in self._adapters:
            raise ValueError(
                f"adapter {adapter_id!r} is already registered")
        missing = [k for k in self.config.targets if k not in weights]
        extra = [k for k in weights if k not in self.config.targets]
        if missing or extra:
            raise ValueError(
                f"adapter {adapter_id!r} must provide exactly the "
                f"configured targets {self.config.targets}; "
                f"missing={missing} extra={extra}")
        stored = {}
        r = self.config.rank
        for key in self.config.targets:
            L, d_in, d_out = self._shapes[key]
            a, b = weights[key]
            a = np.asarray(a, np.float32)
            b = np.asarray(b, np.float32)
            if a.shape != (L, d_in, r) or b.shape != (L, r, d_out):
                raise ValueError(
                    f"adapter {adapter_id!r} target {key!r}: expected "
                    f"A{(L, d_in, r)} / B{(L, r, d_out)}, got "
                    f"A{a.shape} / B{b.shape}")
            stored[key] = (a, b * np.float32(self.config.scale))
        self._adapters[adapter_id] = stored

    # -- residency -----------------------------------------------------
    def slot_of(self, adapter_id):
        """Resident slot for an adapter, or None (slot 0 for base)."""
        if adapter_id is None:
            return 0
        return self._slot_of.get(adapter_id)

    def resident(self):
        return dict(self._slot_of)

    def acquire(self, adapter_id, pinned=()):
        """Map an adapter_id to a resident slot.

        Returns ``(slot, weights)`` where ``weights`` is None when the
        adapter is already resident (LRU hit) and the host copy to
        write into the slot otherwise.  ``pinned`` adapters (the ones
        a launch is about to index) are never evicted; the scheduler's
        distinct-adapter admission gate guarantees the pinned set
        always fits, so a full pool always has an evictable victim."""
        if adapter_id is None:
            return 0, None
        if adapter_id not in self._adapters:
            raise ValueError(f"unknown adapter {adapter_id!r}")
        self._tick += 1
        slot = self._slot_of.get(adapter_id)
        if slot is not None:
            self._last_used[adapter_id] = self._tick
            self.stats["hits"] += 1
            return slot, None
        slot = next((s for s in range(1, self.config.max_adapters)
                     if self._slots[s] is None), None)
        if slot is None:
            pinned = set(pinned)
            victims = [aid for aid in self._slot_of
                       if aid not in pinned]
            if not victims:
                raise RuntimeError(
                    f"no evictable adapter slot: all "
                    f"{self.config.max_adapters - 1} slots are pinned "
                    f"by the current batch (the admission gate should "
                    f"make this unreachable)")
            victim = min(victims,
                         key=lambda aid: self._last_used.get(aid, 0))
            slot = self._slot_of.pop(victim)
            self._slots[slot] = None
            self.stats["evictions"] += 1
        self._slots[slot] = adapter_id
        self._slot_of[adapter_id] = slot
        self._last_used[adapter_id] = self._tick
        self.stats["loads"] += 1
        return slot, self._adapters[adapter_id]

    def lora_stats(self):
        return {**self.stats, "registered": len(self._adapters),
                "resident": len(self._slot_of),
                "slots": self.config.max_adapters}
