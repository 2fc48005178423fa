"""Hierarchical KV cache: a host-RAM page tier under the HBM pool.

HBM is tier 0 and, historically, the only tier: a preempted sequence's
pages were freed and its whole chain re-prefilled, and a full page
evicted from the prefix cache was simply gone.  This module adds the
two memory tiers a production fleet actually has:

- :class:`HostPagePool` — a bounded host-RAM pool of DEMOTED page
  chains.  Preemption (and ``Fleet.drain_replica``) exports a running
  sequence's pages through the existing ``export_seq`` staging path
  into the pool; on re-admission the scheduler swaps the chain back in
  instead of re-prefilling it.  Swap-in bandwidth is usually far
  cheaper than replay FLOPs — :class:`TierPolicy` prices exactly that
  tradeoff per device profile and keeps preempt-recompute only where
  the cost model says it wins.
- :class:`PrefixStore` — a content-addressed host store of single FULL
  pages keyed by the adapter-salted prefix-chain hashes the HBM prefix
  cache already uses.  Pages evicted from a replica's cache promote
  into the store instead of vanishing, and any replica of a fleet can
  adopt them at admission — a tenant's system prompt prefills once per
  FLEET, not once per replica, and ``Router`` warm-affinity scoring
  reads global store content instead of per-replica accident.

Both tiers hold host numpy payloads gathered through the engine's
host-staged migration path (``_gather_pages`` / ``_scatter_pages`` —
no jit anywhere, so an armed CompileWatcher sees tier traffic as zero
compiles), both are LRU-bounded in BYTES, and both expose
``check_invariants()`` so the engine-level page conservation check
covers every tier.  int8 KV pools halve the page payload for free —
the tiers store whatever ``page_bytes`` the engine serves.
"""
# noqa-module: H001 (host-RAM tiers are host-side by design — the
# payloads exist precisely so they do NOT occupy device memory)

from collections import OrderedDict
from dataclasses import dataclass


@dataclass
class TierPolicy:
    """Swap-vs-recompute for one preempted sequence's page chain.

    ``mode``
        "auto" (default) compares framework/cost.py's
        ``migration_estimate`` — the chain's page bytes over the
        host-HBM link vs a fresh prefill of its ``num_cached`` tokens
        through the weights — and demotes/swaps only when the byte
        path is cheaper; "always" / "never" force the choice.
    ``profile``
        DEVICE_PROFILES key converting byte/FLOP counts to seconds
        (default "cpu" — what the serving stack runs on today).
    ``link_gbps``
        Host-to-HBM bandwidth in GB/s for the transfer term; None
        uses the profile's ICI rate (the same default the fleet's
        MigrationPolicy prices replica links with).

    Failure handling is NOT a knob: a demote or swap-in that faults
    always falls back to the pre-tier behavior (preempt-recompute),
    with both tiers exactly as before the attempt.
    """

    mode: str = "auto"
    profile: str = "cpu"
    link_gbps: float = None

    def __post_init__(self):
        if self.mode not in ("auto", "always", "never"):
            raise ValueError(
                f"mode must be 'auto'|'always'|'never', got "
                f"{self.mode!r}")
        from ...framework.cost import DEVICE_PROFILES
        if self.profile not in DEVICE_PROFILES:
            raise ValueError(
                f"unknown device profile {self.profile!r} "
                f"(one of {sorted(DEVICE_PROFILES)})")
        if self.link_gbps is not None and not float(self.link_gbps) > 0:
            raise ValueError(
                f"link_gbps must be > 0, got {self.link_gbps!r}")

    @classmethod
    def resolve(cls, policy):
        """Config sugar: None | mode str | dict | TierPolicy."""
        if policy is None:
            return cls()
        if isinstance(policy, cls):
            return policy
        if isinstance(policy, str):
            return cls(mode=policy)
        if isinstance(policy, dict):
            return cls(**policy)
        raise TypeError(
            f"policy= takes None/str/dict/TierPolicy, "
            f"got {type(policy).__name__}")

    def estimate(self, engine, num_tokens, num_pages):
        """The cost model's view of swapping ``num_pages`` pages
        holding ``num_tokens`` tokens' K/V (bytes moved, recompute
        FLOPs, seconds under the profile, which side it prefers)."""
        from ...framework.cost import migration_estimate
        return migration_estimate(
            engine, num_tokens=num_tokens, num_pages=num_pages,
            profile=self.profile,
            link_bytes_per_s=(None if self.link_gbps is None
                              else float(self.link_gbps) * 1e9))

    def decide(self, engine, num_tokens, num_pages):
        """"swap" or "recompute" for one page chain."""
        if self.mode != "auto":
            return "swap" if self.mode == "always" else "recompute"
        est = self.estimate(engine, num_tokens, num_pages)
        return "swap" if est["prefer"] == "migrate" else "recompute"


@dataclass
class KVTierConfig:
    """Engine/fleet kwarg resolving the hierarchical-KV knobs.

    ``host_bytes`` bounds the :class:`HostPagePool` (demoted chains),
    ``store_bytes`` the :class:`PrefixStore` (promoted full pages) —
    both in bytes of page payload.  Scalar sugar (``kv_tier=2**26`` or
    ``"64MiB"``) splits the budget evenly between the two tiers.
    ``policy`` is a :class:`TierPolicy` (or its mode-str/dict sugar).

    ``host_pool`` / ``store`` take PREBUILT tier instances — the
    fleet-sharing seam: ``Fleet`` builds one pool and one store, then
    hands every replica engine the same objects, which is what makes
    the prefix store fleet-wide.
    """

    host_bytes: int = 0
    store_bytes: int = 0
    policy: object = None
    host_pool: object = None
    store: object = None

    def __post_init__(self):
        from ...framework.cost import parse_bytes
        self.host_bytes = int(parse_bytes(self.host_bytes) or 0)
        self.store_bytes = int(parse_bytes(self.store_bytes) or 0)
        if self.host_bytes < 0 or self.store_bytes < 0:
            raise ValueError("tier budgets must be >= 0 bytes")
        self.policy = TierPolicy.resolve(self.policy)

    @classmethod
    def resolve(cls, kv_tier):
        """Engine-kwarg sugar: None | bytes int/str | dict |
        KVTierConfig.  A scalar budget splits evenly between the host
        pool and the prefix store."""
        if kv_tier is None:
            return None
        if isinstance(kv_tier, cls):
            return kv_tier
        if isinstance(kv_tier, bool):
            raise TypeError("kv_tier= takes None/bytes/dict/KVTierConfig")
        if isinstance(kv_tier, dict):
            return cls(**kv_tier)
        from ...framework.cost import parse_bytes
        if isinstance(kv_tier, (int, str)):
            total = parse_bytes(kv_tier)
            if total is None or total <= 0:
                raise ValueError(
                    f"kv_tier= needs a positive byte budget, "
                    f"got {kv_tier!r}")
            return cls(host_bytes=total // 2,
                       store_bytes=total - total // 2)
        raise TypeError(
            f"kv_tier= takes None/bytes/dict/KVTierConfig, "
            f"got {type(kv_tier).__name__}")

    def build(self):
        """Materialize the tier instances this config describes,
        reusing prebuilt ones (the fleet-sharing path) when given."""
        pool = self.host_pool
        if pool is None and self.host_bytes > 0:
            pool = HostPagePool(self.host_bytes)
        store = self.store
        if store is None and self.store_bytes > 0:
            store = PrefixStore(self.store_bytes)
        return pool, store


def _entry_nbytes(entry):
    """Byte footprint of one demoted chain's numpy payloads."""
    n = entry["k_pages"].nbytes + entry["v_pages"].nbytes
    if entry.get("k_scales") is not None:
        n += entry["k_scales"].nbytes + entry["v_scales"].nbytes
    return n


class HostPagePool:
    """Bounded host-RAM pool of demoted page chains, keyed by request
    id.  One entry is one sequence's whole exported chain: the
    BlockManager ``export_seq`` dict plus the host-gathered page (and,
    under int8 KV, scale) payloads.  LRU in bytes: inserting past the
    budget evicts the oldest chains, which :meth:`put` RETURNS so the
    caller can promote their full pages into the prefix store instead
    of dropping them.

    Pure host state.  Counters (``pages`` / ``nbytes`` and the
    cumulative demote/swap/eviction totals) are exact — see
    :meth:`check_invariants`.
    """

    def __init__(self, budget_bytes):
        budget_bytes = int(budget_bytes)
        if budget_bytes <= 0:
            raise ValueError(
                f"host pool budget must be > 0 bytes, got {budget_bytes}")
        self.budget_bytes = budget_bytes
        self._chains = OrderedDict()   # request_id -> entry, oldest first
        self.pages = 0
        self.nbytes = 0
        self.demoted_chains = 0
        self.swapped_in_chains = 0
        self.evicted_chains = 0

    def __contains__(self, request_id):
        return request_id in self._chains

    def __len__(self):
        return len(self._chains)

    def fits(self, nbytes):
        """Would a chain of ``nbytes`` fit the budget at all (possibly
        after evicting everything else)?"""
        return int(nbytes) <= self.budget_bytes

    def put(self, request_id, entry):
        """Insert one demoted chain; returns the entries LRU-evicted
        to make room (oldest first), for the caller to promote.  A
        chain larger than the whole budget is refused (ValueError) —
        callers gate on :meth:`fits` first."""
        if request_id in self._chains:
            raise ValueError(f"request {request_id!r} already demoted")
        nbytes = _entry_nbytes(entry)
        if nbytes > self.budget_bytes:
            raise ValueError(
                f"chain of {nbytes} bytes exceeds the host pool "
                f"budget {self.budget_bytes}")
        evicted = []
        while self.nbytes + nbytes > self.budget_bytes:
            _, old = self._chains.popitem(last=False)
            self.pages -= len(old["seq"]["block_ids"])
            self.nbytes -= _entry_nbytes(old)
            self.evicted_chains += 1
            evicted.append(old)
        self._chains[request_id] = entry
        self.pages += len(entry["seq"]["block_ids"])
        self.nbytes += nbytes
        self.demoted_chains += 1
        return evicted

    def get(self, request_id):
        """Peek a demoted chain (no removal; the swap-in path pops only
        after the payload landed and registered)."""
        return self._chains.get(request_id)

    def pop(self, request_id, *, swapped=False):
        """Remove one chain (swap-in success, abort, finish).  Returns
        the entry, or None when absent."""
        entry = self._chains.pop(request_id, None)
        if entry is not None:
            self.pages -= len(entry["seq"]["block_ids"])
            self.nbytes -= _entry_nbytes(entry)
            if swapped:
                self.swapped_in_chains += 1
        return entry

    def check_invariants(self):
        """Recompute the page/byte books from the entries and raise
        RuntimeError on any drift or budget overrun."""
        pages = sum(len(e["seq"]["block_ids"])
                    for e in self._chains.values())
        nbytes = sum(_entry_nbytes(e) for e in self._chains.values())
        if pages != self.pages or nbytes != self.nbytes:
            raise RuntimeError(
                f"host pool books don't balance: counted {pages} pages/"
                f"{nbytes} bytes, recorded {self.pages}/{self.nbytes}")
        if self.nbytes > self.budget_bytes:
            raise RuntimeError(
                f"host pool over budget: {self.nbytes} > "
                f"{self.budget_bytes} bytes")

    def stats(self):
        return {"chains": len(self._chains), "pages": self.pages,
                "nbytes": self.nbytes, "budget_bytes": self.budget_bytes,
                "demoted_chains": self.demoted_chains,
                "swapped_in_chains": self.swapped_in_chains,
                "evicted_chains": self.evicted_chains}


class PrefixStore:
    """Content-addressed host store of single FULL pages, keyed by the
    adapter-salted prefix-chain hashes the HBM prefix cache registers
    pages under.  One hashing authority (BlockManager) means a page
    promoted by any replica is adoptable by every replica — the store
    is what makes prefix caching FLEET-wide.  LRU in bytes; first
    writer wins (a hash already present is never overwritten — full
    pages are immutable by the prefix-cache contract).
    """

    def __init__(self, budget_bytes):
        budget_bytes = int(budget_bytes)
        if budget_bytes <= 0:
            raise ValueError(
                f"prefix store budget must be > 0 bytes, "
                f"got {budget_bytes}")
        self.budget_bytes = budget_bytes
        self._pages = OrderedDict()    # chain hash -> page entry
        self.nbytes = 0
        self.promoted_pages = 0
        self.adopted_pages = 0
        self.evicted_pages = 0

    def __contains__(self, block_hash):
        return block_hash in self._pages

    def __len__(self):
        return len(self._pages)

    def put(self, block_hash, entry):
        """Promote one full page (first writer wins).  Evicts LRU pages
        past the byte budget; a page larger than the whole budget is
        silently refused (nothing to do — the budget says no)."""
        if block_hash in self._pages:
            self._pages.move_to_end(block_hash)
            return
        nbytes = _entry_nbytes(entry)
        if nbytes > self.budget_bytes:
            return
        while self.nbytes + nbytes > self.budget_bytes:
            _, old = self._pages.popitem(last=False)
            self.nbytes -= _entry_nbytes(old)
            self.evicted_pages += 1
        self._pages[block_hash] = entry
        self.nbytes += nbytes
        self.promoted_pages += 1

    def get(self, block_hash):
        """Adopt one page's payload (LRU-touched; the page STAYS in the
        store — content-addressed pages are shared, not owned)."""
        entry = self._pages.get(block_hash)
        if entry is not None:
            self._pages.move_to_end(block_hash)
            self.adopted_pages += 1
        return entry

    def match(self, hashes):
        """Length of the longest leading run of ``hashes`` present —
        the store-side mirror of ``BlockManager.match_prefix``, read by
        scheduler admission and Router warm-affinity scoring."""
        k = 0
        for h in hashes:
            if h not in self._pages:
                break
            k += 1
        return k

    def check_invariants(self):
        """Recompute the byte book from the entries and raise
        RuntimeError on drift or budget overrun."""
        nbytes = sum(_entry_nbytes(e) for e in self._pages.values())
        if nbytes != self.nbytes:
            raise RuntimeError(
                f"prefix store books don't balance: counted {nbytes} "
                f"bytes, recorded {self.nbytes}")
        if self.nbytes > self.budget_bytes:
            raise RuntimeError(
                f"prefix store over budget: {self.nbytes} > "
                f"{self.budget_bytes} bytes")

    def stats(self):
        return {"pages": len(self._pages), "nbytes": self.nbytes,
                "budget_bytes": self.budget_bytes,
                "promoted_pages": self.promoted_pages,
                "adopted_pages": self.adopted_pages,
                "evicted_pages": self.evicted_pages}
