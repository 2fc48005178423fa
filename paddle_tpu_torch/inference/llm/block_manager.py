"""Paged KV-cache block allocator with automatic prefix caching.

The serving cache is one pool of ``num_blocks`` fixed-size token pages
(vLLM's PagedAttention allocator shape; on TPU the pool is a dense
[num_blocks, block_size, ...] array so pages are also the DMA unit of the
Pallas kernel).  Sequences own pages through per-sequence block tables;
a free list recycles pages the moment a sequence finishes or is
preempted, and ``fork`` shares pages copy-on-write for beam/parallel
sampling.

Prefix caching makes FULL pages content-addressable: a full page is
identified by the prefix-chain hash of every token id up to and
including the page (``hash_block_tokens``), so two requests whose
prompts share a leading run of pages map the SAME physical pages and
skip recomputing their K/V.  Pages whose refcount drops to zero but
whose contents are still hash-addressable park on an LRU side list
instead of the raw free list — they count as free (allocation evicts
the oldest when the raw list runs dry) but stay adoptable until then.
Only full pages are ever hashed, and full pages are immutable (decode
appends only write partially-filled tail pages, copy-on-write copies
partial tails), so an adopted page can never be clobbered by its other
owners.

Pure host-side bookkeeping — nothing here touches device memory.  The
engine mirrors each table into the [B, P] int32 operand the kernels
gather through.
"""
# noqa-module: H001 (pure host bookkeeping by design — page refcounts,
# free lists and content-hash maps never touch device memory; the pool
# arrays live in the engine, this module only hands out indices)

from collections import OrderedDict


class NoFreeBlocksError(RuntimeError):
    """The pool is exhausted; callers preempt or queue."""


def hash_block_tokens(prev_hash, tokens):
    """Chain hash of one full page: folds the hash of everything before
    the page with the page's own token ids, so equal hashes mean equal
    full prefixes (int tuple hashing is process-stable, unlike str)."""
    return hash((prev_hash, tuple(int(t) for t in tokens)))


def prefix_block_hashes(token_ids, block_size, limit=None, salt=None):
    """Chain hashes for every FULL page of ``token_ids`` (ragged tail
    excluded).  ``limit`` caps the number of pages hashed.

    ``salt`` seeds the chain: pages are only shareable between
    sequences hashed under the SAME salt.  Multi-LoRA serving salts
    with the request's adapter_id — a qkv-target adapter makes the K/V
    contents adapter-dependent, so two tenants sharing a token prefix
    must NOT share cached pages.  ``salt=None`` (the base model) keeps
    the historical hash values exactly."""
    n_full = len(token_ids) // block_size
    if limit is not None:
        n_full = min(n_full, limit)
    hashes, h = [], None if salt is None else ("lora", salt)
    for i in range(n_full):
        h = hash_block_tokens(h, token_ids[i * block_size:
                                           (i + 1) * block_size])
        hashes.append(h)
    return hashes


class BlockManager:
    def __init__(self, num_blocks, block_size, enable_prefix_caching=False):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.enable_prefix_caching = bool(enable_prefix_caching)
        # fault injection (faults.FaultInjector): when attached, the
        # public reservation entry points consult it FIRST and raise a
        # genuine NoFreeBlocksError before mutating anything — a forced
        # OOM at step N exercises the same preempt/recompute path a
        # real exhausted pool does, with zero special-casing downstream
        self.fault_hook = None
        # hierarchical KV (kv_tier.py): when attached, _take's LRU
        # eviction calls evict_hook(block_id, chain_hash) BEFORE the
        # hash is discarded, so the engine can promote the still-valid
        # full page into the fleet-wide prefix store instead of
        # dropping the prefill work it holds
        self.evict_hook = None
        # pop() takes from the tail: keep it sorted descending so pages
        # are handed out in ascending id order (stable tests/traces)
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._ref = {}          # block id -> refcount
        self._tables = {}       # seq id -> [block ids]
        self._tokens = {}       # seq id -> tokens occupying those blocks
        # prefix cache state: full pages only
        self._hash_to_block = {}        # chain hash -> block id
        self._block_hash = {}           # block id -> chain hash
        self._lru = OrderedDict()       # cached + refcount 0, oldest first
        self.prefix_reused_blocks = 0
        self.prefix_evictions = 0

    # ------------------------------------------------------------ queries --
    @property
    def num_free_blocks(self):
        """Pages allocatable right now: the raw free list plus cached
        pages nobody references (evictable on demand)."""
        return len(self._free) + len(self._lru)

    @property
    def num_cached_blocks(self):
        """Hash-addressable full pages currently resident (referenced
        or parked on the LRU list)."""
        return len(self._hash_to_block)

    def blocks_needed(self, num_tokens):
        return -(-int(num_tokens) // self.block_size)

    def can_allocate(self, num_tokens, margin=0, cached_hashes=()):
        """Would ``allocate`` succeed, adopting ``cached_hashes`` pages
        from the prefix cache?  Adopted pages parked on the LRU list
        leave the free pool when claimed, so they count against it."""
        in_lru = sum(1 for h in cached_hashes
                     if self._hash_to_block.get(h) in self._lru)
        fresh = self.blocks_needed(num_tokens) - len(cached_hashes)
        return fresh + margin <= len(self._free) + len(self._lru) - in_lru

    def block_table(self, seq_id):
        return list(self._tables[seq_id])

    def num_tokens(self, seq_id):
        return self._tokens[seq_id]

    def has_seq(self, seq_id):
        return seq_id in self._tables

    def check_invariants(self):
        """Raise RuntimeError unless the page accounting balances.

        Checked: free / LRU-parked / referenced pages are disjoint and
        sum to ``num_blocks``; every refcount equals the number of block
        tables holding the page; the hash maps are mutually inverse and
        every LRU page is hashed.  The allocator is pure host state —
        under tensor parallelism one instance drives every shard, so a
        balanced book here certifies page traffic was shard-invariant.
        """
        free, lru, ref = set(self._free), set(self._lru), set(self._ref)
        if len(free) != len(self._free):
            raise RuntimeError("duplicate pages on the free list")
        for a, b, what in ((free, lru, "free/LRU"), (free, ref, "free/ref"),
                           (lru, ref, "LRU/ref")):
            if a & b:
                raise RuntimeError(f"pages {sorted(a & b)} on {what} lists")
        if lru - set(self._block_hash):
            raise RuntimeError("unhashed pages parked on the LRU list")
        if len(free) + len(lru) + len(ref) != self.num_blocks:
            raise RuntimeError(
                f"page books don't balance: {len(free)} free + {len(lru)} "
                f"cached + {len(ref)} referenced != {self.num_blocks}")
        counts = {}
        for table in self._tables.values():
            for blk in table:
                counts[blk] = counts.get(blk, 0) + 1
        if counts != self._ref:
            raise RuntimeError(
                f"refcounts {self._ref} disagree with table ownership "
                f"{counts}")
        for h, blk in self._hash_to_block.items():
            if self._block_hash.get(blk) != h:
                raise RuntimeError(
                    f"hash maps not inverse at block {blk}")
        if len(self._block_hash) != len(self._hash_to_block):
            raise RuntimeError("hash maps differ in size")

    # ------------------------------------------------------- prefix cache --
    def prefix_chain_hashes(self, token_ids, limit=None, salt=None):
        """Chain hashes of ``token_ids``'s full pages at THIS pool's
        page size — the public spelling of the content-hash scheme the
        cache registers pages under.  The fleet router keys prefix
        affinity on these, so router keys and cache registrations hash
        identically by construction (one authority, one page size);
        ``limit`` caps the number of pages hashed, mirroring the
        scheduler's admission cap of ``(n - 1) // block_size``.
        ``salt`` namespaces the chain per adapter (see
        :func:`prefix_block_hashes`)."""
        return prefix_block_hashes(token_ids, self.block_size,
                                   limit=limit, salt=salt)

    def match_prefix(self, hashes):
        """Length of the longest leading run of ``hashes`` whose pages
        are still resident (referenced or LRU-parked)."""
        if not self.enable_prefix_caching:
            return 0
        k = 0
        for h in hashes:
            if h not in self._hash_to_block:
                break
            k += 1
        return k

    def _adopt(self, block_hash):
        """Take a reference on the cached page for ``block_hash``."""
        blk = self._hash_to_block[block_hash]
        if blk in self._lru:
            del self._lru[blk]
            self._ref[blk] = 1
        else:
            self._ref[blk] += 1
        self.prefix_reused_blocks += 1
        return blk

    def register_full_block(self, seq_id, block_index, block_hash):
        """Make a just-computed FULL page hash-addressable.  First
        writer wins; a page that already carries a hash (it was adopted
        from the cache in the first place) is left alone."""
        if not self.enable_prefix_caching:
            return
        blk = self._tables[seq_id][block_index]
        if blk in self._block_hash or block_hash in self._hash_to_block:
            return
        self._hash_to_block[block_hash] = blk
        self._block_hash[blk] = block_hash

    # ---------------------------------------------------------- lifecycle --
    def _take(self):
        if self._free:
            blk = self._free.pop()
        elif self._lru:
            # evict the least-recently-freed cached page
            blk, _ = self._lru.popitem(last=False)
            h = self._block_hash.pop(blk)
            del self._hash_to_block[h]
            self.prefix_evictions += 1
            if self.evict_hook is not None:
                # the page's contents are still valid HERE (nothing
                # reused the block yet) — last chance to promote them
                self.evict_hook(blk, h)
        else:
            raise NoFreeBlocksError("KV cache pool exhausted")
        self._ref[blk] = 1
        return blk

    def allocate(self, seq_id, num_tokens, cached_hashes=()):
        """Allocate pages for a sequence's first ``num_tokens`` tokens;
        the leading ``cached_hashes`` pages are adopted from the prefix
        cache (zero compute), the rest come fresh.  Returns the block
        table."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        if self.fault_hook is not None and self.fault_hook.alloc("allocate"):
            err = NoFreeBlocksError("injected OOM (fault schedule)")
            err.injected = True
            raise err
        need = self.blocks_needed(num_tokens)
        if len(cached_hashes) > need:
            raise ValueError("more cached pages than the sequence needs")
        in_lru = sum(1 for h in cached_hashes
                     if self._hash_to_block.get(h) in self._lru)
        fresh = need - len(cached_hashes)
        if fresh > len(self._free) + len(self._lru) - in_lru:
            raise NoFreeBlocksError(
                f"need {fresh} fresh blocks, "
                f"{len(self._free) + len(self._lru) - in_lru} free")
        # adopt FIRST so _take's eviction can never claim a matched page
        table = [self._adopt(h) for h in cached_hashes]
        table += [self._take() for _ in range(fresh)]
        self._tables[seq_id] = table
        self._tokens[seq_id] = int(num_tokens)
        return list(table)

    def would_cow(self, seq_id):
        """Would ``append_slot`` copy-on-write the shared partial tail
        page?  The lookahead stager refuses such sequences: a COW
        append rewires the table and drops a reference, which
        ``rollback_slots`` cannot invert — the sync scheduler must own
        that append so the in-kernel page copy is actually issued."""
        table = self._tables[seq_id]
        tokens = self._tokens[seq_id]
        return bool(table) and tokens % self.block_size != 0 \
            and self._ref[table[-1]] > 1

    def can_append(self, seq_id):
        """Would ``append_slot`` succeed without raising?"""
        table = self._tables[seq_id]
        tokens = self._tokens[seq_id]
        if tokens == len(table) * self.block_size:
            return self.num_free_blocks >= 1     # page boundary: new page
        if table and self._ref[table[-1]] > 1:
            return self.num_free_blocks >= 1     # copy-on-write copy
        return True

    def append_slot(self, seq_id):
        """Reserve the slot for the sequence's next token.

        Returns (slot, cow): ``slot`` is the absolute token slot
        (block_id * block_size + offset) the engine writes K/V into;
        ``cow`` is None, or ``(src_block, dst_block)`` when a shared last
        page had to be copied first (the engine copies page contents).
        Raises NoFreeBlocksError when a page is needed and none is free —
        the scheduler's preemption trigger.
        """
        if self.fault_hook is not None and \
                self.fault_hook.alloc("append_slot"):
            err = NoFreeBlocksError("injected OOM (fault schedule)")
            err.injected = True
            raise err
        table = self._tables[seq_id]
        tokens = self._tokens[seq_id]
        offset = tokens % self.block_size
        cow = None
        if offset == 0 and tokens == len(table) * self.block_size:
            table.append(self._take())           # page boundary: new page
        elif self._ref[table[-1]] > 1:           # shared tail: copy-on-write
            src = table[-1]
            dst = self._take()
            self._ref[src] -= 1                  # cow fires at ref > 1
            table[-1] = dst
            cow = (src, dst)
        self._tokens[seq_id] = tokens + 1
        return table[-1] * self.block_size + offset, cow

    def append_slots(self, seq_id, n):
        """Reserve the next ``n`` token slots in one atomic call (the
        speculative verify step claims 1 + K slots up front: one for
        the committed token, K for the drafts).

        Returns (slots, cows): ``slots`` are the absolute token slots in
        append order, ``cows`` the ``(src, dst)`` copy-on-write pairs (at
        most one — only a shared partial tail ever copies).  Raises
        NoFreeBlocksError with NO state mutated when the pages don't fit,
        so the scheduler can retry with fewer drafts before preempting.
        Unaccepted slots are returned via :meth:`rollback_slots`.
        """
        n = int(n)
        if n < 1:
            raise ValueError(f"append_slots needs n >= 1, got {n}")
        if self.fault_hook is not None and \
                self.fault_hook.alloc("append_slots"):
            err = NoFreeBlocksError("injected OOM (fault schedule)")
            err.injected = True
            raise err
        table = self._tables[seq_id]
        tokens = self._tokens[seq_id]
        new_pages = self.blocks_needed(tokens + n) - len(table)
        # the tail page takes writes only when it is partially filled
        # (offset 0 means the new tokens land on fresh pages alone)
        cow_needed = (tokens % self.block_size != 0 and table
                      and self._ref[table[-1]] > 1)
        if new_pages + int(cow_needed) > self.num_free_blocks:
            raise NoFreeBlocksError(
                f"need {new_pages + int(cow_needed)} blocks for "
                f"{n} slots, {self.num_free_blocks} free")
        cows = []
        if cow_needed:
            src = table[-1]
            dst = self._take()
            self._ref[src] -= 1              # shared: stays >= 1
            table[-1] = dst
            cows.append((src, dst))
        for _ in range(new_pages):
            table.append(self._take())
        self._tokens[seq_id] = tokens + n
        slots = [table[t // self.block_size] * self.block_size
                 + t % self.block_size for t in range(tokens, tokens + n)]
        return slots, cows

    def rollback_slots(self, seq_id, n):
        """Give back the LAST ``n`` reserved slots (rejected speculative
        drafts): the token count shrinks and every page no longer
        holding any of the sequence's tokens is released.  Rolled-back
        pages are fresh tail pages — never prefix-cache registered (the
        engine registers full pages only after accepting their tokens),
        so they return straight to the free pool."""
        n = int(n)
        if n == 0:
            return
        if n < 0:
            raise ValueError(f"rollback_slots needs n >= 0, got {n}")
        tokens = self._tokens[seq_id] - n
        if tokens < 0:
            raise ValueError(
                f"cannot roll back {n} of {self._tokens[seq_id]} tokens")
        table = self._tables[seq_id]
        keep = self.blocks_needed(tokens)
        while len(table) > keep:
            blk = table.pop()
            self._ref[blk] -= 1
            if self._ref[blk] == 0:
                self._release(blk)
        self._tokens[seq_id] = tokens

    def fork(self, parent_id, child_id):
        """Child shares every parent page (refcounted, copy-on-write on
        the next divergent append)."""
        if child_id in self._tables:
            raise ValueError(f"sequence {child_id!r} already allocated")
        table = self._tables[parent_id]
        for blk in table:
            self._ref[blk] += 1
        self._tables[child_id] = list(table)
        self._tokens[child_id] = self._tokens[parent_id]

    def promote_fork(self, parent_id, child_id):
        """Replace the parent's page chain with its fork child's —
        tree-speculation branch acceptance: the verified sibling row's
        K/V lives on the child's (COW-diverged) chain, so the child
        BECOMES the sequence.  The parent's old pages drop one
        reference each (still-shared pages survive under the child's
        table; exclusively-held ones go back to the pool / LRU), and
        the child's table and token count are renamed to
        ``parent_id``.  The child id ceases to exist."""
        if child_id not in self._tables:
            raise KeyError(f"fork child {child_id!r} owns no pages")
        table = self._tables.pop(child_id)
        tokens = self._tokens.pop(child_id)
        self.free(parent_id)
        self._tables[parent_id] = table
        self._tokens[parent_id] = tokens

    # ----------------------------------------------------------- migration --
    def export_seq(self, seq_id):
        """Serialize ``seq_id``'s page chain for migration to another
        pool: block ids in table order (the gather order of the page
        payload), the total token count, per-page token occupancy, and
        each page's prefix-cache chain hash (None for tail pages and
        pages that never registered).  Strictly read-only — refcounts
        are NOT part of the wire format: a page shared here (adopted
        from the cache, or COW-shared with a fork sibling) is exported
        by value, and the importing pool collapses it to a private copy
        with refcount 1."""
        if seq_id not in self._tables:
            raise KeyError(f"sequence {seq_id!r} owns no pages here")
        table = self._tables[seq_id]
        n = self._tokens[seq_id]
        bs = self.block_size
        return {
            "num_tokens": int(n),
            "block_ids": list(table),
            "page_tokens": [max(0, min(bs, n - i * bs))
                            for i in range(len(table))],
            "hashes": [self._block_hash.get(b) for b in table],
        }

    def import_seq(self, seq_id, export):
        """Allocate a PRIVATE page chain for an exported sequence and
        return the new block table (same order as the export's
        ``block_ids``, so the caller scatters the gathered payload
        positionally).  Every page comes fresh with refcount 1 —
        shared refcounts collapse on migration by design.  All-or-
        nothing: on any failure (pool exhausted, injected OOM) nothing
        is mutated.  Hash registration is deliberately a SEPARATE step
        (:meth:`register_imported`): the caller copies page contents
        between pools after allocation, and a fault in that window must
        reclaim via :meth:`free` without ever having exposed an
        unfilled page through the prefix cache."""
        n = int(export["num_tokens"])
        need = len(export["block_ids"])
        if need != self.blocks_needed(n):
            raise ValueError(
                f"corrupt export: {need} pages cannot hold {n} tokens "
                f"at page size {self.block_size}")
        return self.allocate(seq_id, n)

    def register_imported(self, seq_id, hashes):
        """Re-register a migrated-in sequence's FULL pages in this
        pool's prefix cache, positionally from the export's ``hashes``
        (None entries — tail pages, never-registered pages — are
        skipped; first-writer-wins exactly like
        :meth:`register_full_block`).  Call only after the page
        contents actually landed in this pool."""
        for i, h in enumerate(hashes):
            if h is not None:
                self.register_full_block(seq_id, i, h)

    def _release(self, blk):
        """Refcount hit zero: park hashed pages on the LRU list (still
        adoptable), return unhashed pages to the raw free list."""
        del self._ref[blk]
        if blk in self._block_hash:
            self._lru[blk] = None                # most-recently freed
        else:
            self._free.append(blk)

    def free(self, seq_id):
        """Release the sequence; pages return to the pool (or the LRU
        cached pool) at refcount 0."""
        for blk in self._tables.pop(seq_id):
            self._ref[blk] -= 1
            if self._ref[blk] == 0:
                self._release(blk)
        del self._tokens[seq_id]
