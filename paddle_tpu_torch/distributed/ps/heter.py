"""Device-resident hot-row embedding cache — the HeterPS analog.

Port of ``paddle_tpu/distributed/ps/heter.py`` (reference:
paddle/fluid/framework/fleet/heter_ps/ — ps_gpu_wrapper.h builds
per-pass GPU hashtables of hot feature rows, feature_value.h packs row +
optimizer state, trains the pass device-side and merges back into the
host/SSD table at EndPass; ctr_accessor.cc ShowClickScore ranks rows for
retention).

No device hashtable: the cache is fixed-capacity tensors on an explicit
device (``device``; None is the current Paddle device) — the rows, their
base copies and, for Adagrad, the accumulators — updated in place by
index writes, with a host-side dict mapping key -> slot.  Row payloads
and gradient math stay on the device for cache hits (no host round
trip, no host-to-device copy).  Write-back uses GeoSGD-style deltas
(``w_server += w_local - w_base``, the ``push_delta`` verb), so the host
table's accessor depth — CTR stats, disk tier, shrink — keeps operating
unchanged underneath the cache.

Where the JAX cache pads each update to a power-of-two length (its
compile buckets) and lets XLA drop the out-of-range padding slots, eager
torch needs no buckets; a key without a slot is dropped from the device
update the same way.  Duplicate keys in a push are never scattered at
once: the gradients are layered into rounds (round r holds the r-th
occurrence of every key), each round writes unique slots, so no two
writes meet in one index update and the result does not depend on the
order a device applies them in.  SGD sums the rounds into one gradient
a key, then writes once (the JAX summed scatter); Adagrad applies round
after round, as the host table applies each occurrence.

Semantics (reference pass semantics, ps_gpu_wrapper BuildGPUTask/
EndPass): cached rows see the local trainer's updates immediately and
other trainers' updates at flush(refresh=True)/eviction boundaries.
With a single trainer and the same optimizer formula the cached run is
step-for-step identical to the uncached one — including duplicate keys
within a batch and eviction/re-admission cycles (the adagrad accumulator
spills to host memory with the row).  The one documented exception:
a key that overflowed capacity and was pushed through to the host keeps
its optimizer history there; if later admitted, the cache restarts its
local accumulator (no verb reads host g2 back).
"""

from contextlib import contextmanager

import numpy as np
import torch


def _occurrence_rounds(inv):
    """For the positions of a push whose unique-key index is ``inv``:
    the list of position arrays of round r = 0, 1, ... (the r-th
    occurrence of every key, in push order)."""
    if not len(inv):
        return []
    order = np.argsort(inv, kind="stable")
    sorted_inv = inv[order]
    starts = np.searchsorted(sorted_inv, np.arange(int(inv.max()) + 1))
    rank_sorted = np.arange(len(inv)) - starts[sorted_inv]
    occ = np.empty(len(inv), np.int64)
    occ[order] = rank_sorted
    return [np.nonzero(occ == r)[0] for r in range(int(occ.max()) + 1)]


class HotRowCache:
    """SparseTable-compatible facade: HBM cache over a remote PS table.

    Drop-in for ``DistributedEmbedding(table=...)`` — pulls return
    tensors already on the device; pushes apply the optimizer on the
    device and mark rows dirty for delta write-back.

    >>> cache = HotRowCache(remote, capacity=4096, flush_interval=16)
    >>> rows = cache.pull(ids)        # device gather on hit, RPC on miss
    >>> cache.push(ids, grads)        # jitted scatter update, no RTT
    >>> cache.flush(refresh=True)     # EndPass: write back + resync
    """

    def __init__(self, remote, capacity=4096, optimizer="sgd",
                 learning_rate=0.05, epsilon=1e-8, flush_interval=0,
                 score_decay=0.98, async_flush=False, device=None):
        """``async_flush=True``: the periodic ``flush_interval`` flush
        snapshots the dirty deltas under the cache lock and performs the
        RPCs on a background thread, so the trainer's push() returns
        without waiting a server round-trip.  Staleness bound is
        unchanged (other trainers' updates fold in at the same refresh
        boundaries); the refresh application skips any slot the trainer
        dirtied or rebound while the RPC was in flight, so local updates
        are never clobbered by a stale pull."""
        import threading

        from ...framework.device import (_torch_device, current_device,
                                         resolve_device)

        self.device = current_device() if device is None \
            else resolve_device(_torch_device(device))
        self.remote = remote
        self.async_flush = bool(async_flush)
        self._lock = threading.RLock()      # cache state
        # the native PsClient matches responses by stream order with no
        # internal mutex (same constraint as GeoSGDWorker._remote_mu):
        # trainer-thread RPCs and the background flush must not
        # interleave on its socket
        self._rpc_mu = threading.Lock()
        self._bg = None
        self._bg_running = False
        self._flush_pending = False
        self._pending_refresh = False
        self._bg_error = None
        # deltas whose write-back RPC FAILED: retried (merged into the
        # payload) by the next write-back; never silently dropped
        self._failed_deltas = {}
        self.dim = int(remote.dim)
        self.capacity = int(capacity)
        self.optimizer = optimizer
        if optimizer not in ("sgd", "adagrad"):
            raise ValueError(f"unknown cache optimizer {optimizer!r}")
        self.learning_rate = float(learning_rate)
        self.epsilon = float(epsilon)
        self.flush_interval = int(flush_interval)
        self.score_decay = float(score_decay)
        # host-side spill of evicted adagrad accumulators is bounded:
        # beyond this, the oldest entries drop (their rows restart the
        # accumulator on re-admission — same as the overflow path)
        self.spill_capacity = 16 * self.capacity

        def zeros():
            return torch.zeros((self.capacity, self.dim),
                               dtype=torch.float32, device=self.device)

        self._rows = zeros()
        self._base = zeros()
        # adagrad state lives on-device beside the rows (feature_value.h
        # packs optimizer state the same way); sgd never touches it, so
        # don't spend the HBM.  Evicted accumulators spill to host memory
        # and restore on re-admission, preserving single-trainer parity
        # across capacity pressure.
        self._accum = zeros() if optimizer == "adagrad" else None
        self._accum_spill = {}
        self._key_of = np.full((self.capacity,), -1, np.int64)
        self._slot_of = {}
        self._free = list(range(self.capacity - 1, -1, -1))
        # retention score: decayed access frequency — the "show" half of
        # ctr_accessor.cc ShowClickScore applied to cache residency
        self._score = np.zeros((self.capacity,), np.float64)
        self._dirty = np.zeros((self.capacity,), bool)
        self._steps = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rtts = {"pull": 0, "push": 0, "push_delta": 0}

    on_device = True    # DistributedEmbedding pushes the device gradient

    def _idx(self, a):
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _dev(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------ admit ----

    def _writeback_slots(self, slots):
        """Push w - w_base for the given dirty slots (one RTT)."""
        keys, delta = self._snapshot_writeback(slots)
        self._rpc_push_delta(keys, delta)

    def _rpc_push_delta(self, keys, delta):
        """One write-back RPC carrying ``keys/delta`` plus any deltas a
        previous failed RPC left behind.  On failure the whole payload
        returns to the retry buffer — the snapshot already advanced
        ``base``, so these deltas exist nowhere else (clearing dirty
        before the RPC would lose them for good on a failure)."""
        with self._lock:
            if self._failed_deltas:
                extra_k = np.fromiter(self._failed_deltas.keys(),
                                      np.int64, len(self._failed_deltas))
                extra_d = np.stack([self._failed_deltas[k]
                                    for k in extra_k.tolist()])
                self._failed_deltas.clear()
                if keys is None:
                    keys, delta = extra_k, extra_d
                else:
                    keys = np.concatenate([keys, extra_k])
                    delta = np.concatenate([delta, extra_d])
        if keys is None:
            return
        try:
            with self._rpc_mu:
                self.remote.push_delta(keys, delta)
        except Exception:
            with self._lock:
                for k, d in zip(keys.tolist(), delta):
                    prev = self._failed_deltas.get(k)
                    self._failed_deltas[k] = d if prev is None \
                        else prev + d
            raise
        self.rtts["push_delta"] += 1

    def _snapshot_writeback(self, slots):
        """Under the cache lock: compute (keys, delta) for the dirty
        subset of ``slots`` and mark them clean (base := rows).  The
        caller owns the RPC — outside the lock for the async path."""
        with self._lock:
            slots = np.asarray(slots, np.int64)
            d = slots[self._dirty[slots]]
            if not len(d):
                return None, None
            dt = self._idx(d)
            delta = (self._rows[dt] - self._base[dt]).cpu().numpy()
            keys = self._key_of[d].copy()
            self._base[dt] = self._rows[dt]
            self._dirty[d] = False
            return keys, delta

    @contextmanager
    def _fully_unlocked(self):
        """Exit EVERY recursion level of this thread's hold on the cache
        RLock for the duration, then restore the depth.  A bare
        release() pops one level only, so a re-entrant caller (pull()
        invoked while already inside the lock) would carry the lock into
        the server round-trip — stalling every cache operation for a
        full RTT and deadlocking against anything that completes the RPC
        only once the lock frees."""
        depth = 0
        while self._lock._is_owned():
            self._lock.release()
            depth += 1
        try:
            yield
        finally:
            for _ in range(depth):
                self._lock.acquire()

    def _admit(self, missing, pinned):
        """Fetch ``missing`` keys from the remote table and cache as
        many as fit; returns {key: server_row} for keys that could NOT
        be cached (they stay on the uncached pass-through path this
        batch).

        Structure: the miss set was computed under the lock by the
        caller; the lock is FULLY exited for the fetch (the background
        refresh may hold _rpc_mu for its own RTT; holding _lock here
        would stall every cache operation behind it); admission then
        re-resolves under the re-entered lock, since another thread may
        have admitted some of these keys meanwhile."""
        with self._fully_unlocked():
            with self._rpc_mu:
                rows_host = np.asarray(self.remote.pull(missing))
        self.rtts["pull"] += 1
        row_of = {int(k): rows_host[i]
                  for i, k in enumerate(missing.tolist())}
        # keys admitted by a concurrent pull while the lock was down:
        # their cached rows are newer than our snapshot — keep them, and
        # pin their slots so our eviction below cannot claim them
        pinned = set(pinned)
        still = []
        for k in missing.tolist():
            s = self._slot_of.get(k)
            if s is None:
                still.append(k)
            else:
                pinned.add(s)
        still = np.asarray(still, np.int64)
        m = len(still)
        if len(self._free) < m:
            need = m - len(self._free)
            occupied = np.nonzero(self._key_of >= 0)[0]
            evictable = occupied[~np.isin(
                occupied, np.fromiter(pinned, np.int64, len(pinned)))] \
                if pinned else occupied
            if len(evictable):
                order = np.argsort(self._score[evictable], kind="stable")
                victims = evictable[order[:need]]
                self._writeback_slots(victims)
                if self._accum is not None and len(victims):
                    acc_host = self._accum[self._idx(victims)].cpu().numpy()
                    for s, a in zip(victims.tolist(), acc_host):
                        self._accum_spill[int(self._key_of[s])] = a
                    while len(self._accum_spill) > self.spill_capacity:
                        self._accum_spill.pop(
                            next(iter(self._accum_spill)))
                for s in victims.tolist():
                    del self._slot_of[int(self._key_of[s])]
                    self._key_of[s] = -1
                    self._score[s] = 0.0
                    self._free.append(s)
                self.evictions += len(victims)
        n_fit = min(m, len(self._free))
        slots = np.asarray([self._free.pop() for _ in range(n_fit)],
                           np.int64)
        if n_fit:
            fit_keys = still[:n_fit]
            rows_fit = self._dev(np.stack([row_of[int(k)] for k in fit_keys]))
            st = self._idx(slots)
            self._rows[st] = rows_fit
            self._base[st] = rows_fit
            if self._accum is not None:
                acc = np.stack([
                    self._accum_spill.pop(int(k),
                                          np.zeros((self.dim,), np.float32))
                    for k in fit_keys])
                self._accum[st] = self._dev(acc)
            self._key_of[slots] = fit_keys
            self._score[slots] = 1.0
            for k, s in zip(fit_keys.tolist(), slots.tolist()):
                self._slot_of[k] = s
        return {int(k): row_of[int(k)] for k in still[n_fit:].tolist()}

    # ------------------------------------------------------- pull / push ----

    def pull(self, keys):
        with self._lock:
            return self._pull_locked(keys)

    def _pull_locked(self, keys):
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1),
                                    dtype=np.int64)
        shape = keys.shape
        uniq, inv = np.unique(keys, return_inverse=True)
        slots = np.fromiter((self._slot_of.get(k, -1)
                             for k in uniq.tolist()), np.int64, len(uniq))
        cached = slots >= 0
        self.hits += int(cached.sum())
        self.misses += int((~cached).sum())
        self._score[slots[cached]] += 1.0
        passthrough = {}
        if not cached.all():
            missing = uniq[~cached]
            pinned = set(slots[cached].tolist())
            passthrough = self._admit(missing, pinned)
            # refresh only the previously-missing entries (keys that
            # overflowed capacity stay -1 and are served from
            # ``passthrough``, keyed — not positional — because a
            # concurrent pull may have admitted part of the miss set)
            for i in np.nonzero(~cached)[0]:
                slots[i] = self._slot_of.get(int(uniq[i]), -1)
        out = self._rows[self._idx(np.clip(slots, 0, self.capacity - 1))]
        still_missing = np.nonzero(slots < 0)[0]
        if len(still_missing):
            # capacity overflow: serve those rows straight from the RPC
            # reply (pass-through path; push() mirrors it)
            rows = np.stack([passthrough[int(uniq[i])]
                             for i in still_missing])
            out[self._idx(still_missing)] = self._dev(rows)
        return out[self._idx(inv)].reshape(shape + (self.dim,))

    def push(self, keys, grads, learning_rate=None):
        with self._lock:
            return self._push_locked(keys, grads, learning_rate)

    def _push_locked(self, keys, grads, learning_rate=None):
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1),
                                    dtype=np.int64)
        if not len(keys):
            return
        g = torch.as_tensor(grads).to(self.device, torch.float32).reshape(
            len(keys), self.dim)
        lr = self.learning_rate if learning_rate is None else float(
            learning_rate)
        uniq, inv = np.unique(keys, return_inverse=True)
        slots = np.fromiter((self._slot_of.get(k, -1)
                             for k in uniq.tolist()), np.int64, len(uniq))
        uncached = slots < 0
        if uncached.any():
            # push-before-pull or capacity overflow: the raw per-occurrence
            # grads go straight to the remote table, which applies ITS
            # optimizer sequentially in order, exactly as an uncached push
            # would (matching config is the caller's contract, as with
            # DistributedEmbedding)
            pos = np.nonzero(uncached[inv])[0]
            with self._rpc_mu:
                self.remote.push(keys[pos], g[self._idx(pos)].cpu().numpy(),
                                 learning_rate=lr)
            self.rtts["push"] += 1
        # a key without a slot (pushed through above) is dropped here,
        # as the JAX update drops its out-of-range padding slot
        keep = ~uncached[inv]
        rounds = [pos[keep[pos]] for pos in _occurrence_rounds(inv)]
        rounds = [pos for pos in rounds if len(pos)]
        if self.optimizer == "sgd":
            # sgd is linear in the gradient: the rounds summed into one
            # gradient a key, then one write of the unique slots
            g_u = torch.zeros((len(uniq), self.dim), dtype=torch.float32,
                              device=self.device)
            for pos in rounds:
                g_u.index_add_(0, self._idx(inv[pos]), g[self._idx(pos)])
            held = np.nonzero(~uncached)[0]
            st = self._idx(slots[held])
            self._rows[st] -= lr * g_u[self._idx(held)]
        else:
            # adagrad is NOT: the host table applies each occurrence
            # sequentially (accum += g_i^2 per row), so the rounds apply
            # in turn, each over unique slots
            for pos in rounds:
                st = self._idx(slots[inv[pos]])
                g_r = g[self._idx(pos)]
                self._accum[st] += g_r * g_r
                denom = torch.sqrt(self._accum[st]) + self.epsilon
                self._rows[st] -= lr * g_r / denom
        self._dirty[slots[~uncached]] = True
        self._steps += 1
        if self.flush_interval and self._steps % self.flush_interval == 0:
            if self.async_flush:
                self.flush_async(refresh=True)
            else:
                self.flush(refresh=True)

    # ----------------------------------------------------------- control ----

    def flush(self, refresh=False):
        """Write back all dirty rows (one RTT).  ``refresh=True`` then
        re-pulls every cached key so other trainers' updates fold in —
        the EndPass merge of ps_gpu_wrapper."""
        self._raise_bg_error()
        with self._lock:
            dirty = np.nonzero(self._dirty)[0]
        self._writeback_slots(dirty)
        if refresh:
            with self._lock:
                occ = np.nonzero(self._key_of >= 0)[0]
                occ_keys = self._key_of[occ].copy()
            if len(occ):
                with self._rpc_mu:
                    fresh = self.remote.pull(occ_keys)
                self.rtts["pull"] += 1
                self._apply_refresh(occ, occ_keys, fresh)
        with self._lock:
            self._score *= self.score_decay

    def _apply_refresh(self, occ, occ_keys, fresh):
        """Fold server rows into cache slots — skipping any slot the
        trainer dirtied or rebound while the pull was in flight (the
        async path races by design; local updates must win until the
        NEXT flush writes them back)."""
        with self._lock:
            same = self._key_of[occ] == occ_keys
            clean = ~self._dirty[occ]
            ok = np.nonzero(same & clean)[0]
            if not len(ok):
                return
            fj = self._dev(np.asarray(fresh)[ok])
            oj = self._idx(occ[ok])
            self._rows[oj] = fj
            self._base[oj] = fj

    def flush_async(self, refresh=False):
        """flush() with the RPCs on a background thread: the deltas
        snapshot under the lock NOW (so subsequent pushes accumulate
        against the new base), the server round-trips happen off the
        trainer's critical path.  One background worker runs at a time;
        a request arriving while one is in flight marks a PENDING cycle
        that the worker executes (with a fresh snapshot + score decay)
        before exiting — rows dirtied after the in-flight snapshot are
        carried by that next cycle, never dropped, so the staleness
        bound degrades by at most one server RTT, not unboundedly.
        A background RPC failure is re-raised by the next join_flush()/
        flush()/close(), and its deltas sit in the retry buffer."""
        import threading

        with self._lock:
            if self._bg_running:
                self._flush_pending = True
                self._pending_refresh = self._pending_refresh or refresh
                return self._bg
            self._bg_running = True
            keys, delta = self._snapshot_writeback(
                np.nonzero(self._dirty)[0])

        def cycle(keys, delta, refresh):
            self._rpc_push_delta(keys, delta)
            if refresh:
                with self._lock:
                    occ = np.nonzero(self._key_of >= 0)[0]
                    occ_keys = self._key_of[occ].copy()
                if len(occ):
                    with self._rpc_mu:
                        fresh = self.remote.pull(occ_keys)
                    self.rtts["pull"] += 1
                    self._apply_refresh(occ, occ_keys, fresh)
            with self._lock:
                self._score *= self.score_decay

        def bg(keys, delta, refresh):
            try:
                while True:
                    cycle(keys, delta, refresh)
                    with self._lock:
                        if not self._flush_pending:
                            self._bg_running = False
                            return
                        self._flush_pending = False
                        refresh = self._pending_refresh
                        self._pending_refresh = False
                        keys, delta = self._snapshot_writeback(
                            np.nonzero(self._dirty)[0])
            except Exception as e:  # surfaced at the next sync point
                with self._lock:
                    self._bg_error = e
                    self._bg_running = False

        self._bg = threading.Thread(target=bg, args=(keys, delta, refresh),
                                    daemon=True)
        self._bg.start()
        return self._bg

    def join_flush(self):
        """Wait for any in-flight background flush; re-raise its error."""
        if self._bg is not None:
            self._bg.join()
        self._raise_bg_error()

    def _raise_bg_error(self):
        with self._lock:
            err, self._bg_error = self._bg_error, None
        if err is not None:
            raise RuntimeError(
                "background flush failed (deltas kept in the retry "
                "buffer for the next write-back)") from err

    def stats(self):
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "evictions": self.evictions,
            "cached_rows": int((self._key_of >= 0).sum()),
            "rtts": dict(self.rtts),
        }

    def close(self):
        self.join_flush()
        self.flush()
