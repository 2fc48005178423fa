"""Discrete-event fleet simulator — real host code, virtual devices.

The simulator answers "what would this policy do at fleet scale?"
without touching an accelerator, by keeping every host-side decision
maker REAL and replacing only the device:

- the real :class:`~paddle_tpu_torch.inference.llm.LLMEngine` runs
  unmodified — its Scheduler, BlockManager, prefix cache, RetryPolicy,
  StepWatchdog and fault injector all execute exactly the code that
  serves production traffic;
- the real :class:`~paddle_tpu_torch.inference.llm.Fleet` runs
  unmodified — Router affinity, HealthConfig hysteresis, token-exact
  failover, MigrationPolicy and disaggregated prefill/decode included;
- :class:`SimEngine` (a subclass) overrides exactly two device seams:
  pool allocation (host tensors over untouched zero pages) and the
  packed step run (a token oracle instead of the model), so nothing
  runs on a device, the SimEngines of one fleet share one host copy of
  the weights, and a 100-replica fleet costs one core;
- time is a :class:`~paddle_tpu_torch.sim.clock.VirtualClock` the
  engines already accept (``clock=``); :func:`run_virtual` advances it
  by the :class:`~paddle_tpu_torch.framework.cost.StepTimeModel`
  roofline estimate of each step's recorded ``(kind, bucket)``
  launches, per device profile, priced from the engine's own shapes.

Because generated token VALUES feed back into decisions (eos stops;
``_register_full_blocks`` hashes generated tokens, so cross-request
prefix-cache hits change admission and preemption), exact replay
needs a token oracle: :class:`ReplayOracle` answers from a recorded
real run, :class:`SyntheticOracle` from a deterministic hash.  With a
ReplayOracle, :func:`calibrate` reruns a real trace in simulation and
diffs the frozen event-log records (events.py) — the decisions-exact
gate — and compares virtual durations — the timing band.

``SyntheticOracle``, ``ReplayOracle``, :func:`run_virtual`,
:func:`simulate` and :func:`calibrate` are the JAX package's
(``paddle_tpu/sim/simulator.py``), with ``"h100"`` as the default
profile; :class:`SimEngine` is rewritten over the port engine's seams.
"""

import time
from collections import deque

import numpy as np

import torch

from ..framework.cost import StepTimeModel
from ..inference.llm.engine import _DTYPES, LLMEngine, _Pools
from ..inference.llm.events import to_records
from ..inference.llm.fleet import Fleet
from .clock import VirtualClock

# the host pools' numpy dtype for each pool dtype
_HOST_DTYPES = {torch.float32: np.float32, torch.bfloat16: np.int16,
                torch.int8: np.int8}

__all__ = [
    "SyntheticOracle", "ReplayOracle", "SimEngine",
    "sim_engine_factory", "run_virtual", "simulate", "calibrate",
]


# ------------------------------------------------------------ oracles --
class SyntheticOracle:
    """Deterministic stand-in for the model's argmax: the token the
    "model" predicts for the query at absolute position ``p`` of
    request ``rid`` is a hash of ``(rid, p + 1)`` — i.e. the oracle
    defines position ``p + 1``'s true token, the same convention the
    engine's commit loop expects.  Stable across processes (no
    ``hash()``), so two sim runs of one trace are bitwise identical.

    ``avoid`` excludes token values (pass the trace's eos id to keep
    sequences running to max_new_tokens)."""

    def __init__(self, vocab_size=128, avoid=()):
        self.vocab_size = int(vocab_size)
        self.avoid = frozenset(int(a) for a in avoid)
        if len(self.avoid) >= self.vocab_size:
            raise ValueError("avoid covers the whole vocabulary")

    def next_token(self, request, position):
        rid = request.request_id
        if not isinstance(rid, (int, np.integer)):
            rid = sum(str(rid).encode())    # stable, unlike hash()
        h = (int(rid) * 1315423911
             + (int(position) + 1) * 2654435761) & 0x7FFFFFFF
        tok = h % self.vocab_size
        while tok in self.avoid:
            tok = (tok + 1) % self.vocab_size
        return tok


class ReplayOracle:
    """Answers from a recorded run: the prediction at position ``p``
    of request ``rid`` is token ``p + 1`` of the sequence the REAL
    engine produced for ``rid`` (prompt + outputs).  Speculative
    verify rows replay exactly too: every token the commit loop reads
    (up to and including the first draft mismatch) was predicted under
    correct context in the real run, so it equals the true sequence at
    that position — which is precisely what this oracle returns.
    Positions past the recorded sequence answer 0 (only reachable if
    the sim diverges, which the calibration gate catches)."""

    def __init__(self, sequences):
        self.sequences = {rid: [int(t) for t in seq]
                          for rid, seq in sequences.items()}

    @classmethod
    def from_outputs(cls, outputs):
        """Build from RequestOutputs of a real run (``all_ids`` =
        prompt + generated)."""
        return cls({o.request_id: list(o.all_ids) for o in outputs})

    def next_token(self, request, position):
        seq = self.sequences.get(request.request_id)
        if seq is None or position + 1 >= len(seq):
            return 0
        return seq[position + 1]


# ---------------------------------------------------------- sim engine --
class _SharedWeights:
    """The model as an engine reads it (``config`` and
    ``functional_decompose()``), its decomposition made once, on the
    host, in the engine's dtype, and kept in ``cache`` (with the model,
    so its id stays its own) — so the engine's own cast copies nothing
    and every SimEngine built over one cache holds the same weight
    tensors.  The oracle never reads a weight; the engine still prices
    them into its memory model."""

    def __init__(self, model, cache, dtype):
        self.config = model.config
        key = (id(model), dtype)
        if key not in cache:
            d = model.functional_decompose()
            cache[key] = (model, {
                "num_layers": d["num_layers"],
                "params": {g: {k: (v.detach().to("cpu", dtype)
                                   if v.is_floating_point()
                                   else v.detach().cpu())
                               for k, v in sub.items()}
                           for g, sub in d["params"].items()}})
        self._decomposed = cache[key][1]

    def functional_decompose(self):
        return self._decomposed


class SimEngine(LLMEngine):
    """LLMEngine with the device replaced by a token oracle.

    Exactly two device seams are overridden — :meth:`_alloc_pools`
    (host tensors over ``np.zeros``, whose calloc'd pages stay untouched
    until a migration or a copy-on-write writes them: zero device
    memory, next to no host memory for the pools) and
    :meth:`_ragged_fn` (the oracle fills the argmax vector from the
    step's packed rows; nothing runs on a device, and copy-on-write
    copies land in the host pools) — plus
    :meth:`_launch_packed`, which hands ``_ragged_fn`` the step's rows
    the oracle needs, and ``warmup()`` (nothing to capture).  The engine
    always lives on the CPU, whatever ``device=`` says: a calibration
    replays the real leg's engine kwargs.  Everything else, from the
    scheduler to retry/quarantine to page bookkeeping and the migration
    page moves, is the real engine's code, which is what makes sim
    decisions trustworthy.

    Greedy traffic only: the oracle replaces argmax, not sampling —
    ``add_request(temperature > 0)`` raises.  Single virtual device
    per engine: model tensor parallelism through the StepTimeModel's
    device profile instead of ``tensor_parallel=``."""

    def __init__(self, model, *, oracle=None, **kwargs):
        if kwargs.get("tensor_parallel") or kwargs.get("mesh"):
            raise ValueError(
                "SimEngine is one virtual device per replica; model "
                "TP through the StepTimeModel's device profile, not "
                "tensor_parallel=/mesh=")
        self.oracle = oracle if oracle is not None else SyntheticOracle()
        self._sim_rows = []
        kwargs["device"] = "cpu"
        super().__init__(model, **kwargs)

    def _alloc_pools(self, num_layers):
        nl, nb, bs, nh, hd = (num_layers, self.num_blocks, self.block_size,
                              self.num_heads, self.head_dim)

        def zeros(shape, dtype):
            # numpy has no bfloat16: its zero pages are int16 zeros
            return torch.from_numpy(np.zeros(shape, _HOST_DTYPES[dtype])) \
                .view(dtype)

        kv_dtype = torch.int8 if self._kv_quant else self.dtype
        k_rows, v_rows = (zeros((nl, nb * bs + 1, nh, hd), kv_dtype)
                          for _ in range(2))
        kc, vc = (rows[:, :nb * bs].view(nl, nb, bs, nh, hd)
                  for rows in (k_rows, v_rows))
        ks = vs = ks_flat = vs_flat = None
        if self._kv_quant:
            ks_flat, vs_flat = (zeros((nl, (nb + 1) * nh * bs),
                                      torch.float32) for _ in range(2))
            ks, vs = (flat.view(nl, nb + 1, nh, bs)[:, :nb]
                      for flat in (ks_flat, vs_flat))
        return _Pools(k_rows, v_rows, kc, vc, ks_flat, vs_flat, ks, vs)

    def add_request(self, prompt_ids, max_new_tokens=16,
                    eos_token_id=None, temperature=0.0, request_id=None,
                    seed=None, deadline_ms=None, **kwargs):
        if temperature and float(temperature) > 0.0:
            raise ValueError(
                f"SimEngine serves greedy traffic only (the oracle "
                f"replaces argmax, not sampling); got "
                f"temperature={temperature}")
        for knob in ("logprobs", "grammar"):
            if kwargs.get(knob):
                raise ValueError(
                    f"SimEngine's oracle bypasses the logits pipeline; "
                    f"{knob}= is not simulable")
        return super().add_request(
            prompt_ids, max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id, temperature=temperature,
            request_id=request_id, seed=seed, deadline_ms=deadline_ms,
            **kwargs)

    def _launch_packed(self, rows, pk, finished):
        self._sim_rows = rows
        try:
            return super()._launch_packed(rows, pk, finished)
        finally:
            self._sim_rows = []

    def _ragged_fn(self, pk):
        # copy-on-write page copies land in the host pools, as the real
        # step writes them before its body
        self._writes_began = True
        if pk["cows"]:
            self._copy_on_write(pk["cows"])
        self.stats["launches"] += 1
        # the oracle's argmax: for the query at absolute position p the
        # model predicts the true token at p + 1 — the real step's
        # indexing, read from the packed row descriptors
        tb, rmax = pk["tb"], self.max_batch
        desc = pk["ints"][3 * tb:]
        row_start, row_qlen, row_pos0 = (desc[:rmax], desc[rmax:2 * rmax],
                                         desc[2 * rmax:3 * rmax])
        nxt = np.zeros(tb, np.int64)
        for ri, row in enumerate(self._sim_rows):
            req = row.request
            s0 = int(row_start[ri])
            p0 = int(row_pos0[ri])
            for j in range(int(row_qlen[ri])):
                nxt[s0 + j] = self.oracle.next_token(req, p0 + j)
        # logits=None is safe: greedy-only traffic never reaches
        # _fetch_sampling_rows' logit indexing
        return torch.from_numpy(nxt), None

    def warmup(self):
        """Nothing is captured in simulation; Fleet.restart_replica and
        serving scripts may still call this."""
        return {}


def sim_engine_factory(oracle=None):
    """An ``engine_factory=`` for :class:`Fleet` that builds SimEngines
    sharing one oracle and one host copy of the weights (int8 block
    weights, quantized by each engine, excepted) —
    ``Fleet(model, engine_factory=sim_engine_factory(oracle),
    clock=VirtualClock(), ...)`` is a whole simulated fleet."""
    weights = {}

    def factory(model, **kwargs):
        dtype = _DTYPES.get(kwargs.get("dtype"))
        if dtype is not None:     # else the engine rejects the dtype
            model = _SharedWeights(model, weights, dtype)
        return SimEngine(model, oracle=oracle, **kwargs)
    return factory


# ---------------------------------------------------------- the harness --
def _engines(target):
    if hasattr(target, "replicas"):
        return [r.engine for r in target.replicas]
    return [target]


def _next_deadline(target):
    dl = [req.deadline for eng in _engines(target)
          for req in eng._requests.values() if req.deadline is not None]
    return min(dl) if dl else None


def _pct(xs):
    if not xs:
        return None
    a = np.sort(np.asarray(xs, np.float64))
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "mean": float(a.mean())}


def run_virtual(target, arrivals, prompts, new_tokens, *,
                step_time_model, clock, eos_token_id=None,
                deadline_ms=None, latency=True, max_steps=None,
                invariants_every=0):
    """Drive an engine or fleet through a trace on a virtual clock.

    ``target`` must have been constructed with ``clock=`` THIS
    VirtualClock — the harness advances it, the target reads it (for
    arrival stamps, deadlines, retry backoff, watchdog timing).  The
    same harness drives both calibration legs: a REAL engine stepped
    under virtual time, and a SimEngine — symmetry is what makes the
    timing comparison meaningful.

    Per iteration: admit every arrival that is due, step the target
    once, then advance the clock by the step-time model's estimate of
    the slowest replica's recorded launches (replicas run concurrently
    in real life, so virtual step time is the max, not the sum).  An
    idle step advances to the next arrival or the earliest live
    deadline, so deadline expiry is exact in virtual time.

    Returns a dict: outputs, virtual_s, steps, launches, tokens,
    wall_s, and (``latency=True``) ttft_ms/tpot_ms/e2e_ms percentile
    summaries measured in VIRTUAL milliseconds."""
    if not isinstance(clock, VirtualClock):
        raise TypeError(
            f"run_virtual needs the target's VirtualClock, got "
            f"{clock!r}")
    n = len(arrivals)
    if not (len(prompts) == len(new_tokens) == n):
        raise ValueError(
            f"trace arrays disagree: {n} arrivals, {len(prompts)} "
            f"prompts, {len(new_tokens)} new_tokens")
    order = sorted(range(n), key=lambda i: (float(arrivals[i]), i))
    pending = deque(order)
    outputs = []
    arrival_t, first_tok, done_t, tok_count, last_len = {}, {}, {}, {}, {}
    steps = launches = stalls = 0
    t_start = clock()
    wall0 = time.perf_counter()
    while pending or target.has_unfinished():
        while pending and float(arrivals[pending[0]]) <= clock.now + 1e-9:
            i = pending.popleft()
            rid = target.add_request(
                list(prompts[i]), max_new_tokens=int(new_tokens[i]),
                eos_token_id=eos_token_id, deadline_ms=deadline_ms)
            arrival_t[rid] = float(arrivals[i])
            stalls = 0
        if not target.has_unfinished():
            if not pending:
                break
            clock.advance(max(0.0,
                              float(arrivals[pending[0]]) - clock.now))
            continue
        outs = target.step()
        steps += 1
        if max_steps is not None and steps > max_steps:
            raise RuntimeError(
                f"run_virtual exceeded max_steps={max_steps} with "
                f"{len(pending)} arrivals pending")
        dt = 0.0
        for eng in _engines(target):
            t = 0.0
            if eng.last_launches:
                launches += len(eng.last_launches)
                t = step_time_model.launches_seconds(eng.last_launches)
                eng.last_launches = []   # dead replicas keep stale ones
            tier_b = getattr(eng, "last_tier_bytes", 0)
            if tier_b:
                # hierarchical-KV traffic (demotes / swap-ins / store
                # promotes+adopts) is host-staged and serial with the
                # step's launches — it adds to THIS engine's step time
                # before the across-replica max
                t += step_time_model.tier_seconds(tier_b)
                eng.last_tier_bytes = 0
            dt = max(dt, t)
        if dt > 0.0:
            # the step's tokens exist at step END: advance before
            # stamping, or every TTFT would be one step early
            clock.advance(dt)
            stalls = 0
        now = clock.now
        if latency:
            for rid, req in target._requests.items():
                m = len(req.output_ids)
                if m > last_len.get(rid, 0):
                    if rid not in first_tok:
                        first_tok[rid] = now
                    last_len[rid] = m
        for fo in outs:
            rid = fo.request_id
            m = len(fo.output_ids)
            if m and rid not in first_tok:
                first_tok[rid] = now
            done_t[rid] = now
            tok_count[rid] = m
            last_len.pop(rid, None)
        outputs.extend(outs)
        if invariants_every and steps % invariants_every == 0:
            _check_invariants(target)
        if dt > 0.0:
            pass
        elif outs:
            stalls = 0
        else:
            # idle step: jump to whatever unblocks work next
            horizon = []
            if pending:
                horizon.append(float(arrivals[pending[0]]))
            dl = _next_deadline(target)
            if dl is not None and dl > now:
                horizon.append(dl)
            if horizon:
                clock.advance(max(0.0, min(horizon) - now))
                stalls = 0
            else:
                stalls += 1
                if stalls > 100:
                    raise RuntimeError(
                        "run_virtual stalled: unfinished work, no "
                        "launches, no pending arrivals, no deadlines "
                        "— the target cannot make progress (e.g. a "
                        "request larger than the whole page pool)")
    _check_invariants(target)
    wall_s = time.perf_counter() - wall0
    res = {
        "outputs": outputs,
        "requests": len(outputs),
        "tokens": int(sum(len(o.output_ids) for o in outputs)),
        "steps": steps,
        "launches": launches,
        "virtual_s": clock() - t_start,
        "wall_s": wall_s,
        "requests_per_wall_s": (len(outputs) / wall_s
                                if wall_s > 0 else float("inf")),
    }
    if latency:
        ttft, tpot, e2e = [], [], []
        for rid, t0 in arrival_t.items():
            if rid in first_tok:
                ttft.append((first_tok[rid] - t0) * 1e3)
            if rid in done_t:
                e2e.append((done_t[rid] - t0) * 1e3)
            m = tok_count.get(rid, 0)
            if m > 1 and rid in first_tok and rid in done_t:
                tpot.append((done_t[rid] - first_tok[rid]) * 1e3
                            / (m - 1))
        res["ttft_ms"] = _pct(ttft)
        res["tpot_ms"] = _pct(tpot)
        res["e2e_ms"] = _pct(e2e)
    return res


def _check_invariants(target):
    if hasattr(target, "check_invariants"):
        target.check_invariants()
    else:
        target.scheduler.check_invariants()


# ------------------------------------------------------------- simulate --
def simulate(model, trace, *, replicas=0, oracle=None,
             engine_kwargs=None, fleet_kwargs=None, profile="h100",
             host_overhead_s=2e-4, step_time_model=None,
             eos_token_id=None, deadline_ms=None, latency=True,
             max_steps=None, invariants_every=0):
    """Build a simulated engine (``replicas=0``) or fleet and run one
    trace ``(arrivals, prompts, new_tokens)`` through it.  Returns
    ``(result, target)`` — the :func:`run_virtual` result dict (virtual
    latency percentiles included) plus the stepped target, whose
    ``events`` / ``lifecycle_stats()`` hold the decision record.

    The StepTimeModel defaults to the sim engine's per-bucket roofline
    under ``profile`` (:meth:`StepTimeModel.from_engine`), a lower bound
    on the card's step time (about a twelfth to a fifteenth of a
    replayed GPT-124M step on an H100 80GB HBM3 at 700 W), so the
    virtual latencies are too; pass ``step_time_model=`` built from
    measured times to read them in the card's units, or to reuse one
    across experiments."""
    clk = VirtualClock()
    engine_kwargs = dict(engine_kwargs or {})
    if replicas:
        target = Fleet(model, replicas=replicas, clock=clk,
                       engine_factory=sim_engine_factory(oracle),
                       **dict(fleet_kwargs or {}), **engine_kwargs)
        probe = target.replicas[0].engine
    else:
        target = SimEngine(model, oracle=oracle, clock=clk,
                           **engine_kwargs)
        probe = target
    stm = step_time_model if step_time_model is not None else \
        StepTimeModel.from_engine(probe, profile=profile,
                                  host_overhead_s=host_overhead_s)
    arrivals, prompts, new_tokens = trace
    res = run_virtual(target, arrivals, prompts, new_tokens,
                      step_time_model=stm, clock=clk,
                      eos_token_id=eos_token_id,
                      deadline_ms=deadline_ms, latency=latency,
                      max_steps=max_steps,
                      invariants_every=invariants_every)
    res["step_time_model"] = stm.to_dict()
    return res, target


# ------------------------------------------------------------ calibrate --
def calibrate(model, trace, *, replicas=0, engine_kwargs=None,
              fleet_kwargs=None, profile="h100",
              host_overhead_s=2e-4, step_time_model=None,
              eos_token_id=None, deadline_ms=None, latency=False,
              max_steps=None):
    """Run one trace through the REAL engine (on a virtual clock) and
    through the simulator, and compare.

    Leg 1 steps a real LLMEngine/Fleet — the model on its device —
    under :func:`run_virtual`, so its decision log is exactly what
    production code does with this trace, and its virtual duration is
    the cost model's estimate of the real run.  Leg 2 replays the same
    trace through SimEngines with a :class:`ReplayOracle` built from
    leg 1's outputs.  The gates:

    - ``decisions_exact`` — the frozen event-log records (fleet AND
      every per-engine log) compare equal;
    - ``tokens_exact`` — every request's output ids and finish reason
      match;
    - ``timing_err`` — relative gap between the two virtual durations
      (both legs meter time with the same StepTimeModel, so this
      measures decision/launch divergence, not roofline accuracy).
    """
    engine_kwargs = dict(engine_kwargs or {})
    fleet_kwargs = dict(fleet_kwargs or {})
    arrivals, prompts, new_tokens = trace

    clk_real = VirtualClock()
    if replicas:
        real = Fleet(model, replicas=replicas, clock=clk_real,
                     **fleet_kwargs, **engine_kwargs)
        probe = real.replicas[0].engine
    else:
        real = LLMEngine(model, clock=clk_real, **engine_kwargs)
        probe = real
    stm = step_time_model if step_time_model is not None else \
        StepTimeModel.from_engine(probe, profile=profile,
                                  host_overhead_s=host_overhead_s)
    res_real = run_virtual(real, arrivals, prompts, new_tokens,
                           step_time_model=stm, clock=clk_real,
                           eos_token_id=eos_token_id,
                           deadline_ms=deadline_ms, latency=latency,
                           max_steps=max_steps)

    oracle = ReplayOracle.from_outputs(res_real["outputs"])
    clk_sim = VirtualClock()
    if replicas:
        sim = Fleet(model, replicas=replicas, clock=clk_sim,
                    engine_factory=sim_engine_factory(oracle),
                    **fleet_kwargs, **engine_kwargs)
    else:
        sim = SimEngine(model, oracle=oracle, clock=clk_sim,
                        **engine_kwargs)
    res_sim = run_virtual(sim, arrivals, prompts, new_tokens,
                          step_time_model=stm, clock=clk_sim,
                          eos_token_id=eos_token_id,
                          deadline_ms=deadline_ms, latency=latency,
                          max_steps=max_steps)

    logs_real = [to_records(real.events)] + \
        [to_records(e.events) for e in _engines(real)]
    logs_sim = [to_records(sim.events)] + \
        [to_records(e.events) for e in _engines(sim)]
    decisions_exact = logs_real == logs_sim

    def _byid(res):
        return {o.request_id: (tuple(o.output_ids), o.finish_reason)
                for o in res["outputs"]}
    tokens_exact = _byid(res_real) == _byid(res_sim)

    denom = max(res_real["virtual_s"], 1e-12)
    timing_err = abs(res_sim["virtual_s"] - res_real["virtual_s"]) \
        / denom
    return {
        "decisions_exact": decisions_exact,
        "tokens_exact": tokens_exact,
        "timing_err": timing_err,
        "events_real": sum(len(lg) for lg in logs_real),
        "events_sim": sum(len(lg) for lg in logs_sim),
        "real": res_real,
        "sim": res_sim,
        "step_time_model": stm.to_dict(),
    }
