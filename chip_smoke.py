#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, decoding and training paths on
one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py ln_bwd_designs   # only the LayerNorm backward's
                                           # sizes against alternatives
    python3 chip_smoke.py lora_tier        # only the multi-LoRA and KV-tier
                                           # phases (no contract line)
    python3 chip_smoke.py fleet            # only the fleet and simulator
                                           # phases (no contract line)
    python3 chip_smoke.py tp               # only the tensor-parallel
                                           # phases (no contract line)
    python3 chip_smoke.py tooling          # only the analysis tools
                                           # (no contract line)
    python3 chip_smoke.py dispatch         # eager-path host time a step,
                                           # for comparing trees
    python3 chip_smoke.py eager            # only the eager Paddle API
                                           # phase (no contract line)

Run from the root of a checkout on a machine with a CUDA GPU and the
CUDA toolkit.  Phases, each printing its own lines; any failure raises
and the script exits non-zero:

1. device   — the card's name and power limit (nvidia-smi), TF32 off;
2. build    — every ``paddle_tpu_torch/csrc/*.cu`` with nvcc, all at
              once, with each kernel's register / shared-memory report;
3. kernels  — every kernel of ``ops/cuda/registry.py`` against its
              plain PyTorch version on the card (f32 and bf16, the CPU
              test cases and full-width shapes, forward and every
              gradient; ragged padding, dead rows and empty decode
              sequences must be exact zeros, the decode kernels' outputs
              and backward reductions bitwise repeatable; every kernel
              held to its plain version computed in f32 on the same
              values, see ``_parity``; the decode kernels also on the
              edges of their split-KV plan), then
              timed (CUDA-graph replay after a 64 MB read flushed the L2,
              queued behind a wait, see ``cold_l2``) against
              that plain version, against its bound (bytes at 3.35 TB/s or
              operations at the dense peak, whichever is larger) and,
              where one exists, against the one PyTorch call computing
              the same function (a backward that recomputes its forward,
              as the library calls and LayerNorm's plain version do, is
              timed as forward + backward less forward); then three of
              those calls timed repeatedly under the old and the new way
              of starting a replay cold (``timing_harness``);
4. exactness — a gpt_tiny-width 2-layer model in f32: the paged engine's
              greedy output must equal greedy decoding with the dense
              forward token for token, with the kernel launched on every
              layer of every step; the int8 engine's greedy tokens must
              be the argmax of the dense forward with the same int8
              weights and K/V round trip (``quality.engine_logits``),
              with the int8 kernel on every layer of every step; and
              FusedMultiTransformer's greedy output must equal both, with
              the decode kernel on every layer of every decode step; the
              steps run as CUDA-graph replays (each bucket or batch
              size captured at its first step); then speculation and
              lookahead on the same model (``spec_exactness``): n-gram,
              draft-model, tree, a full-copy draft (acceptance 1.0),
              lookahead and lookahead with n-gram, each token-exact
              against the plain engine and the dense forward, with B1
              launched L x target + draft_layers x draft launches;
5. train exactness — three AdamW TrainSteps of a 2-layer, hidden-128
              model in f32 on the card against the same steps on the
              port's CPU path, with the flash-attention and LayerNorm
              kernels launched on every layer of every step; then the
              same model in O2 bf16 on the card, with the bf16 flash
              kernels against attention through the f32 plain versions;
   graphs   — the captured steps at GPT-124M width (bf16): for the bf16
              and int8 engines, every token bucket captured as ``warmup``
              captures it, then a packed step with padding that mixes a
              prefill chunk with decode rows, replayed against the eager
              step body from the same pools (argmax, logits and pools
              bitwise equal), with each capture's ms and the shared
              pool's bytes; FusedMultiTransformer at batch 8 likewise at
              three decode offsets;
6. serving  — GPT-124M (random weights from a seed, bf16) behind the
              engine at block_size 16, max_batch 8, token_budget 256,
              prefix caching on: warmup, then 16 requests (8 sharing a
              256-token prefix, 64 new tokens each, 2 of them sampled);
              every request must finish by length with 64 tokens, the
              burst must capture no graph after ``warmup`` and replay
              every step, and the kernel's launch count must equal
              num_layers x the engine's launches; then a window of
              batch-8 decode steps, wall time per step against device
              time under torch.profiler, and the host's share of a step
              split into schedule, pack, copy + replay, the argmax pull
              and commit;
   front end — the same model and engine settings behind
              ``HttpLLMServer`` -> ``AsyncLLMEngine`` on 127.0.0.1: a
              burst over the whole request surface from a client thread
              per request (greedy streamed over SSE, sampling, filters,
              logprobs, a stop string, a grammar, n=2, an expiring
              deadline), an abort, bad requests (400, nothing admitted),
              greedy prompts one at a time token-equal to ``generate``,
              a profiled window of the worker's replayed decode steps,
              the cost of a grammar row a step; every finish reason as
              expected, no page leaked, no capture after ``warmup``; an
              engine captured by the worker thread; a fault schedule
              (one transient retried, one raise quarantining its victim)
              with token-equal survivors (``front_end_phase``);
   speculative — the same model and settings on a burst of 16 tiled
              prompts (64-512 tokens, 64 new tokens each): plain, n-gram
              K = 4, a draft model of 2 layers, lookahead; tokens/s,
              TTFT and TPOT, acceptance, no capture after ``warmup``, no
              page leaked, speculative divergences only at near-ties
              (the teacher-forced verify-vs-decode max |Δlogit| bounds
              them); plain and lookahead decode windows in turns with
              the host split; the n-gram engine behind
              ``HttpLLMServer`` (``speculative_phase``);
7. int8 serving — the same model and burst with ``quantize="int8"``
              on the int8 kernel; its resident bytes must be the memory
              model's weights + pool within 1%, the bf16 engine's
              weights + 2.5 sequences as ``memory_budget`` must admit at
              least twice the bf16 batch, ``quality_report`` against the
              bf16 engine must be finite; then its decode window;
   multi-LoRA and the KV tier — ``lora_exactness`` (the exactness
              model, three adapters over two usable slots on a batch
              mixing base and adapter rows: tokens equal to the dense
              forward with merged weights ``W + A @ B``, plain, lookahead
              and n-gram K = 4 alike, B1 on every layer of every launch;
              after an adapter load that evicts, a packed step replayed
              bitwise equal to the eager body); ``tier_exactness`` (the
              exactness model starved to 12 pages under
              ``policy="always"``: tokens bitwise those of a 64-page
              engine, chains demoted and swapped in, the invariants after
              every step; f32 and int8 pools); ``lora_serving`` (GPT-124M
              bf16, rank 8, four slots, six adapters: the serving burst
              with 12 adapter requests beside the plain engine, no
              capture after ``warmup``, pool bytes equal to the memory
              model's, one adapter load's ms, decode windows' device ms
              with and without adapters, an adapter request and an
              unknown adapter through ``HttpLLMServer``, the int8 engine's
              burst with the same adapters); ``kv_tier`` (pinned
              host<->device copy rates, then the burst on an engine
              starved to 96 pages under ``"always"`` and ``"never"``:
              tokens/s, chains moved, bytes, ms a demote and a swap-in,
              no page or chain left; ``"auto"``'s choice under the
              ``"h100"`` profile);
   the fleet and the simulator — ``fleet_exactness`` (two replicas of
              the exactness model on the card, each scenario bitwise
              against one engine, every replica captured as the fleet
              builds it and nothing after: a kill and failover, a
              drain migrating running chains in f32 and int8,
              ``disaggregate=True`` with prefix caching and n-gram
              speculation, ``parallel_step``
              under a seeded kill schedule with the serial run's event
              log); ``fleet`` (two GPT-124M bf16 replicas at the serving
              settings: device bytes a replica against pools + graph
              pool (+ weights unless shared), capture ms, the burst
              through the router against one engine with first
              divergences and their top-2 gaps, a drain's handoffs beside
              ``migration_estimate`` and ``"auto"``'s choice, a kill and
              restart giving the dead replica's memory back,
              ``parallel_step`` with the serial fleet's events);
              ``fleet_int8`` (the same with int8 pools and scales, B5);
              ``fleet_front_end`` (``HttpLLMServer(fleet=...)``, the
              front end's burst at once); ``fleet_disagg`` (the burst
              disaggregated: handoffs, ms each, TTFT against unified);
              ``sim`` (``calibrate`` with the real leg on the card,
              decision- and token-exact; the ``"h100"`` StepTimeModel
              against replayed steps; a pure 8-replica simulation's
              wall time);
   tensor parallelism — two ranks on the one card (``mesh=["cuda:0",
              "cuda:0"]``: a worker process, gloo all-reduces through the
              host): ``tp_exactness`` (the exactness model, token for
              token against a tp=1 engine through prefix-cache hits,
              preemption, LoRA with an eviction and lookahead, then int8
              pools (B5) with draft-model and n-gram drafting; on each
              rank B1 or B5 on every layer of every launch; a
              ``tensor_parallel=`` past the visible devices refused);
              ``tp_serving`` (GPT-124M bf16 at the serving settings: the
              burst against the tp=1 engine, tokens/s, TTFT, first greedy
              divergences with their top-2 gaps, each rank's device bytes
              against the memory model, wall ms a decode step with the
              host's broadcast and all-reduce ms, one greedy request
              through ``HttpLLMServer``, the ``mp`` backend);
8. dense decode — FusedMultiTransformer over GPT-124M in bf16 (batch 8,
              128-token prompts, 64 new tokens) and Llama-160M in f32
              (batch 8, 32 prompt tokens through ``decode_step`` into a
              2048-slot cache, then 32 greedy tokens, every logit within
              rtol 2e-3 / atol 2e-4 of the dense forward), each with the
              decode kernel on every layer of every decode step, ms per
              step and the kernel's share of a profiled window;
9. training — GPT-124M in O2 bf16 with AdamW and global-norm clipping
              on one 8 x 1024 batch: 3 warm-up and 10 timed steps (ms
              per step, tokens/s, MFU, peak memory), one step under
              torch.profiler; the loss must fall and every attention
              and LayerNorm of every timed step launch its kernels;
10. tooling — the analysis tools over GPT-124M bf16 at the serving
              settings (``tooling_phase``): the serving burst inside
              ``warmup()``'s CaptureWatcher, ``analyze_engine`` with
              zero findings (D001 after the burst), the census under
              ``"h100"`` per bucket beside replayed steps at buckets 8
              and 256 (an estimate above its measurement raises), and
              the Hopper kernel lint over the bf16 and int8 engines,
              FMT, Llama and training shapes: zero findings, and each
              instance's launch as the card reports it (the sources'
              ``*_info`` entries) equal to its plan, with registers,
              spills, shared bytes and blocks an SM
              (``kernel_resources``);
11. eager_api — BERT-base pretraining written with the port's Paddle
              API (``Tensor``, ``nn.Layer``, ``loss.backward()``,
              ``opt.step()``) in f32 at 8 x 512 with padded rows and a
              mask (``eager_api_phase``): one step's loss and gradients
              with the kernels against every kernel replaced by its
              plain version, 3 warm-up and 10 timed AdamW steps (wall
              and device ms, busy share, tokens/s, FLOPs over the f32
              peak, peak memory, op calls a step and their host µs, B4a
              and B4b once per LayerNorm a step), the eval forward over
              unpadded rows without a mask (B2 once a layer, logits
              against the plain forward), and a ``save``/``load``
              round trip into a fresh model, logits bitwise.
12. vision — ViT-B/16 and ResNet-50 trained through ``paddle.Model``
              over a 4-worker ``DataLoader`` under ``amp.auto_cast()``
              (O1 bf16) (``vision_phase``; ``python3 chip_smoke.py
              vision`` runs it alone): B2/B3/B4a/B4b at ViT's shapes
              against their plain versions and timed, one O1 step with
              the kernels against the plain-version step, the ViT fit
              (3 + 10 steps; B2, B3, B4a, B4b 12, 12, 25, 25 a step),
              the ResNet-50 fit (3 + 5 steps, BatchNorm statistics),
              ``evaluate`` with ``Accuracy``, ``predict`` and a
              ``save``/``load`` round trip, logits bitwise.

The launches in the ``kernels`` line are those of each kernel's main
path, each run with the counts at 0 just before and read just after:
the bf16 serving burst, the front end's server run, the speculation
phases' runs, the multi-LoRA and KV-tier phases' runs, the fleet and
simulator phases' runs and the tensor-parallel phases' runs on every
rank (summed) for ragged attention, the int8 burst, the int8 LoRA
burst, the int8 tier run, the int8 fleet runs and the int8
tensor-parallel run on every rank (summed) for its int8 twin, the FMT and Llama decode runs (summed) for the decode
kernel, the timed training steps for the others, to which the eager
BERT-base timed steps add B4a's and B4b's launches and its eval forward
B2's and B4a's, and the ViT-B/16 fit B2's, B3's, B4a's and B4b's.  The second-to-last
line is that JSON record; the last line is ``{"ok": true, "device":
{...}}``.  The script imports only torch, numpy and the port.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM HBM3
PEAK_FLOPS = {"torch.bfloat16": 989e12,        # dense tensor-core bf16
              "torch.float32": 67e12}          # f32 outside the tensor cores


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ------------------------------------------------------------- timing --
# ~0.1 ms of device time at the H100's clocks: longer than the host takes
# to record an event and submit a graph replay
WAIT_CYCLES = 200_000


def cold_l2(flush):
    """Make the next call start cold and be timed from its start: read
    ``flush`` (64 MB, more than the H100's 50 MB L2) so the L2 holds
    none of the call's data and no dirty lines, then hold the stream
    busy for about 0.1 ms, so the call is queued behind the flush and a
    start event recorded now fires when the call can run, not when the
    host gets to submit it."""
    import torch

    torch.amax(flush)
    torch.cuda._sleep(WAIT_CYCLES)


def _graph(fn):
    """``fn`` captured in a CUDA graph, after three warm-up calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def _replay_ms(graph, before, reps):
    """Median ms of ``reps`` replays of ``graph``, each after
    ``before()`` and timed alone with CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_ms(fn, flush, reps=30):
    """Median device ms of one call of ``fn``: the call is captured in a
    CUDA graph, and each replay is timed alone with CUDA events after
    :func:`cold_l2` (a layer's pool is cold when the engine reaches it
    again).  The graph takes the host's launch overhead out of the
    reading; :func:`call_ms` keeps it in."""
    return _replay_ms(_graph(fn), lambda: cold_l2(flush), reps)


def call_ms(fn, reps=30):
    """Host-clock ms per call of ``fn`` back to back, launch overhead
    included (what one eager caller pays)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def device_us(fn, flush, names, calls=20):
    """Mean device µs per call of the kernels whose names hold one of
    ``names`` that ``fn`` launches, each call after an L2 flush, from
    torch.profiler: their own device time, without the launch gaps a
    graph replay's reading holds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            cold_l2(flush)
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and any(n in e.key for n in names)) / calls


def split_device_us(fn, flush):
    """:func:`device_us` of the split-KV decode kernels: a split kernel
    and its combine."""
    return device_us(fn, flush, ("split_kernel", "combine"))


# -------------------------------------------- ragged paged attention --
def _ragged_case(dev, dtype, nb, bs, nq, nkv, d, t, bt, rs, rq, rp,
                 seed, uniform=False):
    import torch

    rng = np.random.RandomState(seed)
    draw = rng.rand if uniform else rng.randn
    kp = draw(nb, bs, nkv, d).astype(np.float32)
    vp = draw(nb, bs, nkv, d).astype(np.float32)
    q = draw(t, nq, d).astype(np.float32)
    if bt is None:
        bt = rng.randint(0, nb, size=(t, 3))

    def put(a, dt):
        return torch.as_tensor(np.asarray(a), device=dev).to(dt)

    return (put(q, dtype), put(kp, dtype), put(vp, dtype),
            put(bt, torch.int32), put(rs, torch.int32),
            put(rq, torch.int32), put(rp, torch.int32))


# the CPU test battery (tests/test_torch_ragged_attention.py), f32:
# (NB, BS, NQ, NKV, D, T, pool seed, block tables, start, qlen, pos0)
_CPU_CASES = [
    (6, 8, 4, 2, 16, 16, 30, [[5, 2, 0], [4, 1, 3], [0, 3, 5], [2, 2, 2]],
     [0, 1, 7, 0], [1, 6, 3, 0], [9, 5, 3, 0]),
    (6, 8, 4, 2, 16, 8, 32, None, list(range(8)), [0] + [1] * 7,
     [0, 12, 23, 4, 0, 7, 15, 8]),
    (6, 8, 4, 2, 16, 8, 40, [[3, 1, 4, 0]], [0], [8], [5]),
    (6, 8, 4, 2, 16, 16, 50, [[5, 2, 0], [4, 1, 3], [0, 3, 5], [2, 2, 2]],
     [0, 4, 8, 12], [4, 2, 0, 3], [8, 12, 0, 4]),
    (6, 8, 8, 2, 16, 8, 60, [[1, 4, 2], [3, 0, 5]], [0, 3], [3, 5],
     [6, 0]),
]


def _full_width_tables(seed, rows=8, pages=64, nb=512):
    return np.random.RandomState(seed).permutation(nb)[:rows * pages] \
        .reshape(rows, pages)


def _bound(entry, *args):
    """Least time for this call of ``entry``'s kernel, from its registry
    cost rule (``entry.cost``: each input byte read once, each output
    byte written once, and the operations on these inputs' values) ->
    (ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the operations over its peak for the inputs'
    dtype."""
    cost = entry.cost(*args)
    t_bytes = cost["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = cost["flops"] / PEAK_FLOPS[str(args[0].dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _ragged_scratch_bytes(q, kp, bt):
    """Bytes of the partials' scratch a ragged call allocates: (D + 2)
    f32 a (slot, query head, split)."""
    from paddle_tpu_torch.ops.cuda import split_kv

    t, nq, d = q.shape
    r, p = bt.shape
    splits = split_kv.plan(p * kp.shape[1])
    slots = split_kv.ragged_slots(t, r, nq, kp.shape[2], splits, d)
    return 4 * slots * nq * splits * (d + 2)


def _long_prefill_case(dev, dtype):
    """A 500-token prefill chunk beside a deep decode row and a verify
    row, 32 query heads on 8 kv heads at D 128, T 512: token-indexed
    partials would pass ``split_kv.TOKEN_SCRATCH_BYTES``, so only each
    row's last tile splits and the full tiles are walked whole."""
    return _ragged_case(dev, dtype, 512, 16, 32, 8, 128, 512,
                        _full_width_tables(10)[:4], [0, 1, 501, 508],
                        [1, 500, 7, 0], [900, 20, 300, 0], seed=11)


def _live_tokens(t, row_start, row_qlen, dev):
    import torch

    live = torch.zeros(t, dtype=torch.bool, device=dev)
    for s, n in zip(row_start.tolist(), row_qlen.tolist()):
        live[s:s + n] = True
    return live


def _split_edge_rows(chunk, pages=64, bs=16):
    """Ragged decode rows on the split edges of ``chunk``-key splits over
    tables of ``pages`` x ``bs`` keys: contexts exactly at a chunk
    boundary, one key past it and 1; a context ending inside the last
    split; and a one-key row beside the deepest one (every split past
    its first is empty).  Returns (row_start, row_qlen, row_pos0) of
    one-token rows, contexts = pos0 + 1."""
    top = pages * bs
    ctx = [chunk, chunk + 1, 1, top - chunk // 2, 2 * chunk, top, 1,
           3 * chunk + 1]
    return list(range(len(ctx))), [1] * len(ctx), [c - 1 for c in ctx]


def _verify_rows(depths, k=4, t=64):
    """Speculative verify rows as the engine packs them: row ``r`` holds
    1 + ``k`` tokens at positions ``depths[r] ..``, back to back, padded to
    ``t`` tokens -> (row_start, row_qlen, row_pos0)."""
    n = len(depths)
    return ([r * (k + 1) for r in range(n)], [k + 1] * n, list(depths))


def _as_one_token_rows(args, k=4):
    """The same query tokens and positions as ``_verify_rows``' rows, each
    its own one-token row on a copy of its sequence's block-table row."""
    import torch

    q, kp, vp, bt, rs, rq, rp = args
    n = len(rs)
    rows = torch.arange(n * (k + 1), device=q.device, dtype=torch.int32)
    seq = rows // (k + 1)
    pos = rp[seq.long()] + rows % (k + 1)
    return (q, kp, vp, bt[seq.long()].contiguous(), rows,
            torch.ones_like(rows), pos.to(torch.int32))


def ragged_attention_phase(entry, dev):
    """B1 against its plain version on the card, f32 and bf16, held to
    ``_parity`` (the plain version in f32 on the same values), padding
    and dead rows exact zeros, every output bitwise repeatable over two
    calls; then timed at the GPT-124M shapes.  Returns the ``kernels``
    record."""
    import torch

    from paddle_tpu_torch.ops.cuda import split_kv

    def check(label, args):
        got = entry.kernel(*args)
        again = entry.kernel(*args)
        torch.cuda.synchronize()
        q, kp, vp = args[:3]
        want = entry.plain(q.float(), kp.float(), vp.float(), *args[3:])
        report = {"out": _parity(got, want, 1e-4)}
        live = _live_tokens(q.shape[0], args[4], args[5], dev)
        pad_zero = bool((got[~live] == 0).all())
        repeat = torch.equal(got, again)
        _say_parity(entry.name, label, got.dtype, report,
                    padding_exact_zero=pad_zero, bitwise_repeatable=repeat)
        if not (report["out"][3] and pad_zero and repeat):
            raise RuntimeError(f"{entry.name} {label}: {report}, padding "
                               f"zero {pad_zero}, repeatable {repeat}")
        return report["out"][0]

    f32, bf16 = torch.float32, torch.bfloat16
    # (a) the five CPU-test cases, f32
    for i, (nb, bs, nq, nkv, d, t, seed, bt, rs, rq, rp) in \
            enumerate(_CPU_CASES):
        check(f"cpu_case_{i}", _ragged_case(
            dev, f32, nb, bs, nq, nkv, d, t, bt, rs, rq, rp,
            seed, uniform=True))
    # (b) GPT-124M geometry, bf16: a decode row at position 900, a
    # 200-token chunk straddling pages, a 4-token verify-like row, dead
    # rows and 51 padding tokens
    bt = _full_width_tables(1)
    mixed = _ragged_case(dev, bf16, 512, 16, 12, 12, 64, 256, bt,
                         [0, 1, 201, 205, 205, 205, 205, 205],
                         [1, 200, 4, 0, 0, 0, 0, 0],
                         [900, 37, 500, 0, 0, 0, 0, 0], seed=2)
    err_mixed = check("gpt124m_mixed_T256", mixed)
    # decode-heavy: eight one-token rows deep in their contexts (T = 8)
    pos = np.random.RandomState(3).randint(600, 1000, size=8)
    decode = _ragged_case(dev, bf16, 512, 16, 12, 12, 64, 8,
                          _full_width_tables(4), list(range(8)), [1] * 8,
                          pos, seed=5)
    err_decode = check("gpt124m_decode_T8", decode)
    # a tensor-parallel rank's shard of the same step (tp = 2: 6 of the
    # 12 heads on its own pool shard), the shape tp_serving launches
    shard = _ragged_case(dev, bf16, 512, 16, 6, 6, 64, 8,
                         _full_width_tables(4), list(range(8)), [1] * 8,
                         pos, seed=5)
    check("gpt124m_tp2_shard_decode_T8", shard)
    # the bf16 burst's decode contexts (the engine's main path)
    pos = np.random.RandomState(13).randint(130, 191, size=8)
    burst = _ragged_case(dev, bf16, 512, 16, 12, 12, 64, 8,
                         _full_width_tables(14), list(range(8)), [1] * 8,
                         pos, seed=15)
    check("gpt124m_burst_decode_T8", burst)
    # speculative verify rows: 8 rows of 1 + 4 tokens at depths 130-190
    # (T 64 with the bucket's 24 padding tokens), f32 and bf16, and
    # whether each output is bitwise the same positions run as one-token
    # rows (the form of a plain decode step)
    depths = np.random.RandomState(21).randint(130, 191, size=8)
    verify = {}
    for dtype in (f32, bf16):
        args = _ragged_case(dev, dtype, 512, 16, 12, 12, 64, 64,
                            _full_width_tables(22), *_verify_rows(depths),
                            seed=23)
        check(f"gpt124m_verify_T64_{str(dtype)[6:]}", args)
        got = entry.kernel(*args)[:40]
        flat = entry.kernel(*_as_one_token_rows(args))[:40]
        torch.cuda.synchronize()
        say("ragged_verify_vs_one_token_rows", dtype=str(dtype),
            bitwise=torch.equal(got, flat),
            max_abs_diff=float((got.float() - flat.float()).abs().max()))
        verify[dtype] = args
    # the draft model's chain: eight one-token rows at the speculative
    # burst's depths (64-512-token prompts plus up to 64 new tokens)
    pos = np.random.RandomState(24).randint(64, 577, size=8)
    chain = _ragged_case(dev, bf16, 512, 16, 12, 12, 64, 8,
                         _full_width_tables(25), list(range(8)), [1] * 8,
                         pos, seed=26)
    check("gpt124m_draft_chain_T8", chain)
    # (c) the split's edges, f32 and bf16
    edges = _split_edge_rows(split_kv.CHUNK)
    for dtype in (f32, bf16):
        check(f"split_edges_{str(dtype)[6:]}", _ragged_case(
            dev, dtype, 512, 16, 12, 12, 64, 8, _full_width_tables(16),
            *edges, seed=17))
    # (d) GQA 4: 32 query heads on 8 kv heads, head_dim 128
    gqa = _ragged_case(dev, bf16, 512, 16, 32, 8, 128, 64,
                       _full_width_tables(6)[:4],
                       [0, 1, 41, 41], [1, 40, 7, 0], [700, 90, 15, 0],
                       seed=7)
    check("gqa4_d128", gqa)
    check("long_prefill_row_slots", _long_prefill_case(dev, bf16))
    # a page size and token count off every power of two, f32
    odd = _ragged_case(dev, f32, 512, 5, 12, 12, 64, 13,
                       _full_width_tables(8, pages=64)[:2],
                       [0, 1], [1, 12], [222, 3], seed=9)
    check("bs5_T13_f32", odd)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timings = {}
    for label, args in (("decode_T8", decode), ("mixed_T256", mixed),
                        ("tp2_shard_decode_T8 6/6 heads depths 600-1000",
                         shard),
                        ("burst_decode_T8 depths 130-190", burst),
                        ("verify_T64 8x(1+4) depths 130-190", verify[bf16]),
                        ("draft_chain_T8 depths 64-576", chain)):
        ms = time_ms(lambda: entry.kernel(*args), flush)
        plain_ms = time_ms(lambda: entry.plain(*args), flush)
        q, kp, _vp, bt, rs, rq, rp = args
        bound_ms, bound_by = _bound(entry, *args)
        timings[label] = (ms, plain_ms, bound_ms, bound_by)
        say("kernel_time", kernel=entry.name, shape=label, kernel_ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None,
            device_us=split_device_us(lambda: entry.kernel(*args), flush),
            call_ms=call_ms(lambda: entry.kernel(*args)),
            plain_call_ms=call_ms(lambda: entry.plain(*args)),
            scratch_bytes=_ragged_scratch_bytes(q, kp, bt))
    ms, plain_ms, bound_ms, bound_by = timings["mixed_T256"]
    return {"name": entry.name, "route": "cuda", "source": entry.source,
            "replaces": entry.replaces, "launches": None,
            "max_abs_err": max(err_mixed, err_decode), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call computes ragged paged attention
            "library_ms": None}


# ---------------------------------------------------- flash attention --
BF16_RTOL, BF16_RMS_TOL = 1e-2, 1e-3


def _parity(got, want, f32_tol):
    """A kernel output against its plain version, which the phases
    compute in f32 on the same input values.  An f32 output must lie
    within ``f32_tol * max(1, max|want|)`` (summation order); a bf16
    output, every element within ``1e-2 |want| + 1e-3 rms(want)`` (its
    own rounding is 2^-9 relative; the kernels compute in f32).  Returns
    (max |err|, ||err|| / ||want||, the largest err / limit, ok).  Where
    the limit is 0 (a plain output that is identically zero, as dq and
    dk are for a single key) the ratio is 0 for an exact zero and
    infinite otherwise, so ``ok`` is still ``err <= limit``."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    if got.dtype == torch.bfloat16:
        limit = BF16_RTOL * w.abs() + BF16_RMS_TOL * w.pow(2).mean().sqrt()
    else:
        limit = f32_tol * max(1.0, float(w.abs().max()))
    ratio = torch.where(err == 0, torch.zeros_like(err), err / limit)
    over = float(ratio.max())
    norm = float(w.norm())
    rel = (float(err.norm()) / norm if norm
           else float("inf") if float(err.norm()) else 0.0)
    return (float(err.max()), rel, over,
            over <= 1.0 and bool(torch.isfinite(got).all()))


def _say_parity(kernel, label, dtype, report, **extra):
    say("kernel_parity", kernel=kernel, case=label, dtype=str(dtype),
        max_abs_err={n: r[0] for n, r in report.items()},
        rel_l2_err={n: r[1] for n, r in report.items()},
        err_over_limit={n: r[2] for n, r in report.items()}, **extra)


def _flash_inputs(dev, dtype, b, s, n, d, seed, packed=False, sk=None):
    """q [B, S, N, D], k and v [B, Sk, N, D] (Sk = ``sk`` or S) and a dO,
    seeded; ``packed`` gives q, k, v as the strided views of one
    [B, S, 3, N, D] projection, the layout GPT hands the kernel."""
    import torch

    rng = np.random.RandomState(seed)

    def put(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device=dev).to(dtype)

    if packed:
        q, k, v = put(b, s, 3, n, d).unbind(dim=2)
    else:
        sk = s if sk is None else sk
        q, k, v = put(b, s, n, d), put(b, sk, n, d), put(b, sk, n, d)
    return q, k, v, put(b, s, n, d)


def flash_attention_phase(entries, dev):
    """B2 and B3 (forward kernel; dq + dk/dv pair) against their plain
    versions on the card, f32 (SIMT kernels) and bf16 (tensor-core
    kernels), forward and every gradient, on the CPU test shapes,
    GPT-124M's, and the shapes only the bf16 tiling can get wrong (head
    dims padded to the tile, seq_q != seq_k, one row, one row past a
    tile, D 128); SDPA's forward against the same plain version as an
    informational ``library_parity`` line.  Then timed at GPT-124M's
    training shape against the bound, the plain versions and PyTorch's
    ``scaled_dot_product_attention`` (a yardstick only)."""
    import torch

    fwd = entries["flash_attention_fwd"]
    bwd = entries["flash_attention_bwd"]
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [   # label, dtype, (B, S, N, D), causal, packed[, seq_k]
        ("cpu_2x128x2x64", f32, (2, 128, 2, 64), False, False),
        ("cpu_2x128x2x64_causal", f32, (2, 128, 2, 64), True, False),
        ("cpu_1x256x4x32", f32, (1, 256, 4, 32), False, False),
        ("cpu_1x256x4x32_causal", f32, (1, 256, 4, 32), True, False),
        ("cpu_grads_1x128x2x32", f32, (1, 128, 2, 32), False, False),
        ("cpu_grads_1x128x2x32_causal", f32, (1, 128, 2, 32), True, False),
        ("cpu_uneven_1x192x2x32_causal", f32, (1, 192, 2, 32), True, False),
        ("cpu_bf16_1x128x2x64_causal", bf16, (1, 128, 2, 64), True, False),
        ("gpt124m_8x1024x12x64_causal", bf16, (8, 1024, 12, 64), True, True),
        ("gpt124m_f32_2x1024x12x64_causal", f32, (2, 1024, 12, 64), True,
         True),
        ("noncausal_2x512x12x64", bf16, (2, 512, 12, 64), False, False),
        ("tail_2x1000x12x64_causal", bf16, (2, 1000, 12, 64), True, False),
        ("tail_f32_1x1000x4x64_causal", f32, (1, 1000, 4, 64), True, False),
        ("d128_1x300x2x128_causal", bf16, (1, 300, 2, 128), True, False),
        # head dims the bf16 kernels pad to 32 or 64, with a tail
        ("d8_1x200x2x8_causal", bf16, (1, 200, 2, 8), True, False),
        ("d24_1x200x2x24_causal", bf16, (1, 200, 2, 24), True, False),
        ("d40_1x200x2x40_causal", bf16, (1, 200, 2, 40), True, False),
        ("noncausal_2x77q_333k_x4x64", bf16, (2, 77, 4, 64), False, False,
         333),
        ("noncausal_f32_2x77q_333k_x4x64", f32, (2, 77, 4, 64), False,
         False, 333),
        ("one_row_1x1x2x64_causal", bf16, (1, 1, 2, 64), True, False),
        ("tile_plus_one_1x65x2x64_causal", bf16, (1, 65, 2, 64), True,
         False),
        ("d128_2x1024x12x128_causal", bf16, (2, 1024, 12, 128), True, True),
        ("bert_f32_8x512x12x64", f32, (8, 512, 12, 64), False, False),
    ]

    def check(label, dtype, q, k, v, dout, causal, packed, scale):
        """Kernels against the plain versions; returns the report and
        the plain forward's output."""
        out, lse = fwd.kernel(q, k, v, causal, scale)
        grads = bwd.kernel(q, k, v, out, lse, dout, causal, scale)
        again = bwd.kernel(q, k, v, out, lse, dout, causal, scale)
        torch.cuda.synchronize()
        # the plain versions in f32 on the same values, so a bf16 case is
        # held to its inputs' exact function, not to a composition that
        # rounds its probabilities to bf16; the backward's inputs include
        # the forward kernel's out and lse, as the backward kernel's do
        q32, k32, v32, do32 = (x.float() for x in (q, k, v, dout))
        want_out, want_lse = fwd.plain(q32, k32, v32, causal, scale)
        want_grads = bwd.plain(q32, k32, v32, out.float(), lse, do32,
                               causal, scale)
        pairs = {"out": (out, want_out, 1e-4), "lse": (lse, want_lse, 1e-4)}
        pairs.update({f"d{n}": (g, w, 5e-4)
                      for n, g, w in zip("qkv", grads, want_grads)})
        report = {name: _parity(*p) for name, p in pairs.items()}
        deterministic = all(torch.equal(a, b) for a, b in zip(grads, again))
        _say_parity("flash_attention", label, dtype, report, causal=causal,
                    strided_qkv=packed, seq_k=k.shape[1],
                    backward_bitwise_repeatable=deterministic)
        if not (all(r[3] for r in report.values()) and deterministic):
            raise RuntimeError(f"flash attention {label}: {report}, "
                               f"repeatable {deterministic}")
        return report, want_out

    main_err = {}
    for i, (label, dtype, shape, causal, packed, *sk) in enumerate(cases):
        q, k, v, dout = _flash_inputs(dev, dtype, *shape, seed=40 + i,
                                      packed=packed, sk=sk[0] if sk else None)
        scale = 1.0 / float(np.sqrt(shape[-1]))
        report, want_out = check(label, dtype, q, k, v, dout, causal, packed,
                                 scale)
        if label.startswith("gpt124m_8x"):
            main_err["fwd"] = max(report["out"][0], report["lse"][0])
            main_err["bwd"] = max(report[n][0] for n in ("dq", "dk", "dv"))
            # not a gate: SDPA rounds P to bf16 before P V
            got = torch.nn.functional.scaled_dot_product_attention(
                *(x.transpose(1, 2) for x in (q, k, v)), is_causal=True)
            lib = _parity(got.transpose(1, 2), want_out, 1e-4)
            say("library_parity", library="F.scaled_dot_product_attention",
                case=label, dtype=str(dtype), max_abs_err=lib[0],
                rel_l2_err=lib[1], err_over_limit=lib[2], gate=False)

    # timing at GPT-124M's training shape: causal, bf16, strided qkv views
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    q, k, v, dout = _flash_inputs(dev, bf16, 8, 1024, 12, 64, seed=99,
                                  packed=True)
    scale = 0.125
    out, lse = fwd.kernel(q, k, v, True, scale)
    ms_f = time_ms(lambda: fwd.kernel(q, k, v, True, scale), flush)
    ms_b = time_ms(lambda: bwd.kernel(q, k, v, out, lse, dout, True, scale),
                   flush)
    plain_f = time_ms(lambda: fwd.plain(q, k, v, True, scale), flush)
    plain_b = time_ms(lambda: bwd.plain(q, k, v, out, lse, dout, True,
                                        scale), flush)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dt = dout.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)

    lib_f = time_ms(sdpa, flush)
    lib_fb = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dt),
                     flush)
    records = []
    for entry, ms, plain_ms, lib, backward, err in (
            (fwd, ms_f, plain_f, lib_f, False, main_err["fwd"]),
            (bwd, ms_b, plain_b, lib_fb - lib_f, True, main_err["bwd"])):
        bound_ms, bound_by = _bound(
            entry, *((q, k, v, True, scale) if not backward
                     else (q, k, v, out, lse, dout, True, scale)))
        say("kernel_time", kernel=entry.name, shape="8x1024x12x64 bf16 "
            "causal, strided qkv", kernel_ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
            library="F.scaled_dot_product_attention" + (
                " backward (forward+backward minus forward)" if backward
                else ""))
        records.append({"name": entry.name, "route": "cuda",
                        "source": entry.source, "replaces": entry.replaces,
                        "launches": None, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": lib})
    # B2 at the eager BERT-base eval forward's shape: f32, non-causal
    q, k, v, _ = _flash_inputs(dev, torch.float32, 8, 512, 12, 64, seed=97)
    ms = time_ms(lambda: fwd.kernel(q, k, v, False, scale), flush)
    plain_ms = time_ms(lambda: fwd.plain(q, k, v, False, scale), flush)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in (q, k, v))), flush)
    bound_ms, bound_by = _bound(fwd, q, k, v, False, scale)
    say("kernel_time", kernel=fwd.name, shape="8x512x12x64 f32 non-causal "
        "(BERT-base eager eval)", kernel_ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
        library="F.scaled_dot_product_attention")
    return records


# ---------------------------------------------------------- layernorm --
def _ln_inputs(dev, dtype, rows, c, seed):
    import torch

    rng = np.random.RandomState(seed)

    def put(a):
        return torch.as_tensor(a.astype(np.float32), device=dev).to(dtype)

    return (put(rng.randn(rows, c) * 2 + 0.5), put(1 + 0.1 * rng.randn(c)),
            put(0.1 * rng.randn(c)), put(rng.randn(rows, c)))


# the backward's two kernels: the one-wave row pass and the partials' sum
LN_BWD_KERNELS = ("ln_bwd_kernel", "ln_reduce_kernel")


def layernorm_phase(entries, dev):
    """B4 (forward kernel; backward row pass + partials reduction)
    against its plain versions on the card, f32 and bf16, y / mu / rstd
    and dx / dgamma / dbeta, on the CPU test shape and GPT-124M's
    (8192 x 768, 8190 rows that no block divides, 5 rows, fewer than
    the backward's blocks, and a tall 32768), with dgamma/dbeta bitwise
    equal over two eager calls and over an eager call and a CUDA-graph
    replay; the backward's registers, spills, residency and plan; then
    timed at 8192 x 768 bf16 against the bound, the plain versions and
    ``torch.nn.functional.layer_norm`` (a yardstick only)."""
    import torch

    from paddle_tpu_torch.ops.cuda import layernorm_kernel as lnk

    fwd = entries["layernorm_fwd"]
    bwd = entries["layernorm_bwd"]
    f32, bf16 = torch.float32, torch.bfloat16
    eps = 1e-5
    cases = [("cpu_256x128", f32, 256, 128), ("gpt124m_8192x768", bf16,
                                              8192, 768),
             ("gpt124m_f32_8192x768", f32, 8192, 768),
             ("ragged_rows_8190x768", bf16, 8190, 768),
             ("few_rows_5x768", bf16, 5, 768),
             ("tall_32768x768", bf16, 32768, 768),
             ("c2048_1000x2048", bf16, 1000, 2048),
             ("bert_f32_4096x768", f32, 4096, 768)]
    main_err = {}
    for i, (label, dtype, rows, c) in enumerate(cases):
        x, g, b, dy = _ln_inputs(dev, dtype, rows, c, seed=70 + i)
        y, mu, rstd = fwd.kernel(x, g, b, eps)
        dx, dg, db = bwd.kernel(x, g, mu, rstd, dy)
        _, dg2, db2 = bwd.kernel(x, g, mu, rstd, dy)
        torch.cuda.synchronize()
        # the plain versions in f32 on the same values (see _parity)
        x32, g32, b32, dy32 = (t.float() for t in (x, g, b, dy))
        wy, wmu, wrstd = fwd.plain(x32, g32, b32, eps)
        wdx, wdg, wdb = bwd.plain(x32, g32, wmu, wrstd, dy32, eps)
        report = {name: _parity(got, want, f32_tol)
                  for name, got, want, f32_tol in (
                      ("y", y, wy, 1e-5), ("mu", mu, wmu, 1e-5),
                      ("rstd", rstd, wrstd, 1e-5), ("dx", dx, wdx, 1e-4),
                      ("dgamma", dg, wdg, 1e-4), ("dbeta", db, wdb, 1e-4))}
        deterministic = torch.equal(dg, dg2) and torch.equal(db, db2)
        _say_parity("layernorm", label, dtype, report,
                    dgamma_dbeta_bitwise_repeatable=deterministic)
        if not (all(r[3] for r in report.values()) and deterministic):
            raise RuntimeError(f"layernorm {label}: {report}, repeatable "
                               f"{deterministic}")
        if label == "gpt124m_8192x768":
            main_err["fwd"] = max(report[n][0] for n in ("y", "mu", "rstd"))
            main_err["bwd"] = max(report[n][0]
                                  for n in ("dx", "dgamma", "dbeta"))

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    x, g, b, dy = _ln_inputs(dev, bf16, 8192, 768, seed=98)
    y, mu, rstd = fwd.kernel(x, g, b, eps)
    _, dg, db = bwd.kernel(x, g, mu, rstd, dy)
    held = {}
    graph = _graph(lambda: held.update(out=bwd.kernel(x, g, mu, rstd, dy)))
    graph.replay()
    torch.cuda.synchronize()
    replay_bitwise = (torch.equal(held["out"][1], dg)
                      and torch.equal(held["out"][2], db))
    del graph, held
    plans = {}
    for dtype, c in ((bf16, 768), (f32, 768), (bf16, 2048)):
        info = lnk.bwd_kernel_info(dtype, c, dev)
        slots = info["blocks_per_sm"] * info["sms"]
        plans[f"{c} {dtype}"] = {
            **info, "grid_8192_rows": lnk.bwd_plan(8192, c, slots)[0],
            "reduce_grid": lnk.bwd_plan(8192, c, slots)[1]}
    say("layernorm_bwd_plan", plans=plans,
        graph_replay_bitwise=replay_bitwise,
        device_us_8192x768_bf16=device_us(
            lambda: bwd.kernel(x, g, mu, rstd, dy), flush, LN_BWD_KERNELS))
    if not replay_bitwise:
        raise RuntimeError("layernorm backward: dgamma/dbeta of a graph "
                           "replay differ from the eager call's")
    records = []
    for entry, row in zip((fwd, bwd), _ln_kernel_times(
            fwd, bwd, x, g, b, dy, eps, flush, "8192x768 bf16")):
        backward = entry is bwd
        records.append({"name": entry.name, "route": "cuda",
                        "source": entry.source, "replaces": entry.replaces,
                        "launches": None,
                        "max_abs_err": main_err["bwd" if backward else "fwd"],
                        **row})
    # the eager BERT-base path's shape: f32, 8 x 512 rows of 768
    x, g, b, dy = _ln_inputs(dev, f32, 4096, 768, seed=96)
    _ln_kernel_times(fwd, bwd, x, g, b, dy, 1e-12, flush,
                     "4096x768 f32 (BERT-base eager)")
    return records


def _ln_kernel_times(fwd, bwd, x, g, b, dy, eps, flush, shape):
    """B4a and B4b timed at one shape against the bound, the plain
    versions and ``F.layer_norm`` (a backward that recomputes its forward
    is timed as forward + backward less forward); prints a
    ``kernel_time`` line each and returns their ``kernels``-line
    fields."""
    import torch

    from paddle_tpu_torch.ops.cuda.layernorm_kernel import layer_norm_plain

    c = x.shape[-1]
    _, mu, rstd = fwd.kernel(x, g, b, eps)
    ms_f = time_ms(lambda: fwd.kernel(x, g, b, eps), flush)
    ms_b = time_ms(lambda: bwd.kernel(x, g, mu, rstd, dy), flush)
    plain_f = time_ms(lambda: fwd.plain(x, g, b, eps), flush)
    plain_fb = time_ms(lambda: bwd.plain(x, g, mu, rstd, dy, eps), flush)
    xl, gl, bl = (t.detach().requires_grad_() for t in (x, g, b))

    def plain_graph_fwd():
        with torch.enable_grad():
            return layer_norm_plain(xl, (c,), gl, bl, eps)

    plain_b = plain_fb - time_ms(plain_graph_fwd, flush)

    def lib():
        return torch.nn.functional.layer_norm(xl, (c,), gl, bl, eps)

    lib_f = time_ms(lib, flush)
    lib_fb = time_ms(lambda: torch.autograd.grad(lib(), (xl, gl, bl), dy),
                     flush)
    rows = []
    for entry, ms, plain_ms, lib_ms, backward in (
            (fwd, ms_f, plain_f, lib_f, False),
            (bwd, ms_b, plain_b, lib_fb - lib_f, True)):
        bound_ms, bound_by = _bound(
            entry, *((x, g, b, eps) if not backward
                     else (x, g, mu, rstd, dy)))
        say("kernel_time", kernel=entry.name, shape=shape,
            kernel_ms=ms, plain_ms=plain_ms,
            plain_with_forward_ms=plain_fb if backward else None,
            bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms,
            library="F.layer_norm" + (" backward (forward+backward minus "
                                      "forward)" if backward else ""))
        rows.append({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms})
    return rows


# The LayerNorm backward's sizes against their alternatives: each entry
# rewrites the chosen source's constexprs (or takes its arithmetic out),
# and may give the row pass another grid than one wave.
_LN_ARITH = """        for (int j = 0; j < 8; ++j) {
          const float xh = (xv[j] - m) * rs;
          const float w = dv[j] * g[j];
          s1 += w;
          s2 += w * xh;
          dg[c][j] += dv[j] * xh;
          db[c][j] += dv[j];
        }"""
_LN_DX = """        for (int j = 0; j < 8; ++j) {
          const float xh = (xv[j] - m) * rs;
          o[j] = (dv[j] * g[j] - c1 - xh * c2) * rs;
        }"""
LN_BWD_DESIGNS = {
    "chosen": ([], None),
    "ring_1_slot": ([("kRingSlots = 2;", "kRingSlots = 1;")], None),
    "ring_3_slots": ([("kRingSlots = 2;", "kRingSlots = 3;")], None),
    "ring_4_slots": ([("kRingSlots = 2;", "kRingSlots = 4;")], None),
    "4_warps_a_block": ([("kBwdWarps = 8;", "kBwdWarps = 4;")], None),
    "16_warps_a_block": ([("kBwdWarps = 8;", "kBwdWarps = 16;"),
                          ("kMinBlocks = V <= 4 ? 2 : 1", "kMinBlocks = 1")],
                         None),
    "grid_one_block_an_SM": ([], "sms"),
    "grid_one_block_per_8_rows": ([], "rows"),
    "no_arithmetic": ([(_LN_ARITH, "        for (int j = 0; j < 8; ++j) "
                                   "db[c][j] += dv[j] + xv[j];"),
                       (_LN_DX, "        for (int j = 0; j < 8; ++j) "
                                "o[j] = xv[j];")], None),
}


def ln_bwd_designs_phase(dev, rows=8192, c=768):
    """``python3 chip_smoke.py ln_bwd_designs``: the LayerNorm backward
    at ``rows`` x ``c`` bf16 as built (``chosen``) and as each entry of
    ``LN_BWD_DESIGNS`` rewrites it, built from copies under
    ``build/ln_bwd_designs/`` and timed in turn, twice: graph-replay ms
    under ``cold_l2``, the two kernels' device µs, and whether dx and
    dgamma/dbeta equal the chosen build's; beside them ``torch.add`` of
    two such tensors, which moves the same bytes."""
    import ctypes

    import torch

    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import layernorm_kernel as lnk

    src = open(os.path.join(_build.CSRC, "layernorm.cu")).read()
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR),
                           "ln_bwd_designs")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (edits, _) in LN_BWD_DESIGNS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"design {name}: {old!r} not in source")
            text = text.replace(old, new)
        path = os.path.join(out_dir, name)
        with open(path + ".cu", "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
             path + ".so", path + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"design {name} failed to build:\n{log}")
        lib = libs[name] = ctypes.CDLL(os.path.join(out_dir, name + ".so"))
        lib.layernorm_bwd.argtypes = ([ctypes.c_void_p] * 8
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p])
        lib.layernorm_bwd_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int)]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    x, g, b, dy = _ln_inputs(dev, torch.bfloat16, rows, c, seed=98)
    _, mu, rstd = lnk.layernorm_fwd_cuda(x, g, b, 1e-5)
    a, a2, a_out = x.clone(), dy.clone(), torch.empty_like(x)
    say("ln_bwd_design", design="torch.add (the same bytes)",
        ms=time_ms(lambda: torch.add(a, a2, out=a_out), flush),
        device_us=device_us(lambda: torch.add(a, a2, out=a_out), flush,
                            ("elementwise",)))
    chosen = None
    for rep in range(2):
        for name, lib in libs.items():
            info = (ctypes.c_int * 6)()
            if lib.layernorm_bwd_info(1, c, info):
                raise RuntimeError(f"design {name}: info failed")
            warps = (16 if name == "16_warps_a_block"
                     else 4 if name == "4_warps_a_block" else 8)
            grid = {"sms": info[3], "rows": -(-rows // warps)}.get(
                LN_BWD_DESIGNS[name][1],
                max(1, min(info[2] * info[3], -(-rows // warps))))
            dx = torch.empty_like(x)
            parts = torch.empty(grid, 2, c, device=dev)
            dgdb = torch.empty(2, c, device=dev)

            def call():
                rc = lib.layernorm_bwd(
                    x.data_ptr(), g.data_ptr(), mu.data_ptr(),
                    rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                    parts.data_ptr(), dgdb.data_ptr(), 1, rows, c, grid,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"design {name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            if chosen is None:
                chosen = (dx.clone(), dgdb.clone())
            say("ln_bwd_design", design=name, repeat=rep, grid=grid,
                registers=info[0], local_bytes=info[1],
                blocks_per_sm=info[2], ms=time_ms(call, flush),
                device_us={k: device_us(call, flush, (k,))
                           for k in LN_BWD_KERNELS},
                dx_equal_chosen=torch.equal(dx, chosen[0]),
                dgdb_max_diff_chosen=float((dgdb - chosen[1]).abs().max()))


def _ragged_phase(entries, dev):
    return [ragged_attention_phase(entries["paged_ragged_attention"], dev)]


# ------------------------------------ int8 ragged paged attention --
def _quantized(args, dtype):
    """A ragged case over int8 pools: the f32 pools of ``args``
    quantized per (slot, kv head) as the engine's append quantizes them
    (int8 [NB, bs, Nkv, D] and f32 scales [NB, Nkv, bs]); q in
    ``dtype``."""
    from paddle_tpu_torch.inference.llm.quant import quantize_kv_rows

    q, kp, vp, bt, rs, rq, rp = args
    kq, ks = quantize_kv_rows(kp)
    vq, vs = quantize_kv_rows(vp)
    return (q.to(dtype), kq, vq, ks.transpose(1, 2).contiguous(),
            vs.transpose(1, 2).contiguous(), bt, rs, rq, rp)


# the CPU test battery of the int8 kernel
# (tests/test_torch_quant_serving.py::QCASES), same layout as _CPU_CASES
_QUANT_CPU_CASES = [
    (6, 8, 4, 2, 16, 16, 70, [[5, 2, 0], [4, 1, 3], [0, 3, 5], [2, 2, 2]],
     [0, 1, 7, 0], [1, 6, 3, 0], [9, 5, 3, 0]),
    (6, 8, 4, 2, 16, 8, 72, None, list(range(8)), [0] + [1] * 7,
     [0, 12, 23, 4, 0, 7, 15, 8]),
    (6, 8, 8, 2, 16, 8, 74, [[1, 4, 2], [3, 0, 5]], [0, 3], [3, 5],
     [6, 0]),
    (6, 8, 4, 2, 16, 8, 76, [[3, 1, 0], [3, 1, 5]], [0, 4], [4, 4],
     [10, 17]),
    (6, 8, 4, 2, 16, 16, 78, [[3, 1, 4, 0], [2, 5, 0, 1]], [0, 10],
     [10, 4], [5, 12]),
]


def ragged_quant_phase(entries, dev):
    """B5 (the int8-pool twin of B1) against its plain version on the
    card: f32 and bf16 q over genuinely quantized int8 pools, on the CPU
    test cases, GPT-124M's geometry (12 kv heads, D 64, bs 16: decode
    T=8 at depth 600-1000 and a mixed T=256 step) and the split's edges,
    with exact zeros for padding and dead rows and every output bitwise
    repeatable; the plain version runs in f32 on the same values
    (``_parity``).  Then timed at the two GPT-124M shapes with bf16
    q, the engine's serving dtype, against its bytes bound."""
    import torch

    from paddle_tpu_torch.ops.cuda import split_kv

    entry = entries["paged_ragged_attention_quant"]
    f32, bf16 = torch.float32, torch.bfloat16

    def check(label, args):
        got = entry.kernel(*args)
        again = entry.kernel(*args)
        torch.cuda.synchronize()
        want = entry.plain(args[0].float(), *args[1:])
        report = {"out": _parity(got, want, 1e-4)}
        live = _live_tokens(args[0].shape[0], args[6], args[7], dev)
        pad_zero = bool((got[~live] == 0).all())
        repeat = torch.equal(got, again)
        _say_parity(entry.name, label, got.dtype, report,
                    padding_exact_zero=pad_zero, bitwise_repeatable=repeat)
        if not (report["out"][3] and pad_zero and repeat):
            raise RuntimeError(f"{entry.name} {label}: {report}, padding "
                               f"zero {pad_zero}, repeatable {repeat}")
        return report["out"][0]

    for i, (nb, bs, nq, nkv, d, t, seed, bt, rs, rq, rp) in \
            enumerate(_QUANT_CPU_CASES):
        base = _ragged_case(dev, f32, nb, bs, nq, nkv, d, t, bt, rs, rq, rp,
                            seed)
        for dtype in (f32, bf16):
            check(f"cpu_case_{i}_{str(dtype)[6:]}", _quantized(base, dtype))
    # GPT-124M geometry, the B1 phase's cases over quantized pools
    mixed = _ragged_case(dev, f32, 512, 16, 12, 12, 64, 256,
                         _full_width_tables(1),
                         [0, 1, 201, 205, 205, 205, 205, 205],
                         [1, 200, 4, 0, 0, 0, 0, 0],
                         [900, 37, 500, 0, 0, 0, 0, 0], seed=2)
    pos = np.random.RandomState(3).randint(600, 1000, size=8)
    decode = _ragged_case(dev, f32, 512, 16, 12, 12, 64, 8,
                          _full_width_tables(4), list(range(8)), [1] * 8,
                          pos, seed=5)
    # a tensor-parallel rank's shard of it (tp = 2: 6 of the 12 heads)
    shard = _ragged_case(dev, f32, 512, 16, 6, 6, 64, 8,
                         _full_width_tables(4), list(range(8)), [1] * 8,
                         pos, seed=5)
    gqa = _ragged_case(dev, f32, 512, 16, 32, 8, 128, 64,
                       _full_width_tables(6)[:4], [0, 1, 41, 41],
                       [1, 40, 7, 0], [700, 90, 15, 0], seed=7)
    edges = _ragged_case(dev, f32, 512, 16, 12, 12, 64, 8,
                         _full_width_tables(16),
                         *_split_edge_rows(split_kv.CHUNK), seed=17)
    main = {}
    for label, base in (("gpt124m_mixed_T256", mixed),
                        ("gpt124m_decode_T8", decode),
                        ("gpt124m_tp2_shard_decode_T8", shard),
                        ("gqa4_d128", gqa),
                        ("split_edges", edges),
                        ("long_prefill_row_slots",
                         _long_prefill_case(dev, f32))):
        for dtype in (f32, bf16):
            args = _quantized(base, dtype)
            err = check(f"{label}_{str(dtype)[6:]}", args)
            if dtype == bf16:
                main[label] = (args, err)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timings = {}
    for label in ("gpt124m_decode_T8", "gpt124m_mixed_T256",
                  "gpt124m_tp2_shard_decode_T8"):
        args = main[label][0]
        ms = time_ms(lambda: entry.kernel(*args), flush)
        plain_ms = time_ms(lambda: entry.plain(*args), flush)
        q, kq, _vq, _ks, _vs, bt, rs, rq, rp = args
        bound_ms, bound_by = _bound(entry, *args)
        timings[label] = (ms, plain_ms, bound_ms, bound_by)
        say("kernel_time", kernel=entry.name, shape=label + " bf16 q, int8 "
            "pools", kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None,
            device_us=split_device_us(lambda: entry.kernel(*args), flush),
            call_ms=call_ms(lambda: entry.kernel(*args)),
            scratch_bytes=_ragged_scratch_bytes(q, kq, bt))
    ms, plain_ms, bound_ms, bound_by = timings["gpt124m_decode_T8"]
    return [{"name": entry.name, "route": "cuda", "source": entry.source,
             "replaces": entry.replaces, "launches": None,
             "max_abs_err": max(main["gpt124m_mixed_T256"][1],
                                main["gpt124m_decode_T8"][1]),
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by,
             # no single PyTorch call computes ragged paged attention
             "library_ms": None}]


# ------------------------------------------- dense-cache decode (B6) --
def _decode_case(dev, dtype, b, nq, nkv, d, s, lengths, seed):
    import torch

    rng = np.random.RandomState(seed)
    q, k, v = (torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device=dev).to(dtype)
               for shape in ((b, nq, d), (b, s, nkv, d), (b, s, nkv, d)))
    if lengths is None:
        lengths = rng.randint(1, s + 1, b)
    return q, k, v, torch.as_tensor(np.asarray(lengths, np.int32),
                                    device=dev)


def _full_lengths(seed, b, s):
    """Lengths across 0..S_max for a batch of ``b``: one empty
    sequence, one full one, the rest drawn."""
    lens = np.random.RandomState(seed).randint(1, s + 1, b)
    lens[0], lens[-1] = 0, s
    return lens


def decode_attention_phase(entries, dev):
    """B6 against its plain version on the card, f32 and bf16: the CPU
    test cases, GPT-124M's FMT decode shape (B 8, S_max 1024, 12/12
    heads) and Llama-160M's (B 8, S_max 2048, 12 query heads on 4 kv
    heads), lengths across 0..S_max with 0 included (exact zeros), a
    group of 16 at D 128, the edges of the split-KV plan and the FMT and
    Llama decode paths' own shapes; every output bitwise repeatable.
    Then timed at those shapes, GPT's in bf16 and Llama's in f32 (their
    decode paths' dtypes), against the bytes bound and
    ``F.scaled_dot_product_attention`` with a length mask and
    ``enable_gqa=True`` (a yardstick only)."""
    import torch

    from paddle_tpu_torch.ops.cuda import split_kv

    entry = entries["decode_attention"]
    f32, bf16 = torch.float32, torch.bfloat16
    chunk = split_kv.CHUNK

    def check(label, args):
        got = entry.kernel(*args)
        again = entry.kernel(*args)
        torch.cuda.synchronize()
        q, k, v, lens = args
        want = entry.plain(q.float(), k.float(), v.float(), lens)
        report = {"out": _parity(got, want, 1e-4)}
        empty = lens <= 0
        zero = bool((got[empty] == 0).all())
        repeat = torch.equal(got, again)
        _say_parity(entry.name, label, got.dtype, report,
                    empty_rows=int(empty.sum()), empty_rows_exact_zero=zero,
                    bitwise_repeatable=repeat)
        if not (report["out"][3] and zero and repeat):
            raise RuntimeError(f"{entry.name} {label}: {report}, empty "
                               f"rows zero {zero}, repeatable {repeat}")
        return report["out"][0]

    cases = [   # label, (B, Nq, Nkv, D, S_max), lengths, seed
        ("cpu_ragged_gqa_4_2", (3, 4, 2, 16, 64), None, 0),
        ("cpu_mha_tiny_lengths", (3, 2, 2, 16, 64), [1, 64, 33], 1),
        ("cpu_empty_rows", (3, 4, 2, 16, 64), [0, 17, 0], 3),
        ("cpu_gqa_group_of_three", (4, 6, 2, 32, 40), [40, 1, 0, 23], 4),
        ("gpt124m_fmt", (8, 12, 12, 64, 1024), _full_lengths(20, 8, 1024),
         20),
        ("llama160m", (8, 12, 4, 64, 2048), _full_lengths(21, 8, 2048), 21),
        ("group16_d128", (2, 16, 1, 128, 300), [300, 129], 22),
        # the split's edges: a chunk boundary, one key past it, 1, a
        # length ending inside the last split, 0, and S_max
        ("split_edges", (8, 12, 4, 64, 4 * chunk),
         [chunk, chunk + 1, 1, 4 * chunk - chunk // 2, 0, 4 * chunk, 1,
          2 * chunk], 23),
        ("s_max_below_one_chunk", (4, 12, 12, 64, chunk // 2 + 3),
         [chunk // 2 + 3, 1, 0, 17], 24),
        # the main paths' own shapes: FMT's decode (max_length 192,
        # positions 128-192) and Llama's (a 2048-slot cache, lengths 1-80)
        ("fmt_main_path", (8, 12, 12, 64, 192),
         np.random.RandomState(25).randint(128, 193, 8), 25),
        ("llama_main_path", (8, 12, 4, 64, 2048),
         np.random.RandomState(26).randint(1, 81, 8), 26),
    ]
    inputs, errs = {}, {}
    for label, (b, nq, nkv, d, s), lens, seed in cases:
        for dtype in (f32, bf16):
            args = _decode_case(dev, dtype, b, nq, nkv, d, s, lens, seed)
            errs[label, dtype] = check(f"{label}_{str(dtype)[6:]}", args)
            inputs[label, dtype] = args

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for label, dtype in (("llama_main_path", f32), ("fmt_main_path", bf16),
                         ("llama160m", f32), ("gpt124m_fmt", bf16)):
        q, k, v, lens = args = inputs[label, dtype]
        ms = time_ms(lambda: entry.kernel(*args), flush)
        plain_ms = time_ms(lambda: entry.plain(*args), flush)
        bound_ms, bound_by = _bound(entry, *args)
        qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(k.shape[1], device=dev)[None, :]
                < lens[:, None])[:, None, None, :]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)

        lib_ms = time_ms(sdpa, flush)
        say("kernel_time", kernel=entry.name, shape=f"{label} "
            f"{str(dtype)[6:]}, S_max {k.shape[1]}, lengths "
            f"{int(lens.min())}..{int(lens.max())}", kernel_ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms, library="F.scaled_dot_product_attention "
            "(length mask, enable_gqa=True)",
            device_us=split_device_us(lambda: entry.kernel(*args), flush),
            call_ms=call_ms(lambda: entry.kernel(*args)))
    # the record: the last shape, FMT's GPT-124M decode in bf16
    return [{"name": entry.name, "route": "cuda", "source": entry.source,
             "replaces": entry.replaces, "launches": None,
             "max_abs_err": errs["gpt124m_fmt", bf16], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": lib_ms}]


# ------------------------------------------------ the timing yardstick --
def timing_harness_phase(dev, repeats=3):
    """The yardstick held against itself.  Three calls — B6 at FMT's
    decode shape (two kernels, ~8 µs), B1 at decode T=8 and the
    LayerNorm forward at 8192 x 768 bf16 — are timed ``repeats`` times
    (each a median of 30 graph replays), in turn, under four ways to
    start a replay cold: the L2 flushed by writing 64 MB (``zero_``,
    the earlier yardstick) or by reading it (``amax``), each with and
    without the queued wait of :func:`cold_l2`.  Prints every reading
    and each way's spread (largest over smallest); :func:`time_ms` uses
    the read flush with the wait."""
    import torch

    from paddle_tpu_torch.ops.cuda import registry

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush.zero_()
    b6 = _decode_case(dev, torch.bfloat16, 8, 12, 12, 64, 192,
                      np.random.RandomState(25).randint(128, 193, 8), 25)
    b1 = _ragged_case(dev, torch.bfloat16, 512, 16, 12, 12, 64, 8,
                      _full_width_tables(4), list(range(8)), [1] * 8,
                      np.random.RandomState(3).randint(600, 1000, size=8),
                      seed=5)
    x, g, b, _ = _ln_inputs(dev, torch.bfloat16, 8192, 768, seed=98)
    kernels = registry.KERNELS
    calls = {
        "decode_attention fmt_main_path bf16": lambda: kernels[
            "decode_attention"].kernel(*b6),
        "paged_ragged_attention decode_T8 bf16": lambda: kernels[
            "paged_ragged_attention"].kernel(*b1),
        "layernorm_fwd 8192x768 bf16": lambda: kernels[
            "layernorm_fwd"].kernel(x, g, b, 1e-5),
    }
    ways = {
        "write flush": flush.zero_,
        "write flush + wait": lambda: (flush.zero_(),
                                       torch.cuda._sleep(WAIT_CYCLES)),
        "read flush": lambda: torch.amax(flush),
        "read flush + wait (time_ms)": lambda: cold_l2(flush),
    }
    for label, fn in calls.items():
        graph = _graph(fn)
        readings = {w: [] for w in ways}
        for _ in range(repeats):
            for w, before in ways.items():
                readings[w].append(_replay_ms(graph, before, 30))
        say("timing_harness", call=label, ms=readings,
            spread={w: max(r) / min(r) for w, r in readings.items()})


# kernel names of ops/cuda/registry.py -> the phase that holds them to
# their plain versions; each phase returns one record per kernel
PARITY_PHASES = {
    ("paged_ragged_attention",): _ragged_phase,
    ("paged_ragged_attention_quant",): ragged_quant_phase,
    ("decode_attention",): decode_attention_phase,
    ("flash_attention_fwd", "flash_attention_bwd"): flash_attention_phase,
    ("layernorm_fwd", "layernorm_bwd"): layernorm_phase,
}


# ------------------------------------------------------------ phases --
def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    say("device", kind=name, count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


def build_phase():
    from paddle_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    built = _build.build()
    for name, (seconds, log) in built.items():
        report = [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
        say("build", kernel=name, seconds=seconds, ptxas=report)
    say("build_total", seconds=time.perf_counter() - t0)


def exactness_phase(dev):
    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.ops.cuda import registry

    model, prompts = _exactness_model_and_prompts(dev)
    eng = LLMEngine(model, device=dev, block_size=8, max_batch=4,
                    token_budget=16)
    registry.reset_counts()
    outs = eng.generate(prompts, max_new_tokens=8)
    launches = registry.counts()["paged_ragged_attention"]
    for p, out in zip(prompts, outs):
        ref = model.greedy_decode(p, 8)
        if not np.array_equal(out, ref):
            _report_first_flip(model, out, ref, dev)
    want = eng.num_layers * eng.stats["launches"]
    say("exactness", prompts=len(prompts), steps=eng.stats["steps"],
        mixed_steps=eng.stats["mixed_steps"],
        prefix_hit_tokens=eng.prefix_cache_stats()["prefix_hit_tokens"],
        kernel_launches=launches, expected_launches=want,
        graph_captures=eng._graphs.captures,
        graph_replays=eng._graphs.replays)
    if launches != want or eng.stats["mixed_steps"] < 1:
        raise RuntimeError("exactness run did not go through the kernel "
                           "on every layer of every step, or mixed no "
                           "phases")
    _require_replays(eng._graphs, eng.stats["launches"])


def _require_replays(graphs, steps):
    """Every step ran as a replay but each key's first, which captured."""
    if graphs.replays + graphs.captures != steps or not graphs.replays:
        raise RuntimeError(f"{steps} steps ran {graphs.replays} replays and "
                           f"{graphs.captures} captures")


def _exactness_model_and_prompts(dev):
    from paddle_tpu_torch.models.gpt import gpt_tiny

    model = gpt_tiny(device=dev, num_layers=2, seed=0,
                     initializer_range=0.1)
    rng = np.random.RandomState(11)
    shared = list(rng.randint(0, 128, 16))
    prompts = [list(rng.randint(0, 128, 5)),
               list(rng.randint(0, 128, 23)),      # chunked: > budget
               shared + [7, 9, 2], shared + [4, 4]]
    return model, prompts


def int8_exactness_phase(dev):
    """The int8 engine (int8 weights and K/V) on the exactness phase's
    model and prompts: at every generated position its greedy token must
    be the argmax of ``quality.engine_logits`` — the dense forward with
    the same int8 weights and the same per-(token, head) K/V round trip
    — so the paged int8 path computes what the int8 model means.  B5
    must launch on every layer of every step, B1 never."""
    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.inference.llm.quality import engine_logits
    from paddle_tpu_torch.ops.cuda import registry

    model, prompts = _exactness_model_and_prompts(dev)
    eng = LLMEngine(model, device=dev, block_size=8, max_batch=4,
                    token_budget=16, quantize="int8")
    registry.reset_counts()
    outs = eng.generate(prompts, max_new_tokens=8)
    launches = registry.counts()
    for p, out in zip(prompts, outs):
        logits = engine_logits(eng, out)
        want = np.argmax(logits[len(p) - 1:-1], axis=-1)
        got = out[len(p):]
        if not np.array_equal(got, want):
            i = int(np.argmax(got != want))
            row = logits[len(p) - 1 + i]
            raise RuntimeError(
                f"int8 engine {got.tolist()} != dense int8 argmax "
                f"{want.tolist()}; first difference at generated position "
                f"{i}: dense logit {float(row[want[i]])} for token "
                f"{int(want[i])}, {float(row[got[i]])} for the engine's "
                f"{int(got[i])}")
    want = eng.num_layers * eng.stats["launches"]
    say("int8_exactness", prompts=len(prompts), steps=eng.stats["steps"],
        mixed_steps=eng.stats["mixed_steps"], kernel_launches=launches,
        expected_quant_launches=want, graph_captures=eng._graphs.captures,
        graph_replays=eng._graphs.replays)
    if (launches["paged_ragged_attention_quant"] != want
            or launches["paged_ragged_attention"]):
        raise RuntimeError("the int8 run did not go through the int8 kernel "
                           "on every layer of every step")
    _require_replays(eng._graphs, eng.stats["launches"])


def fmt_exactness_phase(dev):
    """FusedMultiTransformer on the exactness phase's f32 model, one
    prompt at a time: its greedy output must equal the paged engine's and
    the dense ``greedy_decode``'s token for token, with B6 launched on
    every layer of every decode step."""
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.ops.cuda import registry

    model, prompts = _exactness_model_and_prompts(dev)
    fmt = FusedMultiTransformer(model, max_length=64, device=dev)
    registry.reset_counts()
    refs = [fmt.generate(np.asarray(p)[None], max_new_tokens=8)[0]
            for p in prompts]
    launches = registry.counts()["decode_attention"]
    want = fmt.num_layers * fmt.decode_steps
    eng = LLMEngine(model, device=dev, block_size=8, max_batch=4,
                    token_budget=16)
    outs = eng.generate(prompts, max_new_tokens=8)
    for p, ref, out in zip(prompts, refs, outs):
        dense = model.greedy_decode(p, 8)
        if not np.array_equal(ref, dense):
            _report_first_flip(model, ref, dense, dev)
        if not np.array_equal(out, ref):
            _report_first_flip(model, out, dense, dev)
    say("fmt_exactness", prompts=len(prompts),
        decode_steps=fmt.decode_steps, kernel_launches=launches,
        expected_launches=want, graph_captures=fmt._graphs.captures,
        graph_replays=fmt._graphs.replays)
    if launches != want:
        raise RuntimeError(f"decode kernel launches {launches} != {want}")
    _require_replays(fmt._graphs, fmt.decode_steps)


def _report_first_flip(model, out, ref, dev):
    """Raise with the dense forward's logits of the two tokens at the
    first position where the engine and dense greedy decoding differ."""
    import torch

    i = int(np.argmax(out != ref))
    with torch.no_grad():
        logits = model.eval()(torch.as_tensor(ref[None, :i], device=dev))
    row = logits[0, -1].float()
    raise RuntimeError(
        f"engine {out.tolist()} != dense greedy {ref.tolist()}; first "
        f"difference at position {i}: dense logit {float(row[ref[i]])} for "
        f"token {int(ref[i])}, {float(row[out[i]])} for the engine's "
        f"{int(out[i])}")


_SERVE_ENGINE = dict(dtype="bfloat16", block_size=16, max_batch=8,
                     token_budget=256, enable_prefix_caching=True)


def _mixed_step(eng, tb, rng):
    """A packed step for bucket ``tb`` with padding: a prefill chunk of
    ``tb - 4`` tokens at position 48 and two decode rows at depths 100
    and 37, each row on pages of its own."""
    pages = eng.max_pages
    rows = [(rng.randint(0, eng.vocab_size, tb - 4), 48),
            (rng.randint(0, eng.vocab_size, 1), 100),
            (rng.randint(0, eng.vocab_size, 1), 37)]
    return eng._pack_rows(
        [(toks, pos0, (np.arange(pages) + r * pages) % eng.num_blocks)
         for r, (toks, pos0) in enumerate(rows)], tb)


def _replay_against_eager(state, eager, replay):
    """Run ``eager()`` from a snapshot of the ``state`` tensors, restore
    them, run ``replay()`` -> (whether the outputs and the states after
    the two runs are bitwise equal, the replay's outputs)."""
    import torch

    snap = [t.clone() for t in state]
    want = eager()
    after = [t.clone() for t in state]
    for t, saved in zip(state, snap):
        t.copy_(saved)
    got = replay()
    torch.cuda.synchronize()
    return (all(torch.equal(a, b) for a, b in zip(got, want))
            and all(torch.equal(a, b) for a, b in zip(state, after))), got


def graphs_phase(dev):
    """The captured steps at GPT-124M width (random bf16 weights from
    seed 0).  The bf16 and the int8 engine (the smoke's serving
    settings): each token bucket is captured as ``warmup`` does it,
    largest first (a dead-row step run eagerly, then captured), with its
    capture ms and the shared pool's bytes after it; then for every
    bucket a packed step with padding that mixes a prefill chunk with two
    decode rows runs as the eager body and, from the same pools, as the
    engine's replay: argmax, logits and the visible pools (and scale
    pools) must be bitwise equal.  FusedMultiTransformer at batch 8
    (128-token prompts, ``max_length`` 192): its decode replay against
    the eager decode body at offsets 129, 160 and 191, logits and caches
    bitwise.  Outside the main paths: no launch here is counted in the
    ``kernels`` line."""
    import torch

    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.models.gpt import gpt_124m

    model = gpt_124m(device=dev, seed=0, dtype=torch.bfloat16).eval()
    rng = np.random.RandomState(55)
    failed = []
    for quantize in (None, "int8"):
        engine = quantize or "bf16"
        eng = LLMEngine(model, device=dev, quantize=quantize,
                        **_SERVE_ENGINE)
        graphs = eng._graphs
        pool_bytes = {}
        for _, tb in sorted(eng._bucket_grid(), key=lambda b: -b[1]):
            eng._ragged_fn(eng._pack_rows([], tb))
            pool_bytes[tb] = graphs.pool_bytes()
        state = [t for t in (eng._kc, eng._vc, eng._ks, eng._vs)
                 if t is not None]
        for _, tb in eng._bucket_grid():
            pk = _mixed_step(eng, tb, rng)
            ints = torch.from_numpy(pk["ints"]).to(dev)
            replays = graphs.replays
            ok, _ = _replay_against_eager(
                state, lambda: eng._ragged_body(ints),
                lambda: eng._ragged_fn(pk))
            ok = ok and graphs.replays == replays + 1
            say("graphs", engine=engine, bucket=tb, live_tokens=pk["total"],
                capture_ms=graphs.capture_ms[tb],
                pool_bytes_after_capture=pool_bytes[tb], bitwise=ok)
            if not ok:
                failed.append(f"{engine} bucket {tb}")
        say("graphs_pool", engine=engine, captures=graphs.captures,
            pool_bytes=graphs.pool_bytes(),
            sink_bytes=sum(t.numel() * t.element_size() for t in (
                eng._k_rows, eng._v_rows, eng._ks_flat, eng._vs_flat)
                if t is not None) - sum(
                t.numel() * t.element_size() for t in state))
        del eng, graphs, state

    batch, prompt = 8, 128
    fmt = FusedMultiTransformer(model, max_length=192, dtype="bfloat16",
                                device=dev)
    ck, cv = fmt._cache(batch)
    logits = fmt._forward_chunk(torch.as_tensor(
        rng.randint(0, 50257, (batch, prompt)), device=dev), ck, cv, 0)
    logits = fmt._decode_step(logits.argmax(-1).cpu().numpy(), prompt)
    for off in (129, 160, 191):
        toks = logits.argmax(-1).cpu().numpy()
        buf = torch.as_tensor(np.append(toks, off), device=dev)
        replays = fmt._graphs.replays
        ok, (logits,) = _replay_against_eager(
            [ck, cv], lambda: [fmt._decode_body(buf)],
            lambda: [fmt._decode_step(toks, off)])
        ok = ok and fmt._graphs.replays == replays + 1
        say("graphs", engine="fmt", batch=batch, offset=off,
            capture_ms=fmt._graphs.capture_ms[batch],
            pool_bytes=fmt._graphs.pool_bytes(), bitwise=ok)
        if not ok:
            failed.append(f"fmt offset {off}")
    if failed:
        raise RuntimeError(f"replay differs from the eager step body: "
                           f"{failed}")


def _burst_prompts():
    """The 16-request burst: 32-600 prompt tokens, 8 of them behind one
    256-token prefix; request index -> seed of the 2 sampled ones."""
    rng = np.random.RandomState(1234)
    vocab = 50257
    prefix = list(rng.randint(0, vocab, 256))
    lengths = rng.randint(32, 601, size=16)
    prompts = []
    for i, n in enumerate(lengths):
        if i % 2 == 0:      # 8 requests share the 256-token prefix
            n = max(int(n), 257)
            prompts.append(prefix + list(rng.randint(0, vocab, n - 256)))
        else:
            prompts.append(list(rng.randint(0, vocab, int(n))))
    return prompts, {3: 101, 10: 202}


def _serve_burst(eng, dev, kernel, new=64, adapters=None):
    """The main path of a serving phase: warmup, then the burst; counts
    are reset just before and read just after.  Every request must
    finish by length with ``new`` tokens, ``kernel`` must launch on every
    layer of every engine launch and at least one step must mix prefill
    chunks with decodes.  ``adapters`` gives each request its LoRA
    adapter (None: the base model).  Returns (launches, prompts,
    sampled, outputs by request index, the serving record's numbers)."""
    import torch

    from paddle_tpu_torch.ops.cuda import registry

    prompts, sampled = _burst_prompts()
    registry.reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    watcher = eng.warmup()
    graphs = eng._graphs
    captures, replays = graphs.captures, graphs.replays
    steps0 = eng.stats["launches"]
    t_start = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=new,
                            temperature=0.8 if i in sampled else 0.0,
                            seed=sampled.get(i),
                            adapter_id=adapters[i] if adapters else None)
            for i, p in enumerate(prompts)]
    outs = {}
    while eng.has_unfinished():
        for o in eng.step():
            outs[o.request_id] = o
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t_start
    launches = registry.counts()

    bad = [r for r in rids if outs[r].finish_reason != "length"
           or len(outs[r].output_ids) != new
           or not ((outs[r].output_ids >= 0)
                   & (outs[r].output_ids < eng.vocab_size)).all()]
    if bad:
        raise RuntimeError(f"requests {bad} did not emit {new} tokens")
    want = eng.num_layers * eng.stats["launches"]
    if launches[kernel] != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")
    if eng.stats["mixed_steps"] < 1:
        raise RuntimeError("no step mixed prefill chunks with decodes")
    burst_replays = graphs.replays - replays
    watcher.assert_no_new_captures()
    if (graphs.captures != captures
            or burst_replays != eng.stats["launches"] - steps0):
        raise RuntimeError(
            f"the burst captured {graphs.captures - captures} graphs after "
            f"warmup() and replayed {burst_replays} of "
            f"{eng.stats['launches'] - steps0} steps")
    ttft = [o.metrics["first_token"] - o.metrics["arrival"]
            for o in outs.values()]
    tpot = [(o.metrics["finished"] - o.metrics["first_token"]) / (new - 1)
            for o in outs.values()]
    generated = eng.stats["tokens_generated"]
    record = dict(
        requests=len(rids), prompt_tokens=int(sum(len(p) for p in prompts)),
        prefix_hit_tokens=eng.prefix_cache_stats()["prefix_hit_tokens"],
        generated_tokens=generated, wall_s=wall,
        tokens_per_s=generated / wall,
        ttft_p50_ms=float(np.median(ttft)) * 1e3,
        tpot_p50_ms=float(np.median(tpot)) * 1e3,
        steps=eng.stats["steps"], mixed_steps=eng.stats["mixed_steps"],
        engine_launches=eng.stats["launches"], kernel_launches=launches,
        graph_replays=burst_replays,
        graph_captures_after_warmup=graphs.captures - captures,
        graph_pool_bytes=graphs.pool_bytes(), warmup_ms=watcher.compile_ms,
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev))
    return (launches, prompts, sampled,
            [outs[r] for r in rids], record)


def serving_phase(dev):
    import torch

    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.models.gpt import gpt_124m

    t0 = time.perf_counter()
    model = gpt_124m(device=dev, seed=0, dtype=torch.bfloat16).eval()
    eng = LLMEngine(model, device=dev, **_SERVE_ENGINE)
    setup_s = time.perf_counter() - t0
    launches, prompts, sampled, outs, record = _serve_burst(
        eng, dev, "paged_ragged_attention")
    # the engine's first token of each greedy request is among the dense
    # bf16 forward's top 3 at the prompt's last position
    for i, out in enumerate(outs):
        if i in sampled:
            continue
        ids = torch.as_tensor(prompts[i], device=dev)[None]
        with torch.no_grad():
            logits = model(ids)[0, -1].float()
        if not torch.isfinite(logits).all():
            raise RuntimeError("dense forward produced non-finite logits")
        top = logits.topk(3).indices.tolist()
        if int(out.output_ids[0]) not in top:
            raise RuntimeError(f"request {i}: first token "
                               f"{int(out.output_ids[0])} not in the "
                               f"dense top 3 {top}")
    say("serving", model="gpt_124m", dtype="bfloat16", setup_s=setup_s,
        **record)
    return launches, eng


def int8_serving_phase(dev):
    """GPT-124M in bf16 with ``quantize="int8"`` (int8 GEMM weights and
    int8 K/V pools) behind the same engine settings and the same 16
    requests as ``serving_phase``; B5 must launch on every layer of every
    engine launch and B1 never.  Beside the burst: the resident bytes
    (``torch.cuda.memory_allocated`` before the model is built and after
    the engine is built and the model dropped) must be the memory
    model's weights + pool within 1%, which no cached dequantized weight
    would pass; the bf16 engine's weights + 2.5 sequences as
    ``memory_budget`` must admit at least twice the bf16 engine's batch;
    ``quality_report`` against the bf16 engine on 4 prompts must be
    finite; and a decode window is profiled.  Returns the B5 count of
    the burst."""
    import gc

    import torch

    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.inference.llm.quality import quality_report
    from paddle_tpu_torch.models.gpt import gpt_124m

    gc.collect()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = gpt_124m(device=dev, seed=0, dtype=torch.bfloat16).eval()
    eng = LLMEngine(model, device=dev, quantize="int8", **_SERVE_ENGINE)
    setup_s = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.synchronize(dev)
    resident = torch.cuda.memory_allocated(dev) - base
    mm = eng.memory_model()
    model_bytes = mm["weights_bytes"] + mm["kv_pool_bytes"]
    say("int8_residency", resident_bytes=resident,
        weights_bytes=mm["weights_bytes"], kv_pool_bytes=mm["kv_pool_bytes"],
        page_bytes=mm["page_bytes"], rel_err=resident / model_bytes - 1.0)
    if abs(resident - model_bytes) > 0.01 * model_bytes:
        raise RuntimeError(f"int8 engine holds {resident} bytes, the memory "
                           f"model says {model_bytes}")

    launches, _p, _s, _o, record = _serve_burst(
        eng, dev, "paged_ragged_attention_quant")
    say("serving", model="gpt_124m", dtype="bfloat16", quantize="int8",
        setup_s=setup_s, **record)
    if launches["paged_ragged_attention"]:
        raise RuntimeError("the int8-KV engine launched the full-precision "
                           "ragged kernel")

    ref_model = gpt_124m(device=dev, seed=0, dtype=torch.bfloat16).eval()
    ref = LLMEngine(ref_model, device=dev, **_SERVE_ENGINE)
    mm16 = ref.memory_model()
    budget = mm16["weights_bytes"] + int(2.5 * mm16["seq_bytes"])
    wide = {**_SERVE_ENGINE, "max_batch": 64}
    base_b = LLMEngine(ref_model, device=dev, memory_budget=budget, **wide)
    q8_b = LLMEngine(ref_model, device=dev, memory_budget=budget,
                     quantize="int8", **wide)
    say("int8_budget", memory_budget=budget,
        bf16_weights_bytes=mm16["weights_bytes"],
        bf16_seq_bytes=mm16["seq_bytes"], int8_weights_bytes=mm[
            "weights_bytes"], int8_seq_bytes=mm["seq_bytes"],
        bf16_max_batch=base_b.max_batch, int8_max_batch=q8_b.max_batch)
    if q8_b.max_batch < 2 * base_b.max_batch:
        raise RuntimeError("the int8 engine's derived max_batch is not twice "
                           "the bf16 engine's under the same budget")
    del base_b, q8_b

    rng = np.random.RandomState(4321)
    qprompts = [list(rng.randint(0, 50257, n)) for n in (48, 96, 160, 256)]
    rep = quality_report(ref, eng, qprompts, max_new_tokens=16)
    say("int8_quality", reference="bf16 engine, same weights", **rep)
    if not all(np.isfinite(v) for v in rep.values()):
        raise RuntimeError(f"quality report not finite: {rep}")
    del ref, ref_model
    decode_profile_phase(eng, dev, engine="int8")
    return {"paged_ragged_attention_quant":
            launches["paged_ragged_attention_quant"]}


# ------------------------------------------------------- speculation --
def _spec_prompts():
    """``tests/test_llm_engine.py::TestSpeculative``'s prompts: three of
    five tiled, so the n-gram drafter hits."""
    rng = np.random.RandomState(7)
    return [list(p) for p in (
        np.tile(rng.randint(0, 128, 5), 3), rng.randint(0, 128, 12),
        np.tile(rng.randint(0, 128, 4), 4), rng.randint(0, 128, 3),
        np.tile(rng.randint(0, 128, 6), 2))]


def _b1_want(eng):
    """B1 launches an engine's runs make: every layer of every target
    launch and every draft layer of every draft launch."""
    want = eng.num_layers * eng.stats["launches"]
    if eng._draft_bm is not None:
        want += len(eng._draft_layers) * eng.stats["draft_launches"]
    return want


def spec_exactness_phase(dev):
    """Speculation and lookahead on the exactness phase's f32 model and
    settings, over its prompts and ``TestSpeculative``'s tiled ones, 24
    new tokens: n-gram K = 4, draft-model with one draft layer, tree, a
    full-copy draft (every layer; its n-gram leg muted, acceptance must
    be exactly 1.0), lookahead alone and with n-gram.  Each must equal
    the plain engine and the dense greedy forward token for token, run
    every step as a replay but each key's first (target and draft
    graphs), and launch B1 exactly L x target + draft_layers x draft
    launches.  Returns B1's launches."""
    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.ops.cuda import registry

    model, prompts = _exactness_model_and_prompts(dev)
    prompts = prompts + _spec_prompts()
    new, tiny = 24, dict(block_size=8, max_batch=4, token_budget=16)
    dense = [model.greedy_decode(p, new) for p in prompts]
    plain = LLMEngine(model, device=dev, **tiny).generate(
        prompts, max_new_tokens=new)
    for out, ref in zip(plain, dense):
        if not np.array_equal(out, ref):
            _report_first_flip(model, out, ref, dev)
    layers = model.config.num_layers
    configs = (
        ("ngram", dict(speculative=4)),
        ("draft_model", dict(speculative={
            "method": "draft-model", "num_tokens": 4, "draft_layers": 1})),
        ("tree", dict(speculative={
            "method": "tree", "num_tokens": 3, "draft_layers": 1})),
        ("full_copy_draft", dict(speculative={
            "method": "draft-model", "num_tokens": 3,
            "draft_layers": layers})),
        ("lookahead", dict(lookahead=True)),
        ("lookahead_ngram", dict(lookahead=True, speculative=4)))
    total = 0
    for label, kw in configs:
        eng = LLMEngine(model, device=dev, **tiny, **kw)
        if label == "full_copy_draft":
            eng.drafter._ngram.propose = lambda *a, **k: []
        registry.reset_counts()
        outs = eng.generate(prompts, max_new_tokens=new)
        launches = registry.counts()["paged_ragged_attention"]
        total += launches
        for out, ref in zip(outs, dense):
            if not np.array_equal(out, ref):
                _report_first_flip(model, out, ref, dev)
        graphs = [(eng._graphs, eng.stats["launches"])]
        if eng._draft_graphs is not None:
            graphs.append((eng._draft_graphs, eng.stats["draft_launches"]))
        for g, steps in graphs:
            _require_replays(g, steps)
        st = eng.spec_stats()
        life = eng.lifecycle_stats()
        say("spec_exactness", config=label, prompts=len(prompts),
            steps=eng.stats["steps"], spec=st,
            staged_steps=life["staged_steps"],
            staged_hits=life["staged_hits"], kernel_launches=launches,
            target_launches=eng.stats["launches"],
            draft_launches=eng.stats["draft_launches"],
            graph_replays=[g.replays for g, _ in graphs],
            graph_captures=[g.captures for g, _ in graphs])
        if launches != _b1_want(eng):
            raise RuntimeError(f"{label}: B1 launches {launches} != "
                               f"{_b1_want(eng)}")
        if eng.spec is not None and not st["draft_tokens"]:
            raise RuntimeError(f"{label}: nothing was drafted")
        if eng.spec is not None and eng.spec.uses_draft_model \
                and not st["model_drafts"]:
            raise RuntimeError(f"{label}: the draft model drafted nothing")
        if label == "full_copy_draft" and st["acceptance_rate"] != 1.0:
            raise RuntimeError(f"full-copy draft accepted "
                               f"{st['acceptance_rate']}, not all")
        if label == "lookahead" and not life["staged_hits"]:
            raise RuntimeError("lookahead claimed no staged plan")
    return total


def _spec_burst_prompts():
    """The speculative burst: 16 prompts of 64-512 tokens, each a random
    unit of 8-32 tokens repeated (repetitive text, as tool loops and
    code edits send)."""
    rng = np.random.RandomState(4242)
    prompts = []
    for _ in range(16):
        unit = [int(t) for t in rng.randint(0, 50257, rng.randint(8, 33))]
        n = int(rng.randint(64, 513))
        prompts.append((unit * (n // len(unit) + 1))[:n])
    return prompts


def _spec_burst(eng, dev, prompts, new=64, logprobs=0):
    """``warmup()``, then every prompt at once, greedy, ``new`` tokens each,
    counts reset just before.  Every request must finish by length with
    ``new`` tokens, no graph may be captured after warmup, no page (or
    draft page) leak, and B1 must launch exactly as ``_b1_want`` says.
    Returns (outputs in prompt order, the run's record)."""
    import torch

    from paddle_tpu_torch.ops.cuda import registry

    registry.reset_counts()
    watcher = eng.warmup()
    graphs = [g for g in (eng._graphs, eng._draft_graphs) if g is not None]
    captures = [g.captures for g in graphs]
    steps0, tok0 = eng.stats["steps"], eng.stats["tokens_generated"]
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=new, logprobs=logprobs)
            for p in prompts]
    outs = {}
    while eng.has_unfinished():
        for o in eng.step():
            outs[o.request_id] = o
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = registry.counts()["paged_ragged_attention"]
    outs = [outs[r] for r in rids]
    bad = [i for i, o in enumerate(outs) if o.finish_reason != "length"
           or len(o.output_ids) != new]
    leaked = eng.num_blocks - eng.block_manager.num_free_blocks
    if eng._draft_bm is not None:
        leaked += eng.num_blocks - eng._draft_bm.num_free_blocks
    after = [g.captures for g in graphs]
    if bad or leaked or after != captures or launches != _b1_want(eng):
        raise RuntimeError(
            f"speculative burst: requests {bad} short, {leaked} pages "
            f"leaked, captures {captures} -> {after}, B1 launches "
            f"{launches} (want {_b1_want(eng)})")
    ttft = [o.metrics["first_token"] - o.metrics["arrival"] for o in outs]
    tpot = [(o.metrics["finished"] - o.metrics["first_token"]) / (new - 1)
            for o in outs]
    generated = eng.stats["tokens_generated"] - tok0
    life = eng.lifecycle_stats()
    record = dict(
        requests=len(prompts), generated_tokens=generated, wall_s=wall,
        tokens_per_s=generated / wall, ttft_ms=_pct(np.asarray(ttft) * 1e3),
        tpot_ms=_pct(np.asarray(tpot) * 1e3),
        steps=eng.stats["steps"] - steps0, spec=eng.spec_stats(),
        staged_steps=life["staged_steps"], staged_hits=life["staged_hits"],
        host_overhead_fraction=life["host_overhead_fraction"],
        kernel_launches=launches, target_launches=eng.stats["launches"],
        draft_launches=eng.stats["draft_launches"],
        warmup_ms=watcher.compile_ms,
        graph_captures_after_warmup=sum(after) - sum(captures),
        graph_pool_bytes=[
            g.pool_bytes() for g in graphs])
    if eng._draft_graphs is not None:
        record.update(
            draft_capture_ms=eng._draft_graphs.capture_ms,
            draft_graph_pool_bytes=eng._draft_graphs.pool_bytes(),
            draft_pool_bytes=sum(
                t.numel() * t.element_size() for t in (
                    eng._draft_pools.k_rows, eng._draft_pools.v_rows,
                    eng._draft_pools.ks_flat, eng._draft_pools.vs_flat)
                if t is not None))
    return [[int(t) for t in o.output_ids] for o in outs], outs, record


def _step_window(eng, dev, prompts, window=16, parts=None):
    """``_decode_windows`` as one record: wall and device ms a step, busy
    share, tokens a step and, given ``parts``, the host split."""
    wall_ms, prof, host, tokens = _decode_windows(eng, dev, prompts, window,
                                                  parts)
    out = _device_profile(prof, window, wall_ms)
    out.pop("top_device_us_per_step")
    return {"tokens_per_step": tokens, **out, "host_ms_per_step": host}


def _verify_vs_decode(eng, prompts, outs, k=4, offsets=(0, 16, 32, 48)):
    """Teacher-forced logits of the same positions run as decode steps
    (one token a row, 8 rows, bucket 8) and as verify rows (1 + ``k``
    tokens a row, bucket 64) on the plain engine, from the same pools:
    8 sequences of ``prompts`` + ``outs[:offset]`` are allocated and
    prefilled chunk by chunk through the engine's step, then
    ``outs[offset:offset + k + 1]`` is fed both ways.  Returns the max
    |Δlogit| over every logit and the share of positions whose argmax
    agrees."""
    import torch

    from paddle_tpu_torch.inference.llm.scheduler import bucket_size

    n, bm, budget = eng.max_batch, eng.block_manager, eng.token_budget
    worst, agree, total = 0.0, 0, 0
    for off in offsets:
        seqs = []
        for i in range(n):
            ids = list(prompts[i]) + outs[i][:off]
            bt = bm.allocate(("teacher", i), len(ids) + k + 1)
            seqs.append((ids, bt))
            for s0 in range(0, len(ids), budget):
                chunk = ids[s0:s0 + budget]
                eng._ragged_fn(eng._pack_rows(
                    [(chunk, s0, bt)],
                    bucket_size(len(chunk), budget, floor=8)))
        rows = [(outs[i][off:off + k + 1], len(ids), bt)
                for i, (ids, bt) in enumerate(seqs)]
        state = [eng._k_rows, eng._v_rows]
        snap = [t.clone() for t in state]
        step_logits = []
        for j in range(k + 1):
            pk = eng._pack_rows([([toks[j]], p0 + j, bt)
                                 for toks, p0, bt in rows], 8)
            _, logits = eng._ragged_fn(pk)
            step_logits.append(logits[:n].float().clone())
        dec = torch.stack(step_logits, 1)                 # [n, k+1, V]
        for t, saved in zip(state, snap):
            t.copy_(saved)
        pk = eng._pack_rows(rows, bucket_size(n * (k + 1), budget,
                                              floor=8))
        _, logits = eng._ragged_fn(pk)
        ver = logits[:n * (k + 1)].float().view(n, k + 1, -1)
        worst = max(worst, float((dec - ver).abs().max()))
        agree += int((dec.argmax(-1) == ver.argmax(-1)).sum())
        total += n * (k + 1)
        for i in range(n):
            bm.free(("teacher", i))
    return worst, agree / total


def _first_divergences(got, want, reference, bound):
    """Per request, the first generated position where ``got`` leaves
    ``want`` and the plain engine's top-2 logit gap there (from its
    ``logprobs=2`` run ``reference``).  Raises if a gap exceeds
    ``bound``: only a near-tie may flip."""
    rows = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next(n for n, (a, b) in enumerate(zip(g, w)) if a != b)
        top = reference[i].logprobs[j][1]
        gap = float(top[0][1] - top[1][1])
        rows.append({"request": i, "position": j, "top2_gap": gap})
        if gap > bound:
            raise RuntimeError(f"request {i} diverges at generated position "
                               f"{j} where the plain top-2 gap {gap} > "
                               f"{bound}")
    return rows


def speculative_phase(dev, smi):
    """GPT-124M (random bf16 weights from seed 0) at the serving
    settings: the speculative burst (``_spec_burst_prompts``, 64 new
    tokens each, greedy) plain, with n-gram K = 4, with a draft model of
    two layers and with ``lookahead=True``, one engine each, in that
    order, each through ``_spec_burst``, the speculative ones then
    through a window of 8 decode rows (``_step_window``).  The plain
    engine measures the verify-vs-decode max |Δlogit|
    (``_verify_vs_decode``); each speculative run's requests must equal
    the plain burst's or first leave it where the plain top-2 gap is
    within twice that (a flip needs the two logits' errors to cover the
    gap); lookahead runs the plain buckets and must equal it exactly.
    Then the plain and lookahead engines' decode windows in six pairs of
    turns with the host split (``lookahead_ab``), and the n-gram engine
    behind ``HttpLLMServer`` for four streamed requests.  Returns B1's
    launches over the bursts and the server run."""
    import gc

    import torch

    from paddle_tpu_torch.inference.llm import HttpLLMServer, LLMEngine
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.ops.cuda import registry

    model = gpt_124m(device=dev, seed=0, dtype=torch.bfloat16).eval()
    prompts = _spec_burst_prompts()
    window_prompts = [p[:128] for p in prompts[:8]]
    runs = (("plain", {}), ("ngram", dict(speculative=4)),
            ("draft_model", dict(speculative={
                "method": "draft-model", "num_tokens": 4,
                "draft_layers": 2})),
            ("lookahead", dict(lookahead=True)))
    total, base, delta, reference, kept = 0, None, None, None, {}
    for label, kw in runs:
        eng = LLMEngine(model, device=dev, **_SERVE_ENGINE, **kw)
        ids, outs, record = _spec_burst(eng, dev, prompts)
        total += record["kernel_launches"]
        if label == "plain":
            base = ids
            delta, agree = _verify_vs_decode(eng, prompts, ids)
            record.update(verify_vs_decode_max_abs_dlogit=delta,
                          verify_vs_decode_argmax_agree=agree)
        diverged = []
        if label == "lookahead":
            if ids != base:
                raise RuntimeError("the lookahead burst differs from the "
                                   "plain one")
        elif label != "plain" and ids != base:
            if reference is None:
                ref = LLMEngine(model, device=dev, **_SERVE_ENGINE)
                ref_ids, reference, _ = _spec_burst(ref, dev, prompts,
                                                    logprobs=2)
                del ref
                if ref_ids != base:
                    raise RuntimeError("the logprobs=2 plain burst differs "
                                       "from the plain one")
            diverged = _first_divergences(ids, base, reference, 2 * delta)
        record["diverging_requests"] = len(diverged)
        record["divergences"] = diverged
        if eng.spec is not None:
            record["window"] = _step_window(eng, dev, window_prompts)
        say("speculative", config=label, model="gpt_124m", dtype="bfloat16",
            card=smi, **record)
        if label != "draft_model":
            kept[label] = eng
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # lookahead against plain in six pairs of turns, which side first
    # alternating, 8 decode rows at depth ~128-224: wall and device ms a
    # step, busy share and the host split
    ab = {"plain": [], "lookahead": []}
    order = (("plain", _STEP_PARTS), ("lookahead", _LOOKAHEAD_PARTS))
    for pair in range(6):
        for label, parts in order[::1 if pair % 2 == 0 else -1]:
            gc.collect()
            ab[label].append(_step_window(kept[label], dev, window_prompts,
                                          window=32, parts=parts))
    walls = {k: [w["wall_ms_per_step"] for w in v] for k, v in ab.items()}
    say("lookahead_ab", card=smi, batch=len(window_prompts), steps=32,
        wall_ms_median={k: float(np.median(v)) for k, v in walls.items()},
        lookahead_wins=sum(la < pl for la, pl in zip(walls["lookahead"],
                                                     walls["plain"])),
        pairs=len(walls["plain"]), **ab)
    spec_eng = kept["ngram"]
    del kept

    # a speculative engine behind the server: four streamed requests
    registry.reset_counts()
    launches0 = spec_eng.stats["launches"]
    srv = HttpLLMServer(engine=spec_eng).start()
    try:
        bodies = [{"prompt_ids": p[:96], "max_new_tokens": 32,
                   "stream": True} for p in prompts[:4]]
        results, wall = _post_all(srv.address, bodies)
    finally:
        srv.close()
    launches = registry.counts()["paged_ragged_attention"]
    want = spec_eng.num_layers * (spec_eng.stats["launches"] - launches0)
    lens = [len(done["completions"][0]["output_ids"])
            for done, _f, _d in results]
    leaked = spec_eng.num_blocks - spec_eng.block_manager.num_free_blocks
    say("speculative_front_end", requests=len(bodies), wall_s=wall,
        output_tokens=lens, kernel_launches=launches, expected=want,
        spec=spec_eng.spec_stats(), leaked_pages=leaked)
    if launches != want or leaked or lens != [32] * len(bodies):
        raise RuntimeError("the speculative engine behind the server did "
                           "not serve every streamed request through B1")
    return total + launches


# ---------------------------------------------- multi-LoRA and the KV tier --
def _lora_weights(eng, seed, a_scale, b_scale):
    """One adapter's seeded halves for every target of ``eng``: A
    ``[L, in, r]`` at ``a_scale``, B ``[L, r, out]`` at ``b_scale``, f32
    numpy (``add_adapter``'s form)."""
    rng = np.random.RandomState(seed)
    out = {}
    for key in eng.lora.targets:
        L, d_in, d_out = eng._lora_shapes[key]
        r = eng.lora.rank
        out[key] = ((rng.standard_normal((L, d_in, r)) * a_scale)
                    .astype(np.float32),
                    (rng.standard_normal((L, r, d_out)) * b_scale)
                    .astype(np.float32))
    return out


def _merged_model(model, weights, scale, dev):
    """A copy of the exactness model (gpt_tiny widths, 2 layers) whose
    block GEMM weights are the dense merge ``W + scale * A @ B`` in f32:
    the dense reference a LoRA row must equal token for token."""
    from paddle_tpu_torch.models.gpt import gpt_tiny

    params = {g: {k: v.detach().cpu().numpy() for k, v in sub.items()}
              for g, sub in model.functional_decompose()["params"].items()}
    for key, (a, b) in weights.items():
        params["blocks"][key] = params["blocks"][key] + np.einsum(
            "lir,lro->lio", a, b).astype(np.float32) * np.float32(scale)
    merged = gpt_tiny(device=dev, num_layers=2, seed=0,
                      initializer_range=0.1)
    merged.load_stacked(params)
    return merged.eval()


def _drive(eng, check=None):
    """Step ``eng`` until nothing is left -> {request id: output};
    ``check()`` runs after every step."""
    outs = {}
    while eng.has_unfinished():
        for o in eng.step():
            outs[o.request_id] = o
        if check is not None:
            check()
    return outs


def _tiny_packed_step(eng, tb, rng, slots):
    """A packed step of bucket ``tb`` for the gpt_tiny engines: a chunk
    of ``tb - 4`` tokens at position 8 and decode rows at depths 30 and
    13, each row on pages of its own, on the adapter ``slots``."""
    pages = eng.max_pages
    rows = [(rng.randint(0, eng.vocab_size, tb - 4), 8),
            (rng.randint(0, eng.vocab_size, 1), 30),
            (rng.randint(0, eng.vocab_size, 1), 13)]
    adapter_rows = np.zeros(eng.max_batch, np.int32)
    adapter_rows[:len(slots)] = slots
    return eng._pack_rows(
        [(toks, pos0, (np.arange(pages) + r * pages) % eng.num_blocks)
         for r, (toks, pos0) in enumerate(rows)], tb,
        adapter_rows=adapter_rows)


def lora_exactness_phase(dev):
    """Multi-LoRA on the exactness phase's f32 model (gpt_tiny widths, 2
    layers) and settings: three adapters over ``max_adapters=3`` (two
    usable slots, so the distinct-adapter gate and LRU evictions run) on
    its prompts and ``TestSpeculative``'s, a batch mixing base and
    adapter rows, 16 new tokens.  Every request's greedy tokens must
    equal the dense forward with the merged weights ``W + A @ B``
    (scale 1); the same run with lookahead and with n-gram K = 4 must
    equal it; every step a replay but each bucket's first; B1 launched L
    x the engine's launches.  Then, after one more adapter load that
    evicts, a packed step on the loaded slot replays bitwise equal to
    the eager body from the same pools.  Returns B1's launches."""
    import types

    import torch

    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.ops.cuda import registry

    model, prompts = _exactness_model_and_prompts(dev)
    prompts = prompts + _spec_prompts()
    aids = [None, "t0", "t1", "t2"] * 2 + [None]
    new, tiny = 16, dict(block_size=8, max_batch=4, token_budget=16)
    lora = dict(rank=4, max_adapters=3)
    probe = LLMEngine(model, device=dev, lora=lora, **tiny)
    adapters = {f"t{i}": _lora_weights(probe, 30 + i, 0.3, 0.3)
                for i in range(3)}
    scale = probe.lora.scale
    del probe
    dense_models = {None: model}
    dense_models.update({aid: _merged_model(model, w, scale, dev)
                         for aid, w in adapters.items()})
    dense = [dense_models[a].greedy_decode(p, new)
             for p, a in zip(prompts, aids)]
    total, first = 0, None
    for label, kw in (("plain", {}), ("lookahead", dict(lookahead=True)),
                      ("ngram", dict(speculative=4))):
        eng = LLMEngine(model, device=dev, lora=lora, **tiny, **kw)
        for aid, w in adapters.items():
            eng.add_adapter(aid, w)
        registry.reset_counts()
        rids = [eng.add_request(p, max_new_tokens=new, adapter_id=a)
                for p, a in zip(prompts, aids)]
        outs = _drive(eng)
        launches = registry.counts()["paged_ragged_attention"]
        total += launches
        got = [outs[r].all_ids for r in rids]
        for out, ref, a in zip(got, dense, aids):
            if not np.array_equal(out, ref):
                _report_first_flip(dense_models[a], out, ref, dev)
        if first is None:
            first, plain = got, eng
        elif not all(np.array_equal(a, b) for a, b in zip(got, first)):
            raise RuntimeError(f"{label} differs from the plain LoRA run")
        _require_replays(eng._graphs, eng.stats["launches"])
        st = eng.lora_stats()
        life = eng.lifecycle_stats()
        say("lora_exactness", config=label, prompts=len(prompts),
            adapters=aids, steps=eng.stats["steps"], lora=st,
            spec=eng.spec_stats(), staged_hits=life["staged_hits"],
            kernel_launches=launches, engine_launches=eng.stats["launches"],
            graph_replays=eng._graphs.replays,
            graph_captures=eng._graphs.captures)
        if launches != _b1_want(eng):
            raise RuntimeError(f"{label}: B1 launches {launches} != "
                               f"{_b1_want(eng)}")
        if not st["evictions"]:
            raise RuntimeError(f"{label}: no adapter was evicted")
        if label == "lookahead" and not life["staged_hits"]:
            raise RuntimeError("lookahead claimed no staged plan")
        if label == "ngram" and not eng.spec_stats()["draft_tokens"]:
            raise RuntimeError("n-gram drafted nothing")
        if eng.block_manager.num_free_blocks != eng.num_blocks:
            raise RuntimeError(f"{label}: pages leaked")

    # the replay reads the pools by address: load the adapter that is
    # not resident (evicting one), then a packed step on its slot
    mgr, eng = plain._lora_mgr, plain
    eng.warmup()
    gone = next(a for a in adapters if mgr.slot_of(a) is None)
    loads = mgr.stats["loads"]
    slot = eng._lora_slot(types.SimpleNamespace(adapter_id=gone), ())
    other = next(s for a, s in mgr.resident().items() if a != gone)
    rng = np.random.RandomState(77)
    state = [eng._kc, eng._vc]
    failed = []
    for _, tb in eng._bucket_grid():
        pk = _tiny_packed_step(eng, tb, rng, [slot, 0, other])
        ints = torch.from_numpy(pk["ints"]).to(dev)
        replays = eng._graphs.replays
        ok, _ = _replay_against_eager(
            state, lambda: eng._ragged_body(ints),
            lambda: eng._ragged_fn(pk))
        ok = ok and eng._graphs.replays == replays + 1
        say("lora_graphs", bucket=tb, loaded=gone, slot=slot,
            slots=[slot, 0, other], bitwise=ok)
        if not ok:
            failed.append(tb)
    if mgr.stats["loads"] != loads + 1 or failed:
        raise RuntimeError(f"replay after an adapter load differs from the "
                           f"eager step body at buckets {failed}")
    return total


def _lora_ids(n=16):
    """The LoRA burst's adapters: every fourth request on the base model,
    the other 12 over six adapters."""
    return [None if i % 4 == 0 else f"a{(i - 1 - i // 4) % 6}"
            for i in range(n)]


def lora_serving_phase(dev, smi):
    """GPT-124M bf16 (random weights from seed 0) at the serving settings
    with ``lora=dict(rank=8, max_adapters=4)`` (three usable slots) and
    six registered adapters (seeded: A at 1/sqrt(in), B at 0.02): the
    16-request burst of ``serving`` with 4 base requests and 12 over the
    six adapters, beside the plain engine on the same prompts (tokens/s,
    TTFT, TPOT, graph pool bytes); no capture after ``warmup()``; the
    adapter pools' bytes on the card equal to ``lora_pool_bytes``; the
    ms of one adapter load; decode windows of 8 rows (3 adapters and the
    base) with and without LoRA under torch.profiler; one adapter
    request and one unknown adapter (400) through ``HttpLLMServer``; and
    the int8 engine with the same adapters on the same burst (B5).
    Returns the bursts' B1 and B5 launches."""
    import torch

    from paddle_tpu_torch.inference.llm import HttpLLMServer, LLMEngine
    from paddle_tpu_torch.models.gpt import gpt_124m

    model = gpt_124m(device=dev, seed=0, dtype=torch.bfloat16).eval()
    rng = np.random.RandomState(99)
    wprompts = [rng.randint(0, 50257, 128).tolist() for _ in range(8)]
    waids = ["a0", "a1", "a2", None] * 2

    plain = LLMEngine(model, device=dev, **_SERVE_ENGINE)
    _l, _p, _s, _o, plain_rec = _serve_burst(plain, dev,
                                             "paged_ragged_attention")
    wall_ms, prof, _, _ = _decode_windows(plain, dev, wprompts, 16)
    plain_window = _device_profile(prof, 16, wall_ms)
    plain_share = _kernel_share(prof, "ragged_split_kernel",
                                "ragged_combine")
    del plain
    torch.cuda.empty_cache()

    lora = dict(rank=8, max_adapters=4)
    eng = LLMEngine(model, device=dev, lora=lora, **_SERVE_ENGINE)
    adapters = {}
    for i in range(6):
        rng_i = np.random.RandomState(500 + i)
        adapters[f"a{i}"] = {
            key: ((rng_i.standard_normal((L, d_in, 8))
                   / np.sqrt(d_in)).astype(np.float32),
                  (rng_i.standard_normal((L, 8, d_out)) * 0.02)
                  .astype(np.float32))
            for key, (L, d_in, d_out) in eng._lora_shapes.items()}
        eng.add_adapter(f"a{i}", adapters[f"a{i}"])
    mm = eng.memory_model()
    pool_bytes = sum(t.numel() * t.element_size()
                     for k, t in eng.params["blocks"].items()
                     if k.startswith("lora.") and t.device == eng.device)
    aids = _lora_ids()
    launches, _p, _s, outs, rec = _serve_burst(
        eng, dev, "paged_ragged_attention", adapters=aids)
    st = eng.lora_stats()
    # one adapter load: the slot a6 would take, timed after the card is idle
    slot, weights = 1, eng._lora_mgr._adapters["a0"]
    times = []
    for _ in range(5):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        eng._load_adapter_slot(slot, weights)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    # the slot's books still say what it holds: put its adapter back
    held = next(a for a, s in eng._lora_mgr.resident().items() if s == slot)
    eng._load_adapter_slot(slot, eng._lora_mgr._adapters[held])
    wall_ms, prof, _, _ = _decode_windows(eng, dev, wprompts, 16,
                                          adapters=waids)
    lora_window = _device_profile(prof, 16, wall_ms)
    lora_share = _kernel_share(prof, "ragged_split_kernel",
                               "ragged_combine")
    say("lora_serving", model="gpt_124m", dtype="bfloat16", lora=lora,
        adapters=len(adapters), request_adapters=aids, nvidia_smi=smi,
        lora_stats=st, lora_pool_bytes=mm["lora_pool_bytes"],
        lora_pool_bytes_on_card=pool_bytes,
        weights_bytes=mm["weights_bytes"], **rec)
    say("lora_serving_plain", **plain_rec)
    say("lora_decode_window", batch=8, adapters=waids, steps=16,
        lora=lora_window, plain=plain_window,
        device_ms_delta=(lora_window["device_ms_per_step"]
                         - plain_window["device_ms_per_step"]),
        ragged_kernel_device_share_lora=lora_share,
        ragged_kernel_device_share_plain=plain_share,
        adapter_load_ms=times, adapter_load_ms_median=float(np.median(times)),
        adapter_bytes=sum(2 * (a.size + b.size)
                          for a, b in weights.values()),
        graph_pool_bytes_lora=rec["graph_pool_bytes"],
        graph_pool_bytes_plain=plain_rec["graph_pool_bytes"])
    if pool_bytes != mm["lora_pool_bytes"]:
        raise RuntimeError(f"adapter pools hold {pool_bytes} bytes on the "
                           f"card, the memory model says "
                           f"{mm['lora_pool_bytes']}")
    if not st["evictions"] or rec["graph_captures_after_warmup"]:
        raise RuntimeError(f"LoRA burst: {st}, "
                           f"{rec['graph_captures_after_warmup']} captures "
                           f"after warmup()")

    srv = HttpLLMServer(engine=eng).start()
    try:
        good = _http(srv.address, "POST", "/v1/completions",
                     {"prompt_ids": wprompts[0], "max_new_tokens": 8,
                      "adapter": "a3"})
        bad = _http(srv.address, "POST", "/v1/completions",
                    {"prompt_ids": wprompts[0], "adapter": "ghost"})
    finally:
        srv.close()
    want = eng.generate([wprompts[0]], max_new_tokens=8,
                        adapter_id="a3")[0][128:]
    say("lora_http", adapter_status=good[0],
        output_ids=good[1]["completions"][0]["output_ids"],
        generate_ids=want.tolist(), unknown_status=bad[0],
        unknown_error=bad[1].get("error"))
    if (good[0] != 200 or bad[0] != 400
            or good[1]["completions"][0]["output_ids"] != want.tolist()
            or eng.block_manager.num_free_blocks != eng.num_blocks):
        raise RuntimeError("HttpLLMServer did not serve the adapter as "
                           "generate() does, or took an unknown adapter")
    del eng
    torch.cuda.empty_cache()

    eng8 = LLMEngine(model, device=dev, lora=lora, quantize="int8",
                     **_SERVE_ENGINE)
    for aid, w in adapters.items():
        eng8.add_adapter(aid, w)
    launches8, _p, _s, _o, rec8 = _serve_burst(
        eng8, dev, "paged_ragged_attention_quant", adapters=aids)
    say("lora_serving", model="gpt_124m", dtype="bfloat16",
        quantize="int8", lora=lora, lora_stats=eng8.lora_stats(), **rec8)
    if rec8["graph_captures_after_warmup"]:
        raise RuntimeError("the int8 LoRA burst captured after warmup()")
    return (launches["paged_ragged_attention"],
            launches8["paged_ragged_attention_quant"])


_TIER_PROMPTS = [list(range(3, 19)), list(range(5, 21)), list(range(7, 23))]


def tier_exactness_phase(dev):
    """The host-RAM KV tier on the exactness phase's f32 model
    (``tests/test_kv_tier.py``'s settings): an engine starved to 12 pages
    under ``policy="always"`` must emit bitwise the tokens of one with 64
    pages on three 16-token prompts, 24 new tokens each, with chains
    demoted and swapped back in, ``check_invariants()`` after every step,
    every page back at the end, every step a replay but each bucket's
    first and the kernel on every layer of every launch; then the same
    with int8 pools (B5, scale pages moving with the pages).  Returns
    the (B1, B5) launches of the starved runs."""
    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.ops.cuda import registry

    model, _ = _exactness_model_and_prompts(dev)
    tiny = dict(block_size=8, max_batch=4, token_budget=16, max_model_len=64)
    tier = {"host_bytes": "8MiB", "store_bytes": "8MiB", "policy": "always"}
    counts = []
    for quantize, kernel in ((None, "paged_ragged_attention"),
                             ("int8", "paged_ragged_attention_quant")):
        ref = LLMEngine(model, device=dev, num_blocks=64, quantize=quantize,
                        **tiny).generate(_TIER_PROMPTS, max_new_tokens=24)
        eng = LLMEngine(model, device=dev, num_blocks=12, kv_tier=tier,
                        quantize=quantize, **tiny)
        registry.reset_counts()
        rids = [eng.add_request(p, max_new_tokens=24) for p in _TIER_PROMPTS]
        outs = _drive(eng, eng.check_invariants)
        launches = registry.counts()[kernel]
        counts.append(launches)
        ts = eng.tier_stats()
        same = all(np.array_equal(outs[r].all_ids, w)
                   for r, w in zip(rids, ref))
        say("tier_exactness", quantize=quantize or "none", bitwise=same,
            preemptions=eng.scheduler.num_preemptions, tier=ts,
            kernel_launches=launches, engine_launches=eng.stats["launches"],
            graph_replays=eng._graphs.replays,
            graph_captures=eng._graphs.captures)
        if not same:
            raise RuntimeError(f"starved tiered engine ({quantize}) differs "
                               f"from the unconstrained one")
        if not (ts["host_pool"]["demoted_chains"]
                and ts["host_pool"]["swapped_in_chains"]):
            raise RuntimeError(f"the tier moved no chain: {ts}")
        if launches != eng.num_layers * eng.stats["launches"] \
                or eng.block_manager.num_free_blocks != eng.num_blocks \
                or ts["host_pool"]["chains"]:
            raise RuntimeError("tier run: kernel launches off, or pages or "
                               "chains left behind")
        _require_replays(eng._graphs, eng.stats["launches"])
    return tuple(counts)


def _link_rates(dev, nbytes=256 << 20, reps=5):
    """Pinned host<->device copy rates in GB/s (median of ``reps`` copies
    of ``nbytes`` each way, timed with CUDA events after one warm copy)."""
    import torch

    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    rates = {}
    for name, dst, src in (("h2d", card, host), ("d2h", host, card)):
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize(dev)
        ms = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        rates[name] = nbytes / (float(np.median(ms)) / 1e3) / 1e9
    del host, card
    return rates


def _timed_hook(eng, hook, kind, out):
    """Wrap the scheduler's tier hook ``hook`` for the run: the host ms
    of each call that logged a ``kind`` event, with the card idle at its
    start and synchronized at its end, go to ``out``."""
    import torch

    fn = getattr(eng.scheduler, hook)

    def call(*args):
        torch.cuda.synchronize(eng.device)
        n = len(eng.events)
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize(eng.device)
        if any(e[1] == kind for e in eng.events[n:]):
            out.append((time.perf_counter() - t0) * 1e3)
        return res

    setattr(eng.scheduler, hook, call)


def kv_tier_phase(dev, smi):
    """The host-RAM KV tier at GPT-124M bf16 (random weights from seed 0):
    the pinned host<->device copy rates behind ``DEVICE_PROFILES["h100"]``;
    the serving burst on an engine starved to 96 pages (one full-length
    sequence is 64) so that it preempts, under ``policy="always"`` (every
    committed chain demoted and swapped back in) and ``"never"``
    (recompute): tokens/s, preemptions, chains demoted and swapped in,
    the host bytes moved (``last_tier_bytes`` summed over steps), the ms
    of each demote and swap-in, and no page or chain left behind; the
    ``"auto"`` decision under ``"h100"`` for a chain of the burst's mean
    size.  Returns the bursts' B1 launches."""
    import torch

    from paddle_tpu_torch.framework.cost import DEVICE_PROFILES
    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.inference.llm.kv_tier import TierPolicy
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.ops.cuda import registry

    rates = _link_rates(dev)
    say("kv_tier_link", nvidia_smi=smi, pinned_gb_per_s=rates,
        profile_link_gb_per_s=DEVICE_PROFILES["h100"]["ici_bytes_per_s"]
        / 1e9)
    model = gpt_124m(device=dev, seed=0, dtype=torch.bfloat16).eval()
    prompts, _ = _burst_prompts()
    total, chains = 0, []
    for mode in ("always", "never"):
        eng = LLMEngine(model, device=dev, num_blocks=96,
                        kv_tier={"host_bytes": "2GiB", "store_bytes": "1GiB",
                                 "policy": mode}, **_SERVE_ENGINE)
        demote_ms, swap_ms = [], []
        _timed_hook(eng, "demote_hook", "demote", demote_ms)
        _timed_hook(eng, "swap_in_hook", "swap_in", swap_ms)
        eng.warmup()
        captures, steps0 = eng._graphs.captures, eng.stats["launches"]
        registry.reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        rids = [eng.add_request(p, max_new_tokens=64) for p in prompts]
        moved = 0
        outs = {}
        while eng.has_unfinished():
            for o in eng.step():
                outs[o.request_id] = o
            moved += eng.last_tier_bytes
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = registry.counts()["paged_ragged_attention"]
        total += launches
        ts = eng.tier_stats()
        demotes = [e for e in eng.events if e[1] == "demote"]
        chains += [e[3] for e in demotes]
        say("kv_tier", model="gpt_124m", dtype="bfloat16", policy=mode,
            num_blocks=eng.num_blocks, page_bytes=eng.page_bytes,
            requests=len(rids), wall_s=wall,
            tokens_per_s=eng.stats["tokens_generated"] / wall,
            preemptions=eng.scheduler.num_preemptions, tier=ts,
            demoted_pages=sum(e[3] for e in demotes),
            swapped_in_pages=sum(e[3] for e in eng.events
                                 if e[1] == "swap_in"),
            tier_bytes=moved, demote_ms=demote_ms, swap_in_ms=swap_ms,
            demote_ms_median=(float(np.median(demote_ms)) if demote_ms
                              else None),
            swap_in_ms_median=(float(np.median(swap_ms)) if swap_ms
                               else None),
            kernel_launches=launches,
            engine_launches=eng.stats["launches"] - steps0,
            graph_captures_after_warmup=eng._graphs.captures - captures)
        bad = [r for r in rids if outs[r].finish_reason != "length"
               or len(outs[r].output_ids) != 64]
        if (bad or not eng.scheduler.num_preemptions
                or launches != eng.num_layers * (eng.stats["launches"]
                                                 - steps0)
                or eng.block_manager.num_free_blocks != eng.num_blocks
                or ts["host_pool"]["chains"]
                or eng._graphs.captures != captures):
            raise RuntimeError(
                f"{mode}: requests {bad} short, or preemptions "
                f"{eng.scheduler.num_preemptions}, B1 launches {launches} "
                f"for {eng.stats['launches'] - steps0} engine launches, "
                f"{eng._graphs.captures - captures} captures after "
                f"warmup(), {eng.block_manager.num_free_blocks} of "
                f"{eng.num_blocks} pages free, {ts['host_pool']['chains']} "
                f"chains left")
        if mode == "always" and not (ts["host_pool"]["demoted_chains"]
                                     and ts["host_pool"]["swapped_in_chains"]):
            raise RuntimeError(f"the tier moved no chain: {ts}")
        del eng
        torch.cuda.empty_cache()
    pages = int(round(float(np.mean(chains)))) if chains else 1
    probe = LLMEngine(model, device=dev, num_blocks=96, **_SERVE_ENGINE)
    est = TierPolicy(mode="auto", profile="h100").estimate(
        probe, pages * probe.block_size, pages)
    say("kv_tier_auto", profile="h100", chain_pages=pages,
        chain_tokens=pages * probe.block_size, estimate=est,
        decision=TierPolicy(mode="auto", profile="h100").decide(
            probe, pages * probe.block_size, pages))
    return total


def decode_profile_phase(eng, dev, window=16, engine="bf16"):
    """Where a decode step's time goes at GPT-124M width: 8 requests
    with 128-token prompts are prefilled, then ``window`` decode steps
    run on the host clock, ``window`` more under torch.profiler and
    ``window`` more with the host's share split by part
    (:func:`_host_split`).  Reports wall ms per step, device-busy ms per
    step (sum of device time in the profiled window), the kernels that
    take the most device time and the ragged kernel's share, which the
    profiler must see inside the replays.  Then the same 8 prompts again
    (their prefixes now cached, so the decode steps sit at the same
    positions) with the step body dispatched op by op instead of
    replayed (``decode_profile_eager``): the replay's yardstick in the
    same call.  Outside the main path: its launches are not counted in
    the ``kernels`` line."""
    rng = np.random.RandomState(99)
    prompts = [list(rng.randint(0, 50257, 128)) for _ in range(eng.max_batch)]
    wall_ms, prof, host_ms, _ = _decode_windows(eng, dev, prompts, window,
                                                _STEP_PARTS)
    share = _kernel_share(prof, "ragged_split_kernel", "ragged_combine")
    say("decode_profile", engine=engine, batch=eng.max_batch, steps=window,
        ragged_kernel_device_share=share,
        host_ms_per_step=host_ms, **_device_profile(prof, window, wall_ms))
    if not share:
        raise RuntimeError("torch.profiler saw no ragged attention kernel "
                           "in the replayed decode window")
    eng._ragged_fn = _eager_ragged_fn(eng)
    try:
        wall_ms, prof, _, _ = _decode_windows(eng, dev, prompts, window)
    finally:
        del eng._ragged_fn
    say("decode_profile_eager", engine=engine, batch=eng.max_batch,
        steps=window, ragged_kernel_device_share=_kernel_share(
            prof, "ragged_split_kernel", "ragged_combine"),
        **_device_profile(prof, window, wall_ms))


def _decode_windows(eng, dev, prompts, window, parts=None, adapters=None):
    """Prefill ``prompts`` (on the LoRA ``adapters``, given them), then
    ``window`` decode steps on the host clock, ``window`` under
    torch.profiler and, given ``parts``, ``window`` under
    :func:`_host_split`; the requests are then aborted.  Returns (wall ms
    per step, the profiler, the host split or None, tokens a step in the
    first window).  Room for 12 tokens a step: a speculative step emits
    up to 1 + K."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rids = [eng.add_request(p, max_new_tokens=12 * window,
                            adapter_id=adapters[i] if adapters else None)
            for i, p in enumerate(prompts)]
    while eng.scheduler.waiting or not all(
            r.prefill_done for r in eng.scheduler.running):
        eng.step()
    torch.cuda.synchronize(dev)
    tok0 = eng.stats["tokens_generated"]
    t0 = time.perf_counter()
    for _ in range(window):
        eng.step()
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) / window * 1e3
    tokens = (eng.stats["tokens_generated"] - tok0) / window
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(window):
            eng.step()
        torch.cuda.synchronize(dev)
    host_ms = _host_split(eng, window, parts) if parts else None
    for r in rids:
        eng.abort_request(r)
    while eng.has_unfinished():
        eng.step()
    return wall_ms, prof, host_ms, tokens


def _eager_ragged_fn(eng):
    """A stand-in for ``eng._ragged_fn`` that copies the packed operands
    to the card and dispatches the step body op by op, with no graph:
    the yardstick a replay is read against.  Greedy steps without
    copy-on-write only, as the decode windows run."""
    import torch

    def run(pk):
        if pk["cows"] or pk["pipeline"] is not None:
            raise RuntimeError("the eager yardstick takes plain greedy steps")
        eng.stats["launches"] += 1
        return eng._ragged_body(torch.from_numpy(pk["ints"]).to(eng.device))
    return run


# the parts of LLMEngine.step timed by _host_split: (object attribute,
# name); the pull waits for the replay to finish on the card
_STEP_PARTS = (("scheduler.schedule", "schedule"), ("_pack_ragged", "pack"),
               ("_ragged_fn", "copy_replay"), ("_pull", "argmax_pull"),
               ("_commit", "commit"))


# a lookahead engine's step: the claim replaces schedule and pack, and
# the next step's plan and pack run between the replay and the pull
_LOOKAHEAD_PARTS = (("scheduler.schedule", "schedule"),
                    ("_claim_staged", "claim"), ("_ragged_fn", "copy_replay"),
                    ("_stage_next", "stage_next"), ("_pull", "argmax_pull"),
                    ("_commit", "commit"))


def _host_split(eng, steps, step_parts=_STEP_PARTS):
    """Host ms per step of each part of ``steps`` engine steps, on the
    host clock around each part's call, and of the rest of the step
    (``other``): the engine's methods are wrapped on the instance for
    the window and unwrapped after."""
    import torch

    parts = dict.fromkeys([name for _, name in step_parts], 0.0)
    wrapped = []

    def timed(fn, name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                parts[name] += time.perf_counter() - t0
        return call

    for path, name in step_parts:
        *owner, attr = path.split(".")
        obj = eng if not owner else getattr(eng, owner[0])
        setattr(obj, attr, timed(getattr(obj, attr), name))
        wrapped.append((obj, attr))
    try:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize(eng.device)
        wall = time.perf_counter() - t0
    finally:
        for obj, attr in wrapped:
            delattr(obj, attr)
    out = {name: t / steps * 1e3 for name, t in parts.items()}
    out["other"] = (wall - sum(parts.values())) / steps * 1e3
    out["wall"] = wall / steps * 1e3
    return out


def _device_profile(prof, steps, wall_ms):
    """Device ms per step, its share of the unprofiled wall ms per step,
    and the device ops that take the most time, from a torch.profiler
    window of ``steps`` steps.  Only device-side entries (kernels,
    memcpy, memset) count: an operator's own row would count its
    kernels a second time."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    rows = {}
    for e in top:      # names cut to 110 characters; equal cuts add up
        key = e.key[:110]
        rows[key] = rows.get(key, 0.0) + e.self_device_time_total / steps
    return {"wall_ms_per_step": wall_ms,
            "device_ms_per_step": (device_us / 1e3 / steps if device_us
                                   else None),
            "device_busy_share": (device_us / 1e3 / steps / wall_ms
                                  if device_us else None),
            "top_device_us_per_step": rows}


def _kernel_share(prof, *names):
    """Device time of the kernels whose name holds one of ``names``, over
    all device time, in a torch.profiler window."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events)
    mine = sum(e.self_device_time_total for e in events
               if any(n in e.key for n in names))
    return mine / total if total else None


def _kernel_us(prof, name, steps):
    """Device µs per step of each kernel whose name holds ``name``, keyed
    by its name from ``name`` up to its argument list."""
    from torch.autograd import DeviceType

    rows = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and name in e.key:
            key = e.key[e.key.index(name):].split("(")[0]
            rows[key] = rows.get(key, 0.0) + e.self_device_time_total / steps
    return rows


# ------------------------------------------------------------ front end --
# three token ids render as two-letter pieces for the stop-string check
_TOY_PIECES = {20: "ab", 21: "cd", 22: "ef"}


def _toy_detokenizer(ids):
    """The front end's detokenizer: ``_TOY_PIECES``, every other id '?'."""
    return "".join(_TOY_PIECES.get(int(t), "?") for t in ids)


# a grammar forcing the emission 20, 21, 22, eos: the stop string "bc"
# lives only in the joint rendering of 20 and 21 and must end the
# request after them
_FORCED = {0: {20: 1}, 1: {21: 2}, 2: {22: 3}, 3: {1: 4}, 4: {1: 4}}
_JSON_SPEC = {"kind": "json_array", "open": 10, "close": 11, "comma": 12,
              "items": [20, 21, 22], "eos": 1, "max_items": 4}


def _front_end_requests(seed, vocab):
    """The front end's burst: (label, request body, expected finish
    reason of each completion) for every part of the request surface."""
    rng = np.random.RandomState(seed)

    def prompt(n):
        return [int(t) for t in rng.randint(0, 50257, n)]

    forced = {"kind": "dfa", "vocab_size": vocab, "start": 0,
              "transitions": {str(s): {str(t): d for t, d in e.items()}
                              for s, e in _FORCED.items()}}
    reqs = [("greedy", {"prompt_ids": prompt(n), "max_new_tokens": 48,
                        "stream": True}, ["length"])
            for n in (40, 96, 150, 220, 300, 64)]
    reqs += [
        ("temperature", {"prompt_ids": prompt(80), "max_new_tokens": 48,
                         "temperature": 0.8, "seed": 11}, ["length"]),
        ("filters", {"prompt_ids": prompt(120), "max_new_tokens": 48,
                     "temperature": 1.0, "top_k": 50, "top_p": 0.9,
                     "logit_bias": {"5": 2.0, "7": -3.0}, "seed": 12},
         ["length"]),
        ("logprobs", {"prompt_ids": prompt(60), "max_new_tokens": 32,
                      "logprobs": 5}, ["length"]),
        ("stop", {"prompt_ids": prompt(30), "max_new_tokens": 8,
                  "grammar": forced, "eos_token_id": 1, "stop": ["bc"]},
         ["stop"]),
        ("grammar", {"prompt_ids": prompt(50), "max_new_tokens": 16,
                     "grammar": _JSON_SPEC, "eos_token_id": 1}, ["stop"]),
        ("n2", {"prompt_ids": prompt(70), "max_new_tokens": 32, "n": 2,
                "temperature": 0.8, "seed": 13}, ["length", "length"]),
        ("deadline", {"prompt_ids": prompt(40), "max_new_tokens": 512,
                      "deadline_ms": 50}, ["deadline"]),
    ]
    return reqs


def _http(addr, method, path, body=None):
    """One HTTP request to the server -> (status, parsed JSON body)."""
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=300)
    try:
        conn.request(method, path, None if body is None else
                     json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _http_stream(addr, body):
    """POST a ``stream: true`` request -> (its SSE events, seconds from
    the send to the first token delta, seconds to the final event)."""
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"stream request got {resp.status}: "
                               f"{resp.read()!r}")
        events, first, final = [], None, None
        for line in resp:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                events.append(data)
                break
            ev = json.loads(data)
            now = time.perf_counter() - t0
            if "delta_ids" in ev and first is None:
                first = now
            if "completions" in ev:
                final = now
            events.append(ev)
        return events, first, final
    finally:
        conn.close()


def _post_all(addr, bodies):
    """POST every body from a thread of its own, all at once ->
    (results in body order, wall seconds).  A streamed body's result is
    ``(final body, ttft s, done s)``, any other's ``(status, body)``."""
    import threading

    results, errors = [None] * len(bodies), []

    def run(i, body):
        try:
            if body.get("stream"):
                events, first, final = _http_stream(addr, body)
                if events[-1] != "[DONE]":
                    raise RuntimeError(f"stream {i} did not end in [DONE]")
                deltas = [t for e in events[:-2] for t in e["delta_ids"]]
                done = events[-2]
                if deltas != done["completions"][0]["output_ids"]:
                    raise RuntimeError(f"stream {i}: deltas do not "
                                       f"reassemble the final ids")
                results[i] = (done, first, final)
            else:
                results[i] = _http(addr, "POST", "/v1/completions", body)
        except Exception as e:      # noqa: BLE001 — re-raised below
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i, b), daemon=True)
               for i, b in enumerate(bodies)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"front-end clients failed: {errors}")
    return results, wall


def _engine_kwargs(body, vocab):
    """A wire body as ``add_request`` keywords."""
    from paddle_tpu_torch.inference.llm import grammar_from_spec

    kw = {k: v for k, v in body.items() if k not in ("prompt_ids",
                                                      "stream")}
    if "grammar" in kw:
        kw["grammar"] = grammar_from_spec(kw["grammar"], vocab_size=vocab)
    return kw


def _pct(xs):
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))}


def _check_completions(label, comps, expect, vocab):
    """Each completion's finish reason, and what its part of the surface
    promises: grammar-legal output, the stop string, normalized
    logprobs, the fork's id."""
    from paddle_tpu_torch.inference.llm import (
        DfaTokenGrammar,
        grammar_from_spec,
    )

    reasons = [c["finish_reason"] for c in comps]
    if reasons != expect:
        raise RuntimeError(f"{label}: finish reasons {reasons} != {expect}")
    for c in comps:
        ids = c["output_ids"]
        if not all(0 <= t < vocab for t in ids):
            raise RuntimeError(f"{label}: token ids outside the vocab")
        if label in ("grammar", "stop"):
            g = (grammar_from_spec(_JSON_SPEC, vocab_size=vocab)
                 if label == "grammar" else DfaTokenGrammar(vocab, _FORCED))
            s = g.start_state()
            for t in ids:
                s = g.advance(s, t)
                if s is None:
                    raise RuntimeError(f"{label}: {ids} leaves the grammar")
        if label == "stop" and (ids != [20, 21]
                                or c["matched_stop"] != "bc"):
            raise RuntimeError(f"stop: {ids}, matched "
                               f"{c['matched_stop']!r}")
        if label == "logprobs":
            if len(c["logprobs"]) != len(ids):
                raise RuntimeError("logprobs: one entry per token expected")
            for t, entry in zip(ids, c["logprobs"]):
                top = entry["top"]
                mass = sum(np.exp(lp) for _, lp in top)
                lps = [lp for _, lp in top]
                if (len(top) != 5 or not 0.0 < mass <= 1.0 + 1e-6
                        or lps != sorted(lps, reverse=True)
                        or top[0][0] != t
                        or abs(entry["logprob"] - lps[0]) > 1e-9):
                    raise RuntimeError(f"logprobs not normalized: {entry}")
    if label == "n2" and not comps[1]["request_id"].endswith(".1"):
        raise RuntimeError(f"n2: second completion {comps[1]['request_id']}")


def _async_window(eng, serve, steps=256):
    """Decode steps replayed by the async worker while ``serve(bodies)``
    runs 8 requests (128-token prompts, 600 new tokens; every other one
    streamed when it goes through the server) to their end.  The prompts
    are served once first with one new token, so the run's prefill is
    each prompt's last page.  torch.profiler covers the whole run,
    started and stopped while the worker is idle: device ms per engine
    step over the run; wall ms per step on the host clock over
    ``steps`` steps once every request is decoding; the busy share."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(77)
    bodies = [{"prompt_ids": [int(t) for t in rng.randint(0, 50257, 128)],
               "max_new_tokens": 600, "stream": i % 2 == 0}
              for i in range(eng.max_batch)]
    serve([{**b, "max_new_tokens": 1} for b in bodies])
    out = {}
    clients = threading.Thread(
        target=lambda: out.update(r=serve(bodies)), daemon=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s_run = eng.stats["launches"]
        clients.start()
        t_end = time.perf_counter() + 120
        while True:
            running = list(eng.scheduler.running)
            if (len(running) == eng.max_batch and not eng.scheduler.waiting
                    and all(r.prefill_done for r in running)):
                break
            if time.perf_counter() > t_end:
                raise RuntimeError("the window's requests never all decoded")
            time.sleep(0.001)
        # the main thread polls at the interpreter's switch interval, so
        # its own wake-ups take little from the worker
        s0, t0 = eng.stats["launches"], time.perf_counter()
        while eng.stats["launches"] < s0 + steps:
            if not eng.has_unfinished() or time.perf_counter() > t0 + 60:
                ran = eng.stats["launches"] - s0
                raise RuntimeError(f"the window ran {ran} of its {steps} "
                                   f"steps")
            time.sleep(0.005)
        s1, t1 = eng.stats["launches"], time.perf_counter()
        clients.join(timeout=600)
        if clients.is_alive() or "r" not in out:
            raise RuntimeError("the window's clients did not finish")
        run_steps = eng.stats["launches"] - s_run
    wall_ms = (t1 - t0) / (s1 - s0) * 1e3
    rec = _device_profile(prof, run_steps, wall_ms)
    if rec["device_ms_per_step"] is None:
        raise RuntimeError("torch.profiler saw no device time in the "
                           "async worker's replays")
    rec.update(steps=s1 - s0, run_steps=run_steps)
    return rec


def _grammar_row_cost(eng, dev, window=16):
    """Wall and device ms per decode step of 8 rows, all greedy and then
    with one row under a grammar (its bias and counts channels packed,
    uploaded and run through the pipeline every step), each with the
    host's ms a step split by part (``_host_split``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference.llm import DfaTokenGrammar

    cycle = DfaTokenGrammar(eng.vocab_size, {0: {20: 1, 21: 1, 22: 1},
                                             1: {12: 0}})
    rng = np.random.RandomState(88)
    out = {}
    for label in ("greedy", "one_grammar_row"):
        for i in range(eng.max_batch):
            kw = ({"grammar": cycle} if label != "greedy" and i == 0
                  else {})
            eng.add_request(list(rng.randint(0, 50257, 128)),
                            max_new_tokens=4 * window, **kw)
        while eng.scheduler.waiting or not all(
                r.prefill_done for r in eng.scheduler.running):
            eng.step()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(window):
            eng.step()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) / window * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(window):
                eng.step()
            torch.cuda.synchronize(dev)
        rec = _device_profile(prof, window, wall_ms)
        rec.pop("top_device_us_per_step")
        rec["host_ms_per_step"] = _host_split(eng, window)
        out[label] = rec
        for rid in list(eng._requests):
            eng.abort_request(rid)
        while eng.has_unfinished():
            eng.step()
    out["extra_wall_ms"] = (out["one_grammar_row"]["wall_ms_per_step"]
                            - out["greedy"]["wall_ms_per_step"])
    out["extra_device_ms"] = (out["one_grammar_row"]["device_ms_per_step"]
                              - out["greedy"]["device_ms_per_step"])
    # the bias and counts channels, [8, V] f32 each, at the decode bucket
    out["channel_bytes_per_step"] = 2 * 8 * eng.vocab_size * 4
    return out


def _direct_burst(eng, dev, seed):
    """The front end's burst on prompts from ``seed``, straight through
    ``add_request``/``step``: tokens/s, and TTFT and TPOT of the greedy
    requests on the engine clock."""
    import torch

    reqs = _front_end_requests(seed, eng.vocab_size)
    t0 = time.perf_counter()
    tok0 = eng.stats["tokens_generated"]
    rids = [eng.add_request(body["prompt_ids"],
                            **_engine_kwargs(body, eng.vocab_size))
            for _, body, _ in reqs]
    outs = {}
    while eng.has_unfinished():
        for o in eng.step():
            outs[o.request_id] = o
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    timed = [outs[r] for (label, _, _), r in zip(reqs, rids)
             if label == "greedy"]
    return {"wall_s": wall,
            "tokens_per_s": (eng.stats["tokens_generated"] - tok0) / wall,
            "ttft_s": _pct([o.metrics["first_token"] - o.metrics["arrival"]
                            for o in timed]),
            "tpot_s": _pct([(o.metrics["finished"] - o.metrics["first_token"])
                            / (len(o.output_ids) - 1) for o in timed])}


def front_end_phase(dev, smi):
    """The serving front end at GPT-124M width (random bf16 weights from
    seed 0, the serving phase's engine settings, a toy detokenizer):
    ``HttpLLMServer`` -> ``AsyncLLMEngine`` -> ``LLMEngine`` -> the
    replayed ragged step with B1.  After ``warmup()``:

    - the yardstick: the front end's burst (``_front_end_requests``, on
      prompts of their own) straight through ``add_request``/``step``
      before the server run and again after it (``_direct_burst``), and
      three short greedy prompts one at a time through ``generate``;
    - behind the server on 127.0.0.1, with the counts at 0: the burst
      posted by a client thread per request (six greedy requests
      streamed, timing TTFT and TPOT at the client; temperature with a
      seed; top_k/top_p/logit_bias; logprobs=5; a stop string under the
      toy detokenizer; a grammar; n=2; a deadline that must expire),
      one request aborted through the server's async engine, bad
      requests that must get a 400 and leave the engine empty, the three
      short prompts one at a time (token-equal to ``generate``'s, since
      one in flight gives the same steps), and profiled windows of the
      worker's replayed decode steps with handler threads live and with
      the same requests submitted in-process (``_async_window``); then
      ``close()``;
    - every completion its expected finish reason and promise
      (``_check_completions``), each greedy burst request's first token
      in the dense forward's top 3, no page leaked, no graph captured
      after ``warmup()``, B1 launched on every layer of every engine
      launch of the server's run;
    - the cost of one grammar row a decode step (``_grammar_row_cost``);
    - a second engine without ``warmup()`` behind a server: its buckets
      are captured by the worker thread, the only one on the device, and
      its output equals the warmed engine's;
    - a third engine with a fault schedule: a transient step fault
      absorbed by one retry and a raise that quarantines exactly its
      victim, the survivors token-equal to the fault-free engine.

    Returns the B1 count of the server's run."""
    import gc
    import warnings

    import torch

    from paddle_tpu_torch.inference.llm import (
        Fault,
        FaultInjector,
        HttpLLMServer,
        LLMEngine,
    )
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.ops.cuda import registry

    model = gpt_124m(device=dev, seed=0, dtype=torch.bfloat16).eval()
    eng = LLMEngine(model, device=dev, detokenizer=_toy_detokenizer,
                    **_SERVE_ENGINE)
    vocab = eng.vocab_size
    eng.warmup()
    captures = eng._graphs.captures

    # the yardstick: the burst straight through, before the server run
    # and again after it, on prompts of their own
    direct = [_direct_burst(eng, dev, 5)]
    rng = np.random.RandomState(66)
    short = [[int(t) for t in rng.randint(0, 50257, n)] for n in (12, 9, 15)]
    one_at_a_time = [eng.generate([p], max_new_tokens=24)[0][len(p):]
                     .tolist() for p in short]

    # behind the server
    burst = _front_end_requests(6, vocab)
    registry.reset_counts()
    launches0 = eng.stats["launches"]
    srv = HttpLLMServer(engine=eng).start()
    try:
        addr = srv.address
        aborted = srv.submit(short[0] + short[1], max_new_tokens=400)
        srv.async_engine.abort(aborted)
        results, http_wall = _post_all(addr, [b for _, b, _ in burst])
        aborted_out = srv.async_engine.result(aborted, timeout=300)
        if aborted_out.finish_reason != "aborted":
            raise RuntimeError(f"the aborted request finished by "
                               f"{aborted_out.finish_reason}")
        adds = sum(1 for e in eng.events if e[1] == "add")
        for body, frag in (({"prompt_ids": [1, 2], "top_p": 0.0}, "top_p"),
                           ({"prompt_ids": [1, 2], "adapter": "t1"},
                            "adapter"),
                           ({"prompt_ids": [1, 2], "tempreature": 1.0},
                            "unknown")):
            status, resp = _http(addr, "POST", "/v1/completions", body)
            if status != 400 or frag not in resp.get("error", ""):
                raise RuntimeError(f"bad request {body} got {status} "
                                   f"{resp}")
        if eng.has_unfinished() or adds != sum(
                1 for e in eng.events if e[1] == "add"):
            raise RuntimeError("a bad request was admitted")
        via_http = []
        for p in short:
            status, resp = _http(addr, "POST", "/v1/completions",
                                 {"prompt_ids": p, "max_new_tokens": 24})
            via_http.append(resp["completions"][0]["output_ids"])
        status, health = _http(addr, "GET", "/healthz")
        # the worker's decode steps with 8 HTTP clients (handler threads
        # live), then with the same requests submitted in-process
        window = _async_window(eng, lambda b: _post_all(addr, b))
        aeng = srv.async_engine
        window_in_process = _async_window(eng, lambda bodies: [
            aeng.result(r, timeout=300) for r in [
                aeng.submit(b["prompt_ids"],
                            max_new_tokens=b["max_new_tokens"])
                for b in bodies]])
    finally:
        srv.close()
    launches = registry.counts()["paged_ragged_attention"]
    engine_launches = eng.stats["launches"] - launches0
    leaked = eng.num_blocks - eng.block_manager.num_free_blocks
    direct.append(_direct_burst(eng, dev, 7))

    http_tokens, ttft, tpot = 0, [], []
    for (label, body, expect), res in zip(burst, results):
        if body.get("stream"):
            done, first, final = res
            comps = done["completions"]
            n = len(comps[0]["output_ids"])
            ttft.append(first)
            tpot.append((final - first) / (n - 1))
        else:
            status, resp = res
            if status != 200:
                raise RuntimeError(f"{label}: status {status} {resp}")
            comps = resp["completions"]
        _check_completions(label, comps, expect, vocab)
        http_tokens += sum(len(c["output_ids"]) for c in comps)
        if label == "greedy":
            ids = torch.as_tensor(body["prompt_ids"], device=dev)[None]
            with torch.no_grad():
                logits = model(ids)[0, -1].float()
            top = logits.topk(3).indices.tolist()
            if comps[0]["output_ids"][0] not in top:
                raise RuntimeError(f"greedy first token "
                                   f"{comps[0]['output_ids'][0]} not in the "
                                   f"dense top 3 {top}")
    if via_http != one_at_a_time:
        raise RuntimeError(f"one at a time through HTTP {via_http} != "
                           f"through generate {one_at_a_time}")
    want = eng.num_layers * engine_launches
    if launches != want or leaked or eng._graphs.captures != captures:
        raise RuntimeError(
            f"B1 launches {launches} (want {want}), {leaked} pages leaked, "
            f"{eng._graphs.captures - captures} captures after warmup")
    grammar = _grammar_row_cost(eng, dev)
    say("front_end", model="gpt_124m", dtype="bfloat16", card=smi,
        requests=len(burst) + 1, http_wall_s=http_wall,
        requests_per_s=len(burst) / http_wall,
        http_tokens_per_s=http_tokens / http_wall,
        http_ttft_s=_pct(ttft), http_tpot_s=_pct(tpot),
        direct_before_and_after=direct,
        async_decode_window=window,
        async_decode_window_in_process=window_in_process,
        grammar_row=grammar,
        engine_launches=engine_launches, kernel_launches=launches,
        healthz_during_serving=health,
        graph_captures_after_warmup=eng._graphs.captures - captures,
        lifecycle={k: v for k, v in eng.lifecycle_stats().items()
                   if k != "step_gauges"})
    del eng, srv
    gc.collect()

    # a bucket missed by warmup is captured by the worker thread
    lazy = LLMEngine(model, device=dev, **_SERVE_ENGINE)
    srv = HttpLLMServer(engine=lazy).start()
    try:
        status, resp = _http(srv.address, "POST", "/v1/completions",
                             {"prompt_ids": short[0], "max_new_tokens": 24})
    finally:
        srv.close()
    got = resp["completions"][0]["output_ids"]
    say("front_end_lazy_capture", captures=lazy._graphs.captures,
        replays=lazy._graphs.replays, equal=got == one_at_a_time[0])
    if (got != one_at_a_time[0] or lazy._graphs.captures != 2
            or lazy.block_manager.num_free_blocks != lazy.num_blocks):
        raise RuntimeError(f"worker-captured engine gave {got}, want "
                           f"{one_at_a_time[0]}")
    del lazy, srv
    gc.collect()

    # step isolation on the card: transient at step 2, raise at step 4
    prompts = [[int(t) for t in rng.randint(0, 50257, 16)] for _ in range(4)]
    ref = LLMEngine(model, device=dev, **_SERVE_ENGINE)
    want = ref.generate(prompts, max_new_tokens=12)
    del ref
    faulty = LLMEngine(model, device=dev, retry={"max_attempts": 2,
                                                 "base_delay_s": 0.0,
                                                 "jitter": 0.0},
                       faults=FaultInjector([
                           Fault("step", "transient", step=2, count=1),
                           Fault("step", "raise", step=4, victim=1)]),
                       **_SERVE_ENGINE)
    faulty.warmup()
    rids = [faulty.add_request(p, max_new_tokens=12) for p in prompts]
    outs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while faulty.has_unfinished():
            for o in faulty.step():
                outs[o.request_id] = o
    kinds = [e[1] for e in faulty.events]
    quarantined = [e[2] for e in faulty.events if e[1] == "quarantine"]
    stats = faulty.lifecycle_stats()
    say("front_end_faults", retries=stats["retries"],
        quarantined=quarantined, step_faults=stats["step_faults"],
        finish={str(r): outs[r].finish_reason for r in rids})
    for r, w in zip(rids, want):
        got = outs[r].all_ids
        if r in quarantined:     # a casualty emitted a prefix of its run
            ok = (outs[r].finish_reason == "error"
                  and np.array_equal(got, w[:len(got)]))
        else:
            ok = outs[r].ok and np.array_equal(got, w)
        if not ok:
            raise RuntimeError(f"request {r} after the faults: "
                               f"{outs[r].finish_reason} {got.tolist()}")
    # the transient is retried once; the raise fires on every attempt,
    # so it is retried once too and then quarantined
    if (stats["retries"] != 2 or stats["step_faults"] != 3
            or quarantined != [rids[1]] or kinds.count("retry") != 2
            or faulty.block_manager.num_free_blocks != faulty.num_blocks):
        raise RuntimeError(f"fault schedule not absorbed as planned: "
                           f"{stats}, quarantined {quarantined}")
    return launches


def fmt_decode_phase(dev, batch=8, prompt=128, new=64, window=16):
    """FusedMultiTransformer over GPT-124M in bf16 (random weights from
    seed 0): ``batch`` prompts of ``prompt`` tokens, ``new`` greedy
    tokens (the main path: counts reset just before and read just
    after), B6 on every layer of every decode step, every decode step a
    replay; ms per decode step (the run less a prefill-only run); then
    ``window`` decode steps on the host clock and ``window`` under
    torch.profiler, with B6's share of the device time, which the
    profiler must see inside the replays; and the same windows with the
    decode body dispatched op by op (``fmt_decode_eager``), the replay's
    yardstick in the same call.  Returns the B6 count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.ops.cuda import registry

    model = gpt_124m(device=dev, seed=0, dtype=torch.bfloat16).eval()
    fmt = FusedMultiTransformer(model, max_length=prompt + new,
                                dtype="bfloat16", device=dev)
    del model
    ids = np.random.RandomState(77).randint(0, 50257, (batch, prompt))
    fmt.generate(ids[:, :8], max_new_tokens=4)          # warm-up
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fmt.generate(ids, max_new_tokens=1)                 # prefill only
    torch.cuda.synchronize(dev)
    prefill_s = time.perf_counter() - t0
    registry.reset_counts()
    steps0 = fmt.decode_steps
    captures, replays = fmt._graphs.captures, fmt._graphs.replays
    t0 = time.perf_counter()
    out = fmt.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = registry.counts()["decode_attention"]
    steps = fmt.decode_steps - steps0
    want = fmt.num_layers * steps
    replayed = fmt._graphs.replays - replays
    if out.shape != (batch, prompt + new) or not (
            (out >= 0) & (out < 50304)).all():
        raise RuntimeError(f"FMT output {out.shape} out of range")

    def windows(step):
        """Prefill, one step, then ``window`` steps of ``step(tokens,
        offset)`` on the host clock and ``window`` under torch.profiler,
        each pulling the argmax first as generate does."""
        ck, cv = fmt._cache(batch)
        logits = fmt._forward_chunk(torch.as_tensor(ids, device=dev), ck, cv,
                                    0)
        pos = prompt

        def run(n):
            nonlocal logits, pos
            for _ in range(n):
                logits = step(logits.argmax(-1).cpu().numpy(), pos)
                pos += 1

        run(1)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        run(window)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) / window * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(window)
            torch.cuda.synchronize(dev)
        return wall_ms, prof

    def eager_step(tokens, offset):
        # the yardstick: the decode body dispatched op by op, no graph
        return fmt._decode_body(torch.as_tensor(
            np.append(np.asarray(tokens, np.int64), offset), device=dev))

    e_wall_ms, e_prof = windows(eager_step)
    wall_ms, prof = windows(fmt._decode_step)
    share = _kernel_share(prof, "decode_split_kernel", "decode_combine")
    say("fmt_decode", model="gpt_124m", dtype="bfloat16", batch=batch,
        prompt_tokens=prompt, new_tokens=new, wall_s=wall,
        prefill_s=prefill_s, decode_steps=steps,
        ms_per_decode_step=(wall - prefill_s) / steps * 1e3,
        tokens_per_s=batch * new / wall, kernel_launches=launches,
        expected_launches=want, graph_replays=replayed,
        graph_captures=fmt._graphs.captures - captures,
        graph_pool_bytes=fmt._graphs.pool_bytes(),
        decode_kernel_device_share=share,
        **_device_profile(prof, window, wall_ms))
    say("fmt_decode_eager", batch=batch, steps=window,
        decode_kernel_device_share=_kernel_share(
            e_prof, "decode_split_kernel", "decode_combine"),
        **_device_profile(e_prof, window, e_wall_ms))
    if launches != want:
        raise RuntimeError(f"decode kernel launches {launches} != {want}")
    if replayed != steps or fmt._graphs.captures != captures:
        raise RuntimeError("the FMT's decode steps did not all replay")
    if not share:
        raise RuntimeError("torch.profiler saw no decode kernel in the "
                           "replayed decode window")
    return launches


# the decode-vs-dense tolerance of the JAX package's own Llama test
# (tests/test_models_zoo.py::test_decode_matches_dense_forward)
LLAMA_RTOL, LLAMA_ATOL = 2e-3, 2e-4


def llama_decode_phase(dev, batch=8, prompt=32, new=32, window=8):
    """Llama-160M in f32 (random weights from seed 0, GQA 12/4, so B6
    runs groups of 3): ``prompt`` tokens of each of ``batch`` sequences
    fed one at a time through ``decode_step`` into ``init_cache(batch,
    2048)``, then ``new`` greedy tokens (the main path); every decode
    logit must agree with the dense forward over the same sequence
    within ``LLAMA_ATOL + LLAMA_RTOL * |dense|``, and B6 must launch on
    every layer of every step.  Then ``window`` more steps on the host
    clock and ``window`` under torch.profiler.  Returns the B6 count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models.llama import llama_160m
    from paddle_tpu_torch.ops.cuda import registry

    model = llama_160m(device=dev, seed=0).eval()
    ids = torch.as_tensor(np.random.RandomState(88).randint(
        0, 32000, (batch, prompt)), device=dev)
    model.decode_step(ids[:, :1], model.init_cache(batch, 2048))  # warm-up
    cache = model.init_cache(batch, 2048)
    torch.cuda.synchronize(dev)
    registry.reset_counts()
    t0 = time.perf_counter()
    logits, toks = [], []
    for t in range(prompt):
        lg, cache = model.decode_step(ids[:, t:t + 1], cache)
        logits.append(lg)
    for _ in range(new):
        toks.append(logits[-1].argmax(-1))
        lg, cache = model.decode_step(toks[-1][:, None], cache)
        logits.append(lg)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = registry.counts()["decode_attention"]
    steps = prompt + new
    want = model.config.num_layers * steps

    seq = torch.cat([ids, torch.stack(toks, dim=1)], dim=1)
    with torch.no_grad():
        dense = model(seq)
    step = torch.stack(logits, dim=1)
    err = (step - dense).abs()
    over = float((err / (LLAMA_ATOL + LLAMA_RTOL * dense.abs())).max())

    def run(n):
        for _ in range(n):
            model.decode_step(toks[-1][:, None], cache)

    t1 = time.perf_counter()
    run(window)
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t1) / window * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(window)
        torch.cuda.synchronize(dev)
    say("llama_decode", model="llama_160m", dtype="float32", batch=batch,
        prompt_tokens=prompt, new_tokens=new, cache_len=2048,
        decode_steps=steps, ms_per_decode_step=wall / steps * 1e3,
        max_abs_err_vs_dense=float(err.max()),
        err_over_limit_vs_dense=over, rtol=LLAMA_RTOL, atol=LLAMA_ATOL,
        kernel_launches=launches, expected_launches=want,
        decode_kernel_device_share=_kernel_share(
            prof, "decode_split_kernel", "decode_combine"),
        **_device_profile(prof, window, wall_ms))
    if not (over <= 1.0 and bool(torch.isfinite(step).all())):
        raise RuntimeError(f"Llama decode logits off the dense forward: "
                           f"err/limit {over}")
    if launches != want:
        raise RuntimeError(f"decode kernel launches {launches} != {want}")
    return launches


TRAIN_LR = 1e-4
_TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                  "layernorm_fwd", "layernorm_bwd")


def _expected_train_launches(num_layers, steps):
    """Per step: one flash forward and one backward per layer; two
    LayerNorms per block plus ``ln_f``, each forward and backward."""
    return {"flash_attention_fwd": num_layers * steps,
            "flash_attention_bwd": num_layers * steps,
            "layernorm_fwd": (2 * num_layers + 1) * steps,
            "layernorm_bwd": (2 * num_layers + 1) * steps}


def _trainer(model, lr):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep

    opt = optimizer.AdamW(learning_rate=lr, parameters=model.parameters(),
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0))
    return TrainStep(model, lambda logits, labels: model.loss(logits, labels),
                     opt)


def train_exactness_phase(dev):
    """Three TrainSteps of AdamW with global-norm clipping on the card
    against the same three on the port's CPU path, from the same weights
    and batch: a 2-layer model at hidden 128 (head_dim 32, C 128, so both
    kernels launch), seq 64, f32.  The loss must agree to 1e-5 relative
    at every step; every parameter to 1e-5, except that Adam moves an
    element whose gradient is near 0 by about +-lr, so where the two
    gradients differ in sign it may differ by up to 2 * lr * steps, on
    at most 0.1% of the elements (tests/test_torch_train.py).  Every
    attention and LayerNorm of every step must launch its kernels."""
    import torch

    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.ops.cuda import registry

    cfg = dict(num_layers=2, hidden_size=128, num_attention_heads=4,
               max_position_embeddings=64)
    cpu = gpt_tiny(device="cpu", seed=0, **cfg)
    card = gpt_tiny(device=dev, seed=1, **cfg)
    card.set_state_dict({k: v.detach() for k, v in cpu.named_parameters()})
    rng = np.random.RandomState(5)
    ids = torch.as_tensor(rng.randint(0, 128, (4, 64)))
    labels = torch.as_tensor(rng.randint(0, 128, (4, 64)))
    lr, steps = 1e-3, 3
    step_cpu, step_card = _trainer(cpu, lr), _trainer(card, lr)
    ids_d, labels_d = ids.to(dev), labels.to(dev)
    registry.reset_counts()
    losses = []
    for _ in range(steps):
        losses.append((step_cpu(ids, labels).item(),
                       step_card(ids_d, labels_d).item()))
    launches = {k: registry.counts()[k] for k in _TRAIN_KERNELS}
    want = _expected_train_launches(cfg["num_layers"], steps)
    cpu_params = dict(cpu.named_parameters())
    worst, off, total = 0.0, 0, 0
    for name, p in card.named_parameters():
        d = (p.detach().cpu() - cpu_params[name].detach()).abs()
        worst = max(worst, float(d.max()))
        off += int((d > 1e-5).sum())
        total += d.numel()
    loss_rel = max(abs(a - b) / abs(a) for a, b in losses)
    say("train_exactness", model="2 layers, hidden 128, 4 heads",
        seq=64, batch=4, dtype="float32", steps=steps,
        losses_cpu_card=losses, max_loss_rel_err=loss_rel,
        max_param_abs_err=worst, params_beyond_1e_5=off,
        params_total=total, kernel_launches=launches,
        expected_launches=want)
    if loss_rel > 1e-5 or worst > 2 * lr * steps or off > 1e-3 * total:
        raise RuntimeError("card training diverged from the CPU path")
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")


# Limits of the bf16 train-exactness phase.  Three steps' loss is a weak
# witness: on an H100 the sound kernels read 3.1e-5 relative against the
# plain run, a plain run with P rounded to bf16 before P V (what SDPA
# does) 7.4e-5 and one with dk left out 1.3e-4, so BF16_LOSS_RTOL only
# bounds the drift.  The first step's gradients separate a missing dk:
# the largest relative L2 error of one parameter's gradient reads 5.8e-3
# for the sound kernels and 4.1e-2 with dk left out, and BF16_GRAD_RTOL
# sits between the two.  The phase plants each fault of BF16_FAULTS in a
# control run and fails unless those of BF16_SEPARATES exceed it.  A bf16
# P reads 6.9e-3 on the gradients, level with the sound kernels: only the
# flash phase's per-output parity separates it.
BF16_LOSS_RTOL = 1e-4
BF16_GRAD_RTOL = 1.5e-2
BF16_FAULTS = ("p_bf16", "dk_zero")
BF16_SEPARATES = ("dk_zero",)


def train_exactness_bf16_phase(dev):
    """The bf16 kernels in training: three O2 bf16 AdamW TrainSteps of the
    f32 phase's 2-layer, hidden-128 model (head_dim 32, so the scale
    1/sqrt(32) is not a power of two) on the card with the flash kernels,
    against the same three steps on the card with attention through an
    autograd function over the f32 plain versions (``flash_fwd_plain``
    and ``flash_bwd_plain`` on f32 copies, cast back to bf16).  The loss
    must agree within ``BF16_LOSS_RTOL`` at every step and each
    parameter's first-step gradient within ``BF16_GRAD_RTOL``, which the
    control runs of ``BF16_SEPARATES`` must exceed; every attention of
    every step of the first run must launch the kernels, and none of the
    plain run's."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.ops import attention
    from paddle_tpu_torch.ops.attention import causal_logits
    from paddle_tpu_torch.ops.cuda import registry
    from paddle_tpu_torch.ops.cuda.flash_attention_kernel import (
        flash_bwd_plain,
        flash_fwd_plain,
    )

    class PlainFlash(torch.autograd.Function):
        """The f32 plain versions, or with ``fault`` one planted fault
        of ``BF16_FAULTS`` (the control runs)."""

        @staticmethod
        def forward(ctx, q, k, v, causal, scale, fault):
            q32, k32, v32 = (x.float() for x in (q, k, v))
            out, lse = flash_fwd_plain(q32, k32, v32, causal, scale)
            if fault == "p_bf16":
                p = torch.exp(causal_logits(q32, k32, causal, scale)
                              - lse[..., None])
                out = torch.einsum("bnts,bsnh->btnh",
                                   p.bfloat16().float(), v32)
            ctx.save_for_backward(q32, k32, v32, out, lse)
            ctx.causal, ctx.scale, ctx.fault = causal, scale, fault
            return out.to(q.dtype)

        @staticmethod
        def backward(ctx, dout):
            dq, dk, dv = flash_bwd_plain(*ctx.saved_tensors, dout.float(),
                                         ctx.causal, ctx.scale)
            if ctx.fault == "dk_zero":
                dk = torch.zeros_like(dk)
            return (*(g.to(dout.dtype) for g in (dq, dk, dv)), None, None,
                    None)

    plain_calls = [0]

    def plain_route(fault):
        def route(q, k, v, is_causal=False):
            plain_calls[0] += 1
            return PlainFlash.apply(q, k, v, bool(is_causal),
                                    1.0 / float(np.sqrt(q.shape[-1])), fault)
        return route

    cfg = dict(num_layers=2, hidden_size=128, num_attention_heads=4,
               max_position_embeddings=64)
    init = {k: v.detach() for k, v in
            gpt_tiny(device=dev, seed=0, **cfg).named_parameters()}
    rng = np.random.RandomState(5)
    ids = torch.as_tensor(rng.randint(0, 128, (4, 64)), device=dev)
    labels = torch.as_tensor(rng.randint(0, 128, (4, 64)), device=dev)
    lr, steps = 1e-3, 3

    def run():
        """Losses of every step, f32 copies of the first step's
        gradients, and the kernels' launch counts."""
        model = gpt_tiny(device=dev, seed=1, **cfg)
        model.set_state_dict(init)
        model = amp.decorate(model, level="O2", dtype="bfloat16")
        step = _trainer(model, lr)
        registry.reset_counts()
        losses = [step(ids, labels).item()]
        grads = {n: p.grad.float().clone()
                 for n, p in model.named_parameters()}
        losses += [step(ids, labels).item() for _ in range(steps - 1)]
        return (losses, grads,
                {k: registry.counts()[k] for k in _TRAIN_KERNELS})

    def run_plain(fault=None):
        kernel = attention.flash_attention_cuda
        attention.flash_attention_cuda = plain_route(fault)
        try:
            return run()
        finally:
            attention.flash_attention_cuda = kernel

    def errors(got, want):
        """(largest relative loss error over the steps, largest relative
        L2 error of one parameter's first-step gradient)"""
        return (max(abs(x - y) / abs(y) for x, y in zip(got[0], want[0])),
                max(float((got[1][n] - g).norm() / g.norm())
                    for n, g in want[1].items() if float(g.norm())))

    kernels = run()
    plain = run_plain()
    plain_attention_calls = plain_calls[0]
    faults = {f: errors(run_plain(f), plain) for f in BF16_FAULTS}
    losses, launches, plain_launches = kernels[0], kernels[2], plain[2]
    flash = ("flash_attention_fwd", "flash_attention_bwd")
    want = {k: cfg["num_layers"] * steps for k in flash}
    loss_err, grad_err = errors(kernels, plain)
    say("train_exactness_bf16", model="2 layers, hidden 128, 4 heads",
        seq=64, batch=4, dtype="bfloat16 (O2)", steps=steps,
        losses_kernels_plain=list(zip(losses, plain[0])),
        max_loss_rel_err=loss_err, loss_rtol=BF16_LOSS_RTOL,
        max_grad_rel_l2_err=grad_err, grad_rtol=BF16_GRAD_RTOL,
        planted_fault_loss_grad_err=faults,
        kernel_launches=launches, plain_run_launches=plain_launches,
        plain_run_attention_calls=plain_attention_calls,
        expected_launches=want)
    if not (loss_err <= BF16_LOSS_RTOL and grad_err <= BF16_GRAD_RTOL
            and np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise RuntimeError("bf16 training with the flash kernels diverged "
                           "from the f32 plain versions")
    if not all(faults[f][1] > BF16_GRAD_RTOL for f in BF16_SEPARATES):
        raise RuntimeError(f"a planted fault stayed within the gradient "
                           f"tolerance: {faults}")
    if ({k: launches[k] for k in flash} != want
            or any(plain_launches[k] for k in flash)
            or plain_attention_calls != cfg["num_layers"] * steps):
        raise RuntimeError(f"kernel launches {launches} != {want}, or the "
                           f"plain run launched {plain_launches}")


def training_phase(dev, warmup=3, steps=10):
    """GPT-124M trained as ``bench.py`` sets it up: bf16 through
    ``amp.decorate(level="O2")``, dropout 0, ``AdamW(learning_rate=
    1e-4)`` plus ``ClipGradByGlobalNorm(1.0)``, one batch of 8 x 1024
    seeded random ids and labels every step; ``warmup`` steps, then
    ``steps`` timed ones (the main path: counts are reset just before
    and read just after), then one step under torch.profiler.  The loss
    must stay finite and end below where it began, and every attention
    and LayerNorm of every timed step must launch its kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.ops.cuda import registry

    t0 = time.perf_counter()
    model = gpt_124m(device=dev, seed=0, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    step = _trainer(model, TRAIN_LR)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(2024)
    batch, seq, vocab = 8, 1024, model.config.vocab_size
    ids = torch.as_tensor(rng.randint(0, vocab, (batch, seq)), device=dev)
    labels = torch.as_tensor(rng.randint(0, vocab, (batch, seq)),
                             device=dev)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [step(ids, labels).item() for _ in range(warmup)]
    registry.reset_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    timed = [step(ids, labels) for _ in range(steps)]
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {k: registry.counts()[k] for k in _TRAIN_KERNELS}
    losses += [x.item() for x in timed]
    peak = torch.cuda.max_memory_allocated(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(ids, labels)
        torch.cuda.synchronize(dev)
    ms_per_step = wall / steps * 1e3
    tokens_per_s = batch * seq * steps / wall
    want = _expected_train_launches(model.config.num_layers, steps)
    say("training", model="gpt_124m", dtype="bfloat16 (O2)",
        optimizer="AdamW(1e-4) + ClipGradByGlobalNorm(1.0)", batch=batch,
        seq=seq, warmup_steps=warmup, timed_steps=steps, params=n_params,
        losses=losses, ms_per_step=ms_per_step, tokens_per_s=tokens_per_s,
        mfu=6.0 * n_params * tokens_per_s / PEAK_FLOPS["torch.bfloat16"],
        peak_memory_bytes=peak, setup_s=setup_s, kernel_launches=launches,
        expected_launches=want)
    say("training_profile", steps=1,
        attention_device_share=_kernel_share(prof, "flash_"),
        attention_us_per_step=_kernel_us(prof, "flash_", 1),
        layernorm_bwd_us_per_step=sum(
            sum(_kernel_us(prof, n, 1).values()) for n in LN_BWD_KERNELS),
        layernorm_bwd_device_share=_kernel_share(prof, *LN_BWD_KERNELS),
        **_device_profile(prof, 1, ms_per_step))
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise RuntimeError(f"training loss did not fall: {losses}")
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")
    return launches


# ------------------------------------------------- the eager Paddle API --
BERT_BATCH, BERT_SEQ = 8, 512
# _parity's f32 tolerance for the eager BERT step and forward, kernels
# against their plain versions from the same weights, batch and draws
EAGER_F32_TOL = 1e-4
_EAGER_KERNELS = ("layernorm_fwd", "layernorm_bwd", "flash_attention_fwd",
                  "flash_attention_bwd")


def _bert_layernorms(cfg):
    """LayerNorms one BertForPretraining forward runs: the embeddings',
    two a layer (post-norm), the MLM transform's."""
    return 2 * cfg.num_hidden_layers + 2


def _bert_step_flops(cfg, batch, seq):
    """Operations of one training step, counted from the code: 6 x the
    matmul parameters a token meets (each layer's q, k, v, out and FFN,
    the MLM transform, the tied decoder) x tokens, the pooler and NSP
    head on one token a row, and the attention products (QK^T and PV,
    4 B T^2 H a layer forward) x 3 for forward + backward."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    per_token = (cfg.num_hidden_layers * (4 * h * h + 2 * h * f) + h * h
                 + h * cfg.vocab_size)
    attention = cfg.num_hidden_layers * 4 * batch * seq * seq * h
    return (6 * (per_token * batch * seq + (h * h + 2 * h) * batch)
            + 3 * attention)


def _bert_batch(cfg, seed, padded=True):
    """A pretraining batch from ``seed`` as port Tensors on the current
    device: rows padded to lengths drawn from [T/4, T] (all T when not
    ``padded``) with a 1/0 attention mask, segment B from half the row,
    15% of the real positions as MLM labels, NSP labels; and the
    lengths."""
    import paddle_tpu_torch as paddle

    rng = np.random.RandomState(seed)
    b, t = BERT_BATCH, BERT_SEQ
    lengths = rng.randint(t // 4, t + 1, b) if padded else np.full(b, t)
    keep = np.arange(t)[None, :] < lengths[:, None]
    ids = np.where(keep, rng.randint(1, cfg.vocab_size, (b, t)), 0)
    types = (np.arange(t)[None, :] >= lengths[:, None] // 2) & keep
    mlm = np.where(keep & (rng.rand(b, t) < 0.15), ids, -100)
    nsp = rng.randint(0, 2, b)
    return ([paddle.to_tensor(a.astype(np.int64))
             for a in (ids, types, keep, mlm, nsp)], lengths)


class _PlainKernels:
    """Within: every kernel on the eager path replaced by its plain
    version, explicitly — LayerNorm (B4a/B4b) by ``layer_norm_plain``
    under autograd, flash attention (B2/B3) by ``attention_plain`` —
    counting the calls each takes."""

    def __enter__(self):
        from paddle_tpu_torch.nn import functional as F
        from paddle_tpu_torch.ops import attention
        from paddle_tpu_torch.ops.cuda.layernorm_kernel import (
            layer_norm_plain,
        )

        self.calls = {"layernorm": 0, "attention": 0}

        def ln(x, gamma, beta, eps=1e-5):
            self.calls["layernorm"] += 1
            return layer_norm_plain(x, (x.shape[-1],), gamma, beta, eps)

        def attn(q, k, v, is_causal=False):
            self.calls["attention"] += 1
            return attention.attention_plain(q, k, v, is_causal=is_causal)

        self._saved = (F, F.layernorm_cuda, attention,
                       attention.flash_attention_cuda)
        F.layernorm_cuda, attention.flash_attention_cuda = ln, attn
        return self.calls

    def __exit__(self, *exc):
        F, ln, attention, attn = self._saved
        F.layernorm_cuda, attention.flash_attention_cuda = ln, attn
        return False


class _OpCalls:
    """Within: every call through the op dispatcher (``apply_op``)
    counted, with its host seconds, and the seconds of those spent in the
    op's body (its torch calls and their launches); the rest is the
    dispatch's own unwrap and wrap."""

    def __enter__(self):
        from paddle_tpu_torch.nn import functional as F
        from paddle_tpu_torch.ops import dispatch, registry

        self.stats = {"calls": 0, "host_s": 0.0, "body_s": 0.0}
        inner = dispatch.apply_op

        def timed(fn):
            def body(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.stats["body_s"] += time.perf_counter() - t0
            return body

        def counted(name, fn, args, kwargs):
            t0 = time.perf_counter()
            try:
                return inner(name, timed(fn), args, kwargs)
            finally:
                self.stats["calls"] += 1
                self.stats["host_s"] += time.perf_counter() - t0

        self._mods, self._inner = (dispatch, registry, F), inner
        for m in self._mods:
            m.apply_op = counted
        return self.stats

    def __exit__(self, *exc):
        for m in self._mods:
            m.apply_op = self._inner
        return False


def _counts(registry):
    return {k: registry.counts()[k] for k in _EAGER_KERNELS}


def eager_api_phase(dev, smi, warmup=3, steps=10):
    """BERT-base pretraining through the port's Paddle API, stepped
    eagerly: ``BertForPretraining(bert_base_config())`` (f32, TF32 off,
    dropout 0.1) built on the card from seed 0, AdamW(1e-4) over
    ``model.parameters()``, one 8 x 512 batch with padded rows and an
    attention mask; ``loss.backward(); opt.step(); opt.clear_grad()``.

    - parity: one step's loss and every gradient with the kernels against
      the same step with every kernel replaced by its plain version
      (same weights, batch and dropout draws), under ``_parity`` at
      ``EAGER_F32_TOL``;
    - training: ``warmup`` steps, then ``steps`` timed ones (the main
      path: counts reset just before, read just after) — wall and device
      ms a step, busy share, tokens/s, FLOPs over the f32 peak, peak
      memory, op calls a step and their host µs (all, and the dispatch's
      own outside the body); B4a and B4b must launch
      once per LayerNorm a step (2 L + 2) and B2/B3 never (a mask and
      dropout take the plain attention);
    - eval: ``eval()`` over unpadded rows without a mask (another main
      path, counted alone): B2 once a layer, B4a once per LayerNorm, the
      logits held against the plain-version forward;
    - save/load: ``paddle.save(state_dict)`` -> ``load`` ->
      ``set_state_dict`` into a fresh model on the card, logits bitwise.

    Returns the launches of the two main paths, summed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.models.bert import (
        BertForPretraining,
        bert_base_config,
    )
    from paddle_tpu_torch.ops.cuda import registry

    paddle.set_device(f"gpu:{dev.index or 0}")
    cfg = bert_base_config()
    t0 = time.perf_counter()
    paddle.seed(0)
    model = BertForPretraining(cfg)
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
    n_params = sum(p.size for p in model.parameters())
    (ids, types, mask, mlm, nsp), lengths = _bert_batch(cfg, seed=2024)
    n_ln = _bert_layernorms(cfg)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0

    def loss_of(m):
        return m.loss(*m(ids, types, mask), mlm, nsp)

    def step():
        loss = loss_of(model)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    # the kernel step against the plain step, same weights and draws
    state = prandom.get_rng_state(dev)
    registry.reset_counts()
    loss_k = loss_of(model)
    loss_k.backward()
    kernel_counts = _counts(registry)
    grads_k = {n: p.grad._data.clone() for n, p in model.named_parameters()}
    opt.clear_grad()
    prandom.set_rng_state(state, dev)
    registry.reset_counts()
    with _PlainKernels() as plain_calls:
        loss_p = loss_of(model)
        loss_p.backward()
    plain_counts = _counts(registry)
    report = {"loss": _parity(loss_k._data.detach(), loss_p._data.detach(),
                              EAGER_F32_TOL)}
    grads = {n: _parity(grads_k[n], p.grad._data, EAGER_F32_TOL)
             for n, p in model.named_parameters()}
    worst = max(grads, key=lambda n: grads[n][2])
    report["grad_worst"] = grads[worst]
    opt.clear_grad()
    del grads_k
    want_one = {"layernorm_fwd": n_ln, "layernorm_bwd": n_ln,
                "flash_attention_fwd": 0, "flash_attention_bwd": 0}
    say("eager_bert_parity", card=smi, model="BertForPretraining(bert_base_"
        "config()) f32", batch=BERT_BATCH, seq=BERT_SEQ, f32_tol=EAGER_F32_TOL,
        loss_kernels=float(loss_k), loss_plain=float(loss_p),
        max_abs_err={k: r[0] for k, r in report.items()},
        err_over_limit={k: r[2] for k, r in report.items()},
        worst_grad=worst, grads_over_limit=sum(
            1 for r in grads.values() if not r[3]),
        kernel_launches=kernel_counts, plain_run_launches=plain_counts,
        plain_run_calls=plain_calls)
    if not all(r[3] for r in grads.values()) or not report["loss"][3]:
        raise RuntimeError(f"eager BERT step: kernels against plain "
                           f"{report}")
    if (kernel_counts != want_one or any(plain_counts.values())
            or plain_calls["layernorm"] != n_ln):
        raise RuntimeError(f"eager BERT step launches {kernel_counts} != "
                           f"{want_one}, or the plain run launched "
                           f"{plain_counts} / called {plain_calls}")

    torch.cuda.reset_peak_memory_stats(dev)
    losses = [float(step()) for _ in range(warmup)]
    registry.reset_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    timed = [step() for _ in range(steps)]
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = _counts(registry)
    losses += [float(x) for x in timed]
    peak = torch.cuda.max_memory_allocated(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize(dev)
    with _OpCalls() as calls:
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize(dev)
        instrumented_ms = (time.perf_counter() - t1) * 1e3
    ms = wall / steps * 1e3
    flops = _bert_step_flops(cfg, BERT_BATCH, BERT_SEQ)
    want = {"layernorm_fwd": n_ln * steps, "layernorm_bwd": n_ln * steps,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0}
    say("eager_bert_training", card=smi, dtype="float32 (TF32 off)",
        optimizer="AdamW(1e-4)", batch=BERT_BATCH, seq=BERT_SEQ,
        real_tokens=int(lengths.sum()), params=n_params,
        warmup_steps=warmup, timed_steps=steps, setup_s=setup_s,
        losses=losses, ms_per_step=ms,
        tokens_per_s=BERT_BATCH * BERT_SEQ * steps / wall,
        step_flops=flops, flops_over_f32_peak=flops / (ms / 1e3)
        / PEAK_FLOPS["torch.float32"], peak_memory_bytes=peak,
        op_calls_per_step=calls["calls"],
        op_host_us_per_call=calls["host_s"] / calls["calls"] * 1e6,
        op_host_ms_per_step=calls["host_s"] * 1e3,
        op_dispatch_us_per_call=(calls["host_s"] - calls["body_s"])
        / calls["calls"] * 1e6,
        instrumented_step_ms=instrumented_ms,
        layernorms_per_forward=n_ln, kernel_launches=launches,
        expected_launches=want)
    say("eager_bert_profile", steps=1,
        layernorm_device_share=_kernel_share(prof, "ln_"),
        **_device_profile(prof, 1, ms))
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise RuntimeError(f"eager BERT loss did not fall: {losses}")
    if launches != want:
        raise RuntimeError(f"eager BERT launches {launches} != {want}")

    model.eval()
    (ids_e, types_e, *_), _ = _bert_batch(cfg, seed=7, padded=False)
    with paddle.no_grad():
        registry.reset_counts()
        logits = model(ids_e, types_e)
        torch.cuda.synchronize(dev)
        eval_launches = _counts(registry)
        with _PlainKernels() as plain_eval:
            plain = model(ids_e, types_e)
        t1 = time.perf_counter()
        for _ in range(5):
            model(ids_e, types_e)
        torch.cuda.synchronize(dev)
        eval_ms = (time.perf_counter() - t1) / 5 * 1e3
    eval_report = {name: _parity(g._data, w._data, EAGER_F32_TOL)
                   for name, g, w in zip(("mlm_logits", "nsp_logits"),
                                         logits, plain)}
    want_eval = {"layernorm_fwd": n_ln, "layernorm_bwd": 0,
                 "flash_attention_fwd": cfg.num_hidden_layers,
                 "flash_attention_bwd": 0}
    say("eager_bert_eval", card=smi, batch=BERT_BATCH, seq=BERT_SEQ,
        mask=None, wall_ms_per_forward=eval_ms,
        max_abs_err={k: r[0] for k, r in eval_report.items()},
        err_over_limit={k: r[2] for k, r in eval_report.items()},
        kernel_launches=eval_launches, expected_launches=want_eval,
        plain_run_calls=plain_eval)
    if not all(r[3] for r in eval_report.values()):
        raise RuntimeError(f"eager BERT eval: kernels against plain "
                           f"{eval_report}")
    if eval_launches != want_eval:
        raise RuntimeError(f"eager BERT eval launches {eval_launches} != "
                           f"{want_eval}")

    path = os.path.join(ROOT, "build", "eager_bert.pdparams")
    t1 = time.perf_counter()
    paddle.save(model.state_dict(), path)
    saved_bytes = os.path.getsize(path)
    paddle.seed(1)
    fresh = BertForPretraining(cfg)
    missing, unexpected = fresh.set_state_dict(paddle.load(path))
    os.remove(path)
    round_trip_s = time.perf_counter() - t1
    fresh.eval()
    with paddle.no_grad():
        again = fresh(ids_e, types_e)
    bitwise = all(torch.equal(a._data, b._data)
                  for a, b in zip(logits, again))
    say("eager_save_load", card=smi, bytes=saved_bytes,
        round_trip_s=round_trip_s, keys=len(model.state_dict()),
        missing=missing, unexpected=unexpected, logits_bitwise=bitwise)
    if not bitwise or missing or unexpected:
        raise RuntimeError("save/load round trip changed the model")
    del model, fresh, opt
    return {k: launches[k] + eval_launches[k] for k in _EAGER_KERNELS}


# ------------------------------------------------------------ vision --
VIT_BATCH = 64
VIT_STEPS = (3, 10)          # warm-up, timed
RESNET_STEPS = (3, 5)
# the O1 step's gradients against the plain-version step: each within this
# relative L2 error (BF16_GRAD_RTOL's bound for bf16 training steps)
VISION_GRAD_RTOL = BF16_GRAD_RTOL
# and a floor of this share of the largest gradient's norm
# (``_vit_step_parity``)
VISION_GRAD_FLOOR = 1e-4
IMAGENET_MEAN = [0.485, 0.456, 0.406]
IMAGENET_STD = [0.229, 0.224, 0.225]


def _image_dataset(n, seed):
    """``n`` synthetic ImageNet samples from ``seed``: uint8 224 x 224 x 3
    images (HWC, as decoded) and labels in [0, 1000), transformed in the
    loader's workers by ``vision.transforms`` (``ToTensor``: HWC uint8 ->
    CHW float in [0, 1]; ``Normalize``)."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.vision import transforms as T

    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, 224, 224, 3), dtype=np.uint8)
    labels = rng.randint(0, 1000, n).astype(np.int64)
    pipe = T.Compose([T.ToTensor(), T.Normalize(IMAGENET_MEAN,
                                                IMAGENET_STD)])

    class Images(io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return pipe(images[i]).astype(np.float32), labels[i]

    return Images()


def _timed_loader(dataset, **kw):
    """A ``DataLoader`` whose ``waits`` list holds the seconds the
    consuming thread waited for each batch."""
    from paddle_tpu_torch import io

    class Timed(io.DataLoader):
        waits = []

        def __iter__(self):
            it = super().__iter__()
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.waits.append(time.perf_counter() - t0)
                yield batch

    return Timed(dataset, **kw)


def _step_clock():
    """A hapi callback that stamps the end of every training step."""
    from paddle_tpu_torch.hapi import Callback

    class Clock(Callback):
        stamps = []

        def on_train_batch_end(self, step, logs=None):
            self.stamps.append(time.perf_counter())

    return Clock()


def _vit_kernel_rows(dev, smi):
    """B2/B3 at ViT-B/16's attention (64 x 197 x 12 x 64 bf16, no mask,
    197 rows: a tail in every 64-row tile column) and B4a/B4b at its
    LayerNorms (64 · 197 = 12608 rows of 768, f32 under O1), each
    against its plain version in f32 on the same values, then timed
    against the bound, the plain version and the library call."""
    import torch

    from paddle_tpu_torch.ops.cuda import registry

    fwd, bwd = (registry.KERNELS[k] for k in ("flash_attention_fwd",
                                              "flash_attention_bwd"))
    q, k, v, dout = _flash_inputs(dev, torch.bfloat16, VIT_BATCH, 197, 12,
                                  64, seed=61)
    scale = 0.125
    out, lse = fwd.kernel(q, k, v, False, scale)
    grads = bwd.kernel(q, k, v, out, lse, dout, False, scale)
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, dout))
    want_out, want_lse = fwd.plain(q32, k32, v32, False, scale)
    want_grads = bwd.plain(q32, k32, v32, out.float(), lse, do32, False,
                           scale)
    report = {"out": _parity(out, want_out, 1e-4),
              "lse": _parity(lse, want_lse, 1e-4)}
    report.update({f"d{n}": _parity(g, w, 5e-4)
                   for n, g, w in zip("qkv", grads, want_grads)})
    _say_parity("flash_attention", "vit_b16_64x197x12x64", torch.bfloat16,
                report, causal=False)
    lib = _parity(torch.nn.functional.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in (q, k, v))).transpose(1, 2),
        want_out, 1e-4)
    say("library_parity", library="F.scaled_dot_product_attention",
        case="vit_b16_64x197x12x64", dtype="torch.bfloat16",
        max_abs_err=lib[0], rel_l2_err=lib[1], err_over_limit=lib[2],
        gate=False)
    x, g, b, dy = _ln_inputs(dev, torch.float32, VIT_BATCH * 197, 768,
                             seed=62)
    lfwd, lbwd = (registry.KERNELS[k] for k in ("layernorm_fwd",
                                                "layernorm_bwd"))
    y, mu, rstd = lfwd.kernel(x, g, b, 1e-5)
    dx, dg, db = lbwd.kernel(x, g, mu, rstd, dy)
    wy, wmu, wrstd = lfwd.plain(x, g, b, 1e-5)
    wdx, wdg, wdb = lbwd.plain(x, g, wmu, wrstd, dy, 1e-5)
    ln_report = {n: _parity(a, w, tol) for n, a, w, tol in (
        ("y", y, wy, 1e-5), ("mu", mu, wmu, 1e-5), ("rstd", rstd, wrstd,
                                                    1e-5),
        ("dx", dx, wdx, 1e-4), ("dgamma", dg, wdg, 1e-4),
        ("dbeta", db, wdb, 1e-4))}
    _say_parity("layernorm", "vit_b16_12608x768", torch.float32, ln_report)
    bad = {n: r for n, r in {**report, **ln_report}.items() if not r[3]}
    if bad:
        raise RuntimeError(f"kernels at ViT-B/16's shapes: {bad}")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ms_f = time_ms(lambda: fwd.kernel(q, k, v, False, scale), flush)
    ms_b = time_ms(lambda: bwd.kernel(q, k, v, out, lse, dout, False,
                                      scale), flush)
    plain_f = time_ms(lambda: fwd.plain(q, k, v, False, scale), flush)
    plain_b = time_ms(lambda: bwd.plain(q, k, v, out, lse, dout, False,
                                        scale), flush)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)

    lib_f = time_ms(sdpa, flush)
    lib_fb = time_ms(lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dout.transpose(1, 2)), flush)
    for entry, ms, plain_ms, lib_ms, args in (
            (fwd, ms_f, plain_f, lib_f, (q, k, v, False, scale)),
            (bwd, ms_b, plain_b, lib_fb - lib_f,
             (q, k, v, out, lse, dout, False, scale))):
        bound_ms, bound_by = _bound(entry, *args)
        say("kernel_time", kernel=entry.name, card=smi,
            shape="64x197x12x64 bf16 non-causal (ViT-B/16, O1)",
            kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms,
            library="F.scaled_dot_product_attention" + (
                " backward (forward+backward minus forward)"
                if entry is bwd else ""))
    _ln_kernel_times(lfwd, lbwd, x, g, b, dy, 1e-5, flush,
                     "12608x768 f32 (ViT-B/16 LayerNorms, O1)")


def _vit_step_parity(model, x, y, smi):
    """One O1 step's loss and every gradient with the kernels against the
    same step with each kernel replaced by its plain version."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import attention
    from paddle_tpu_torch.ops.cuda import registry

    loss_fn = paddle.nn.CrossEntropyLoss()

    def grads_of():
        with paddle.amp.auto_cast():
            loss = loss_fn(model(x), y)
        loss.backward()
        out = {n: p.grad._data.clone() for n, p in model.named_parameters()}
        for p in model.parameters():
            p.clear_grad()
        return loss, out

    registry.reset_counts()
    loss_k, grads_k = grads_of()
    kernel_counts = _counts(registry)
    registry.reset_counts()
    with _PlainKernels() as plain_calls:
        # the flash kernels' plain versions on f32 copies (as
        # train_exactness_bf16 holds the bf16 kernels), not a bf16
        # composition that rounds P and dS on its own
        attention.flash_attention_cuda = _f32_plain_flash(plain_calls)
        loss_p, grads_p = grads_of()
    plain_counts = _counts(registry)
    loss_report = _parity(loss_k._data.detach(), loss_p._data.detach(),
                          1e-4)
    # each gradient within VISION_GRAD_RTOL of its own norm plus
    # VISION_GRAD_FLOOR of the largest gradient's: at initialisation the
    # query and key projections' gradients cancel to ~1e-5 of the largest
    # (near-uniform attention) and the key biases' to ~1e-6 (a softmax
    # row is invariant to a shift of its logits), and they carry the
    # rounding of the terms that cancel
    top = max(float(g.norm()) for g in grads_p.values())
    over = {n: float((grads_k[n] - grads_p[n]).norm())
            / (VISION_GRAD_RTOL * float(grads_p[n].norm())
               + VISION_GRAD_FLOOR * top) for n in grads_k}
    rel = {n: _parity(grads_k[n], grads_p[n], 1e-4)[1] for n in grads_k}
    worst = max(over, key=over.get)
    worst3 = {n: over[n] for n in sorted(over, key=over.get)[-3:]}
    depth = len(model.encoder.layers)
    want = {"flash_attention_fwd": depth, "flash_attention_bwd": depth,
            "layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1}
    say("vit_step_parity", card=smi, amp="O1 bf16", batch=x.shape[0],
        loss_kernels=float(loss_k), loss_plain=float(loss_p),
        loss_max_abs_err=loss_report[0], grad_rtol=VISION_GRAD_RTOL,
        grad_floor=VISION_GRAD_FLOOR, worst_grad=worst,
        worst_grad_over_limit=over[worst],
        worst_grad_rel_l2_err=rel[worst], worst_three_over_limit=worst3,
        worst_three_norm_over_top={
            n: float(grads_p[n].norm()) / top for n in worst3},
        max_rel_l2_err=max(rel.values()),
        kernel_launches=kernel_counts, plain_run_launches=plain_counts,
        plain_run_calls=plain_calls)
    if (abs(float(loss_k) - float(loss_p)) > BF16_RTOL * abs(float(loss_p))
            or over[worst] > 1.0):
        raise RuntimeError(f"ViT O1 step: kernels against plain: loss "
                           f"{float(loss_k)} vs {float(loss_p)}, worst "
                           f"gradient {worst} at {over[worst]} of its "
                           f"limit")
    if kernel_counts != want or any(plain_counts.values()):
        raise RuntimeError(f"ViT O1 step launches {kernel_counts} != {want}"
                           f" or the plain run launched {plain_counts}")


def _f32_plain_flash(calls):
    """A route for ``attention.flash_attention_cuda``: an autograd
    function over the flash kernels' plain versions on f32 copies of its
    inputs, its outputs cast back to their dtype (the flash phase's
    plain versions, whose backward also reads the forward's output in
    the inputs' dtype)."""
    import torch

    from paddle_tpu_torch.ops.cuda.flash_attention_kernel import (
        flash_bwd_plain,
        flash_fwd_plain,
    )

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            scale = 1.0 / float(np.sqrt(q.shape[-1]))
            q32, k32, v32 = (x.float() for x in (q, k, v))
            out, lse = flash_fwd_plain(q32, k32, v32, causal, scale)
            out = out.to(q.dtype)
            # the backward reads the output as the layer holds it (bf16
            # under O1), as the kernels' backward does: its delta =
            # rowsum(dO * O) then rounds as theirs
            ctx.save_for_backward(q32, k32, v32, out.float(), lse)
            ctx.causal, ctx.scale = causal, scale
            return out

        @staticmethod
        def backward(ctx, dout):
            grads = flash_bwd_plain(*ctx.saved_tensors, dout.float(),
                                    ctx.causal, ctx.scale)
            return (*(g.to(dout.dtype) for g in grads), None)

    def route(q, k, v, is_causal=False):
        calls["attention"] += 1
        return PlainFlash.apply(q, k, v, bool(is_causal))

    return route


def _fit(dev, smi, label, model, steps, seed):
    """``Model.fit`` over a 4-worker loader under O1 for ``warmup +
    timed`` steps, the main path (counts reset just before, read just
    after); then one profiled ``train_batch``.  Returns (launches,
    fields for the line, the hapi Model, a held-out batch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.cuda import registry

    warmup, timed = steps
    n = (warmup + timed) * VIT_BATCH
    hapi = paddle.Model(model)
    hapi.prepare(paddle.optimizer.AdamW(learning_rate=1e-4,
                                        parameters=model.parameters()),
                 paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    loader = _timed_loader(_image_dataset(n, seed), batch_size=VIT_BATCH,
                           shuffle=True, num_workers=4, drop_last=True)
    loader.waits.clear()
    clock = _step_clock()
    clock.stamps.clear()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    registry.reset_counts()
    t0 = time.perf_counter()
    with paddle.amp.auto_cast():
        hist = hapi.fit(loader, epochs=1, verbose=0, callbacks=[clock],
                        num_iters=warmup + timed)
    torch.cuda.synchronize(dev)
    fit_s = time.perf_counter() - t0
    launches = _counts(registry)
    peak = torch.cuda.max_memory_allocated(dev)
    stamps = clock.stamps
    ms = (stamps[-1] - stamps[warmup - 1]) / timed * 1e3
    wait_ms = float(np.mean(loader.waits[warmup:])) * 1e3
    held = next(iter(paddle.io.DataLoader(_image_dataset(VIT_BATCH,
                                                         seed + 1),
                                          batch_size=VIT_BATCH)))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with paddle.amp.auto_cast():
            hapi.train_batch([held[0]], [held[1]])
        torch.cuda.synchronize(dev)
    prof_fields = _device_profile(prof, 1, ms)
    fields = dict(card=smi, model=label, amp="O1 bf16",
                  loader="DataLoader(batch_size=64, shuffle=True, "
                  "num_workers=4), ToTensor + Normalize in the workers",
                  warmup_steps=warmup, timed_steps=timed, fit_s=fit_s,
                  losses=hist["loss"], ms_per_step=ms,
                  images_per_s=VIT_BATCH / ms * 1e3,
                  loader_wait_ms_per_step=wait_ms, peak_memory_bytes=peak,
                  **prof_fields)
    if len(hist["loss"]) != warmup + timed or not all(
            np.isfinite(hist["loss"])):
        raise RuntimeError(f"{label} fit: losses {hist['loss']}")
    return launches, fields, hapi, held


def vision_phase(dev, smi):
    """The high-level vision training path through the port's Paddle API
    on the card: ``paddle.Model(net).prepare(AdamW, CrossEntropyLoss,
    Accuracy()).fit(DataLoader(...))`` under ``amp.auto_cast()`` (O1,
    bf16), the loader's 4 forked workers running ``vision.transforms``
    over synthetic uint8 images from a seed.

    - kernels at ViT-B/16's shapes: B2/B3 (bf16, 197 rows) and B4a/B4b
      (12608 x 768 f32) against their plain versions, timed against the
      bound, the plain version and SDPA / ``F.layer_norm``;
    - parity: one O1 step of ViT-B/16 (seed 0, one batch) with the
      kernels against the same step with every kernel replaced by its
      plain version: the loss within the bf16 rule, every gradient's
      error within ``VISION_GRAD_RTOL`` of its norm plus
      ``VISION_GRAD_FLOOR`` of the largest gradient's norm;
    - ViT-B/16 (patch 16, 224², hidden 768, 12 layers, 12 heads, MLP
      3072, 1000 classes, full depth) fit for 3 + 10 steps — the main
      path: wall and device ms a step, busy share, images/s, FLOPs
      (``hapi.flops`` x 3 for forward + backward) over the bf16 dense
      peak, peak memory, the ms the main thread waits on the loader a
      step; B2, B3, B4a and B4b must launch 12, 12, 25 and 25 times a
      step on this path alone;
    - ResNet-50 fit for 3 + 5 steps under the same loader: images/s,
      device ms, busy, the top device ops; no Pallas kernel is on this
      path (convolutions are cuDNN's, as the JAX package leaves them to
      XLA), BatchNorm's running statistics finite and moved;
    - ``Model.evaluate`` with ``Accuracy`` and ``Model.predict`` on a
      held-out batch, then ``Model.save`` -> ``Model.load`` into a fresh
      model on the card, the logits bitwise.

    Returns the ViT fit's launches."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.cuda import registry
    from paddle_tpu_torch.vision.models import resnet50, vit_base_patch16_224

    paddle.set_device(f"gpu:{dev.index or 0}")
    _vit_kernel_rows(dev, smi)

    paddle.seed(0)
    vit = vit_base_patch16_224()
    depth = len(vit.encoder.layers)
    x0, y0 = next(iter(paddle.io.DataLoader(_image_dataset(VIT_BATCH, 5),
                                            batch_size=VIT_BATCH)))
    _vit_step_parity(vit, x0, y0, smi)
    del x0, y0
    fwd_flops = paddle.flops(vit, (1, 3, 224, 224))
    launches, fields, hapi, held = _fit(dev, smi, "vit_base_patch16_224",
                                        vit, VIT_STEPS, seed=11)
    steps = sum(VIT_STEPS)
    per_step = {k: n / steps for k, n in launches.items()}
    want = {"flash_attention_fwd": depth, "flash_attention_bwd": depth,
            "layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1}
    step_flops = 3 * fwd_flops * VIT_BATCH
    say("vision_vit_training", **fields,
        params=sum(p.size for p in vit.parameters()),
        step_flops=step_flops, flops_source="hapi.flops (the cost walker) "
        "of one image's forward x 64 x 3", flops_over_bf16_peak=step_flops
        / (fields["ms_per_step"] / 1e3) / PEAK_FLOPS["torch.bfloat16"],
        launches_per_step=per_step, expected_per_step=want)
    if per_step != want:
        raise RuntimeError(f"ViT fit launches a step {per_step} != {want}")

    ev = hapi.evaluate(paddle.io.TensorDataset(list(held)),
                       batch_size=VIT_BATCH, verbose=0)
    preds = hapi.predict(paddle.io.TensorDataset([held[0]]),
                         batch_size=VIT_BATCH, stack_outputs=True)
    path = os.path.join(ROOT, "build", "vision_vit")
    t1 = time.perf_counter()
    hapi.save(path)
    paddle.seed(1)
    fresh = paddle.Model(vit_base_patch16_224())
    fresh.load(path)
    round_trip_s = time.perf_counter() - t1
    saved_bytes = os.path.getsize(path + ".pdparams")
    os.remove(path + ".pdparams")
    vit.eval()
    fresh.network.eval()
    with paddle.no_grad():
        a, b = vit(held[0]), fresh.network(held[0])
    bitwise = torch.equal(a._data, b._data)
    say("vision_eval_save_load", card=smi, evaluate=ev,
        predict_shape=list(preds[0].shape),
        predict_finite=bool(np.isfinite(preds[0]).all()),
        saved_bytes=saved_bytes, round_trip_s=round_trip_s,
        logits_bitwise=bitwise)
    if (not bitwise or preds[0].shape != (VIT_BATCH, 1000)
            or not np.isfinite(ev["loss"]) or not 0 <= ev["acc"] <= 1):
        raise RuntimeError(f"ViT evaluate/predict/save-load: {ev}, "
                           f"bitwise {bitwise}")
    del vit, fresh, hapi, a, b, held
    torch.cuda.empty_cache()

    paddle.seed(0)
    net = resnet50()
    bns = [m for m in net.sublayers()
           if isinstance(m, paddle.nn.BatchNorm2D)]
    r_launches, r_fields, _, _ = _fit(dev, smi, "resnet50", net,
                                      RESNET_STEPS, seed=21)
    means = [m._mean.numpy() for m in bns]
    variances = [m._variance.numpy() for m in bns]
    finite = all(np.isfinite(a).all() for a in means + variances)
    moved = all(np.abs(mu).max() > 0 for mu in means)
    say("vision_resnet50_training", **r_fields,
        params=sum(p.size for p in net.parameters()),
        kernel_launches=r_launches,
        pallas_kernels_on_path="none: convolutions are the library call "
        "(cuDNN), as the JAX package leaves them to XLA",
        batchnorm_layers=len(bns), running_stats_finite=finite,
        running_means_moved=moved)
    if not (finite and moved) or any(r_launches.values()):
        raise RuntimeError(f"ResNet-50 fit: running stats finite {finite} "
                           f"moved {moved}, launches {r_launches}")
    del net, bns
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ the fleet --
def _fleet_captures(fleet):
    """Graphs captured so far by each replica's target and draft graphs."""
    return [r.engine._graphs.captures
            + (r.engine._draft_graphs.captures
               if r.engine._draft_graphs is not None else 0)
            for r in fleet.replicas]


def _fleet_drive(fleet, prompts, new, script=None, **kw):
    """Add ``prompts`` to the fleet and step it to the end, calling
    ``script(fleet, step)`` after each fleet step and checking the page
    books of every live replica, with the kernel counts at 0 -> (outputs
    in prompt order, the counts, engine launches over the run)."""
    import warnings

    from paddle_tpu_torch.ops.cuda import registry

    base = {r.index: (r.engine, r.engine.stats["launches"])
            for r in fleet.replicas}
    registry.reset_counts()
    rids = [fleet.add_request(p, max_new_tokens=new, **kw) for p in prompts]
    outs, step = {}, 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while fleet.has_unfinished():
            for o in fleet.step():
                outs[o.request_id] = o
            if script is not None:
                script(fleet, step)
            fleet.check_invariants()
            step += 1
    counts = registry.counts()
    launches = sum(eng.stats["launches"] - n for eng, n in base.values())
    return [outs[r] for r in rids], counts, launches


def fleet_exactness_phase(dev):
    """Two replicas of the exactness phase's f32 model on the card, each
    scenario token-exact (bitwise) against one engine on the same
    prompts, every replica captured as the fleet builds it and nothing
    after,
    and the kernel on every layer of every launch: a replica killed
    mid-flight and its requests failed over; a drain under
    ``migration="always"`` moving running chains, with f32 pools (B1)
    and int8 pools (B5, the scale pages moving with the pages);
    ``disaggregate=True`` with prefix caching and n-gram speculation,
    requests handed from the prefill replica to the decode replica (one
    the full decode replica cannot take decodes where it is);
    ``parallel_step=True`` (replicas stepped in threads) under a seeded
    schedule of kills and missed heartbeats, its fleet event log equal to
    the serial run's.  Returns the (B1, B5) launches of these runs."""
    from paddle_tpu_torch.inference.llm import FaultInjector, Fleet, LLMEngine

    model, prompts = _exactness_model_and_prompts(dev)
    rng = np.random.RandomState(7)
    prompts = prompts + [list(rng.randint(0, 128, n)) for n in (9, 14)]
    shared = list(rng.randint(0, 128, 16))
    pat = list(rng.randint(0, 128, 5))
    spec_prompts = [shared + pat * 2 + list(rng.randint(0, 128, i + 2))
                    for i in range(5)]
    tiny = dict(device=dev, block_size=8, max_batch=4, token_budget=16)
    kernels = {None: "paged_ragged_attention",
               "int8": "paged_ragged_attention_quant"}
    totals = {name: 0 for name in kernels.values()}

    def chaos():
        return FaultInjector.random_fleet(5, steps=64, replicas=2,
                                          p_kill=0.03, p_heartbeat=0.1)

    scenarios = [
        ("kill", prompts, {}, lambda f, s: s == 2 and f.kill_replica(1)),
        ("drain_f32", prompts, {"migration": "always"},
         lambda f, s: s == 2 and f.drain_replica(1)),
        ("drain_int8", prompts, {"migration": "always",
                                 "quantize": "int8"},
         lambda f, s: s == 2 and f.drain_replica(1)),
        ("disaggregate", spec_prompts,
         {"disaggregate": True, "speculative": 2}, None),
        ("serial", prompts, {"faults": chaos()}, None),
        ("parallel", prompts, {"faults": chaos(), "parallel_step": True},
         None),
    ]
    logs = {}
    for name, ps, kw, script in scenarios:
        quantize = kw.get("quantize")
        ref_kw = {k: v for k, v in kw.items()
                  if k in ("quantize", "speculative")}
        want = LLMEngine(model, **tiny, **ref_kw).generate(ps,
                                                           max_new_tokens=10)
        fleet = Fleet(model, replicas=2, **tiny, **kw)
        fleet.warmup()
        captures = _fleet_captures(fleet)
        if not all(captures):
            raise RuntimeError(f"fleet {name}: a replica was built "
                               f"without capturing its graphs: {captures}")
        outs, counts, launches = _fleet_drive(fleet, ps, 10, script)
        kernel = kernels[quantize]
        totals[kernel] += counts[kernel]
        same = [o.ok and np.array_equal(o.all_ids, w)
                for o, w in zip(outs, want)]
        logs[name] = (fleet.events, [o.all_ids.tolist() for o in outs])
        say("fleet_exactness", scenario=name, replicas=2,
            states=fleet.replica_states(), bitwise=all(same),
            stats=fleet.stats, kernel_launches=counts[kernel],
            engine_launches=launches,
            captures_at_warmup=captures,
            captures_after_warmup=[a - b for a, b in zip(
                _fleet_captures(fleet), captures)])
        if not all(same):
            raise RuntimeError(f"fleet {name}: requests "
                               f"{[i for i, s in enumerate(same) if not s]} "
                               f"differ from one engine")
        if (_fleet_captures(fleet) != captures
                or counts[kernel] != model.config.num_layers
                * launches):
            raise RuntimeError(f"fleet {name}: captures after warmup, or "
                               f"{counts[kernel]} kernel launches for "
                               f"{launches} engine launches")
        moved = fleet.stats["migrated"]
        handoffs = {(e[3], e[4]) for e in fleet.events if e[1] == "migrate"}
        if ((name.startswith("drain") and not moved)
                or (name == "disaggregate"
                    and (not moved or handoffs != {(0, 1)}))
                or (name == "kill" and not fleet.stats["requeued"])):
            raise RuntimeError(f"fleet {name} moved nothing: {fleet.stats}")
        del fleet
    if logs["parallel"] != logs["serial"]:
        raise RuntimeError("parallel_step's fleet events or outputs differ "
                           "from serial stepping's")
    if not any(e[1] == "dead" for e in logs["serial"][0]):
        raise RuntimeError("the seeded schedule killed no replica")
    return totals["paged_ragged_attention"], \
        totals["paged_ragged_attention_quant"]


def _fleet_burst(target, dev, new=64, prompts=None, sampled=None):
    """The serving burst (``_burst_prompts``) through an engine or a
    fleet after its warmup, with the counts at 0 -> (outputs in request
    order, counts, engine launches, the record's numbers)."""
    import torch

    from paddle_tpu_torch.ops.cuda import registry

    if prompts is None:
        prompts, sampled = _burst_prompts()
    engines = ([r.engine for r in target.replicas]
               if hasattr(target, "replicas") else [target])
    base = [(e, e.stats["launches"], e.stats["steps"]) for e in engines]
    registry.reset_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    rids = [target.add_request(p, max_new_tokens=new,
                               temperature=0.8 if i in sampled else 0.0,
                               seed=sampled.get(i))
            for i, p in enumerate(prompts)]
    # first tokens stamped on the host clock as this loop sees them (a
    # migrated request's engine stamps stay on its first engine)
    outs, first, steps = {}, {}, 0
    while target.has_unfinished():
        done = target.step()
        now = time.perf_counter()
        for o in done:
            outs[o.request_id] = o
            first.setdefault(o.request_id, now)
        for rid, req in target._requests.items():
            if req.output_ids:
                first.setdefault(rid, now)
        steps += 1
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = registry.counts()
    outs = [outs[r] for r in rids]
    bad = [i for i, o in enumerate(outs) if o.finish_reason != "length"
           or len(o.output_ids) != new]
    if bad:
        raise RuntimeError(f"requests {bad} did not emit {new} tokens")
    launches = sum(e.stats["launches"] - n for e, n, _ in base)
    ttft = [first[r] - t0 for r in rids]
    record = dict(requests=len(rids), wall_s=wall, steps=steps,
                  tokens_per_s=sum(len(o.output_ids) for o in outs) / wall,
                  wall_ms_per_step=wall / steps * 1e3,
                  ttft_p50_ms=float(np.median(ttft)) * 1e3,
                  engine_launches=launches)
    return outs, counts, launches, record


def _burst_divergences(model, dev, sampled, got, want, bound=0.5):
    """First divergences of the greedy requests of a fleet burst from the
    single engine's, each with the single engine's top-2 logit gap there
    (from a ``logprobs=2`` run of the same burst, whose batches and
    tokens are the timed run's).  A gap over ``bound`` raises: in bf16
    only a near-tie may flip when a request runs in another batch."""
    from paddle_tpu_torch.inference.llm import LLMEngine

    greedy = [i for i in range(len(got)) if i not in sampled]
    g = {i: got[i].output_ids.tolist() for i in greedy}
    w = {i: want[i].output_ids.tolist() for i in greedy}
    if g == w:
        return []
    prompts, _ = _burst_prompts()
    ref = LLMEngine(model, device=dev, **_SERVE_ENGINE)
    rids = [ref.add_request(p, max_new_tokens=len(want[0].output_ids),
                            temperature=0.8 if i in sampled else 0.0,
                            seed=sampled.get(i), logprobs=2)
            for i, p in enumerate(prompts)]
    outs = _drive(ref)
    reference = {n: outs[rids[i]] for n, i in enumerate(greedy)}
    rows = _first_divergences([g[i] for i in greedy],
                              [w[i] for i in greedy], reference, bound)
    for row in rows:
        row["request"] = greedy[row["request"]]
    return rows


def _replica_bytes(eng):
    """What one replica holds on the card by construction: its pools
    with their sinks (and scale pools), the step graphs' pool."""
    pools = sum(t.numel() * t.element_size() for t in (
        eng._k_rows, eng._v_rows, eng._ks_flat, eng._vs_flat)
        if t is not None)
    return {"pool_bytes": pools, "graph_pool_bytes": eng._graphs.pool_bytes(),
            "weights_bytes": sum(w.numel() * w.element_size()
                                 for sub in eng.params.values()
                                 for w in sub.values())}


def _build_measured_fleet(model, dev, **kw):
    """A 2-replica fleet whose replicas are measured: device bytes
    allocated and reserved around each engine's construction and around
    its ``warmup()`` (which the fleet runs as it builds the replica, from
    the engine's return to the next construction), beside its pools
    (sinks and scales included), its graph pool and the weight bytes it
    holds alone (a leaf whose tensor the other replica also holds is
    shared)."""
    import torch

    from paddle_tpu_torch.inference.llm import Fleet, LLMEngine

    def held():
        torch.cuda.synchronize(dev)
        return (torch.cuda.memory_allocated(dev),
                torch.cuda.memory_reserved(dev))

    marks = []

    def factory(m, **ekw):
        before = held()
        eng = LLMEngine(m, **ekw)
        marks.append((before, held()))
        return eng

    fleet = Fleet(model, replicas=2, engine_factory=factory, device=dev,
                  **_SERVE_ENGINE, **kw)
    ends = [before for before, _ in marks[1:]] + [held()]
    p0, p1 = (r.engine.params for r in fleet.replicas)
    shared = sum(w.numel() * w.element_size() for g in p0
                 for k, w in p0[g].items()
                 if w.data_ptr() == p1[g][k].data_ptr())
    mem = []
    for r, (before, built), end in zip(fleet.replicas, marks, ends):
        construct = [a - b for a, b in zip(built, before)]
        warm = [a - b for a, b in zip(end, built)]
        own = _replica_bytes(r.engine)
        own_weights = own["weights_bytes"] - shared
        mem.append({"replica": r.index,
                    "construct_bytes": construct[0],
                    "warmup_bytes": warm[0],
                    "construct_reserved_bytes": construct[1],
                    "warmup_reserved_bytes": warm[1],
                    "total_reserved_bytes": construct[1] + warm[1],
                    **own, "shared_weights_bytes": shared,
                    "own_weights_bytes": own_weights,
                    "predicted_bytes": own["pool_bytes"]
                    + own["graph_pool_bytes"] + own_weights,
                    "capture_ms": dict(r.engine._graphs.capture_ms)})
    return fleet, mem


def _drain_migration(fleet, dev, prompts, new=64):
    """Serve ``prompts`` on the fleet and drain replica 1 once every
    request has its first token, under ``migration="always"``: each
    handoff's pages, bytes and ms beside ``migration_estimate`` under
    ``"h100"`` and the choice ``"auto"`` would have made -> (the
    handoffs, the outputs, the counts)."""
    import torch

    from paddle_tpu_torch.inference.llm import MigrationPolicy

    auto = MigrationPolicy(mode="auto", profile="h100")
    n0 = len(fleet.migration_ms)
    plan = {}

    def script(f, step):
        src = f.replicas[1]
        if plan or src.state != "healthy":
            return
        running = list(src.engine.scheduler.running)
        if not running or src.engine.scheduler.waiting or not all(
                r.prefill_done for r in running):
            return
        for req in running:
            est = auto.estimate(src.engine, req)
            plan[req.request_id] = {
                "tokens": req.num_cached, "estimate": est,
                "auto": auto.decide(src.engine, req)}
        torch.cuda.synchronize(dev)
        f.drain_replica(1)

    outs, counts, launches = _fleet_drive(fleet, prompts, new, script)
    moved = len(fleet.migration_ms) - n0
    moves = [e for e in fleet.events if e[1] == "migrate"]
    moves = moves[len(moves) - moved:]
    page = fleet.replicas[0].engine.page_bytes
    handoffs = [{"request": e[2], "pages": e[5], "bytes": e[5] * page,
                 "ms": ms, **plan.get(e[2], {})}
                for e, ms in zip(moves, fleet.migration_ms[n0:])]
    if not handoffs:
        raise RuntimeError(f"the drain migrated nothing: {fleet.stats}")
    return handoffs, outs, counts, launches


def fleet_phase(dev, smi):
    """Two GPT-124M bf16 replicas on one card at the serving settings
    (random weights from seed 0, ``migration="always"``): each replica's
    device bytes around its construction and warmup beside its pools,
    sinks and graph pool (and a weight copy where the weights are not
    shared), capture ms per bucket; the serving burst through the router
    against one engine's (tokens/s, affinity hits, first divergences of
    the greedy requests with their top-2 gaps), no capture after warmup,
    B1 on every layer of every launch; a drain of replica 1 mid-decode
    (each handoff's pages, bytes, ms beside ``migration_estimate`` under
    ``"h100"`` and ``"auto"``'s choice); a kill and a restart of replica
    1 (the restart's capture ms, device bytes after it against before
    the kill, the restarted replica serving); the burst again on a fleet
    stepped with ``parallel_step=True`` (events and outputs equal to the
    serial fleet's, wall ms per fleet step against serial).  Returns (B1
    launches, the serial burst's record, the model)."""
    import gc
    import warnings

    import torch

    from paddle_tpu_torch.framework.cost import DEVICE_PROFILES
    from paddle_tpu_torch.inference.llm import Fleet, LLMEngine
    from paddle_tpu_torch.models.gpt import gpt_124m

    model = gpt_124m(device=dev, seed=0, dtype=torch.bfloat16).eval()
    layers = model.config.num_layers
    prompts, sampled = _burst_prompts()
    single = LLMEngine(model, device=dev, **_SERVE_ENGINE)
    single.warmup()
    want, _, _, single_rec = _fleet_burst(single, dev)
    del single
    gc.collect()
    torch.cuda.empty_cache()

    fleet, mem = _build_measured_fleet(model, dev, migration="always")
    for m in mem:
        say("fleet_memory", card=smi, **m)
    captures = _fleet_captures(fleet)
    watcher = fleet.warmup()
    got, counts, launches, rec = _fleet_burst(fleet, dev)
    watcher.assert_no_new_captures()
    b1 = counts["paged_ragged_attention"]
    divergences = _burst_divergences(model, dev, sampled, got, want)
    say("fleet_burst", card=smi, replicas=2, single=single_rec, fleet=rec,
        tokens_per_s_vs_single=rec["tokens_per_s"]
        / single_rec["tokens_per_s"],
        router=fleet.router.stats(), kernel_launches=b1,
        warmup_ms=watcher.compile_ms,
        captures_after_warmup=[a - b for a, b in zip(
            _fleet_captures(fleet), captures)],
        greedy_equal_to_single=sum(
            1 for i, (g, w) in enumerate(zip(got, want))
            if i not in sampled and g.output_ids.tolist()
            == w.output_ids.tolist()),
        first_divergences=divergences)
    if b1 != layers * launches or _fleet_captures(fleet) != captures:
        raise RuntimeError(f"fleet burst: {b1} B1 launches for {launches} "
                           f"engine launches, or captures after warmup")
    serial = (fleet.events[:], [o.output_ids.tolist() for o in got], rec)

    handoffs, outs, counts, launches = _drain_migration(fleet, dev,
                                                        prompts[:8])
    b1 += counts["paged_ragged_attention"]
    say("fleet_migration", card=smi, dtype="bfloat16",
        page_bytes=fleet.replicas[0].engine.page_bytes,
        migrated=fleet.stats["migrated"],
        migrated_bytes=fleet.stats["migrated_bytes"],
        link_gb_per_s_h100=DEVICE_PROFILES["h100"]["ici_bytes_per_s"] / 1e9,
        handoffs=handoffs,
        ms_median=float(np.median([h["ms"] for h in handoffs])),
        equal_to_single=sum(1 for o, w in zip(outs, want[:8])
                            if o.output_ids.tolist()
                            == w.output_ids.tolist()))
    if counts["paged_ragged_attention"] != layers * launches:
        raise RuntimeError("drain run: B1 not on every layer of every "
                           "launch")

    torch.cuda.synchronize(dev)
    gc.collect()
    before = torch.cuda.memory_allocated(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fleet.kill_replica(1)
    t0 = time.perf_counter()
    fleet.restart_replica(1)
    torch.cuda.synchronize(dev)
    restart_ms = (time.perf_counter() - t0) * 1e3
    after = torch.cuda.memory_allocated(dev)
    fresh = fleet.replicas[1].engine
    caps = fresh._graphs.captures
    n_events = len(fleet.events)
    rng = np.random.RandomState(31)
    cold = [list(rng.randint(0, 50257, n)) for n in (40, 60, 80, 100)]
    outs, counts, launches = _fleet_drive(fleet, cold, 16)
    b1 += counts["paged_ragged_attention"]
    served = sum(1 for e in fleet.events[n_events:]
                 if e[1] == "route" and e[3] == 1)
    say("fleet_restart", card=smi, restart_ms=restart_ms,
        capture_ms=dict(fresh._graphs.capture_ms),
        bytes_before_kill=before, bytes_after_restart=after,
        bytes_delta=after - before,
        replica_bytes=mem[1]["construct_bytes"] + mem[1]["warmup_bytes"],
        routed_to_restarted=served,
        captures_after_restart=fresh._graphs.captures - caps)
    if (abs(after - before) > 0.02 * (mem[1]["construct_bytes"]
                                      + mem[1]["warmup_bytes"])
            or fresh._graphs.captures != caps or not served
            or not all(o.finish_reason == "length" for o in outs)):
        raise RuntimeError(f"restart: {after - before} bytes more than "
                           f"before the kill, or captures after warmup, "
                           f"or the requests failed")
    del fleet, fresh
    gc.collect()
    torch.cuda.empty_cache()

    par = Fleet(model, replicas=2, parallel_step=True, migration="always",
                device=dev, **_SERVE_ENGINE)
    captures = _fleet_captures(par)
    par.warmup()
    got, counts, launches, prec = _fleet_burst(par, dev)
    b1 += counts["paged_ragged_attention"]
    same = (par.events == serial[0]
            and [o.output_ids.tolist() for o in got] == serial[1])
    say("fleet_parallel_step", card=smi, serial=serial[2], parallel=prec,
        wall_ms_per_step_vs_serial=prec["wall_ms_per_step"]
        / serial[2]["wall_ms_per_step"], events_equal_to_serial=same,
        captured_at_build=captures,
        captures_after_build=[a - b for a, b in zip(
            _fleet_captures(par), captures)])
    if (not same or _fleet_captures(par) != captures
            or counts["paged_ragged_attention"] != layers * launches):
        raise RuntimeError("parallel_step: events or outputs differ from "
                           "serial stepping, or captures after warmup")
    del par
    gc.collect()
    torch.cuda.empty_cache()
    return b1, serial[2], model


def fleet_int8_phase(dev, smi, model):
    """The fleet phase's two replicas with ``quantize="int8"`` (B5): each
    replica's device bytes, the burst (no capture after warmup, B5 on
    every layer of every launch, B1 never), then a drain of replica 1
    moving int8 chains with their scale pages: ms and bytes a handoff.
    Returns the B5 launches."""
    import gc

    import torch

    prompts, _ = _burst_prompts()
    layers = model.config.num_layers
    fleet, mem = _build_measured_fleet(model, dev, quantize="int8",
                                       migration="always")
    for m in mem:
        say("fleet_int8_memory", card=smi, **m)
    captures = _fleet_captures(fleet)
    _, counts, launches, rec = _fleet_burst(fleet, dev)
    b5 = counts["paged_ragged_attention_quant"]
    if (b5 != layers * launches or counts["paged_ragged_attention"]
            or _fleet_captures(fleet) != captures):
        raise RuntimeError(f"int8 fleet burst: B5 {b5} for {launches} "
                           f"launches, B1 {counts['paged_ragged_attention']}"
                           f", or captures after warmup")
    handoffs, outs, counts, launches = _drain_migration(fleet, dev,
                                                        prompts[:8])
    b5 += counts["paged_ragged_attention_quant"]
    say("fleet_int8", card=smi, burst=rec,
        page_bytes_with_scales=fleet.replicas[0].engine.page_bytes,
        migrated=fleet.stats["migrated"],
        migrated_bytes=fleet.stats["migrated_bytes"], handoffs=handoffs,
        ms_median=float(np.median([h["ms"] for h in handoffs])),
        kernel_launches=b5)
    if counts["paged_ragged_attention_quant"] != layers * launches:
        raise RuntimeError("int8 drain: B5 not on every layer of every "
                           "launch")
    del fleet
    gc.collect()
    torch.cuda.empty_cache()
    return b5


def fleet_front_end_phase(dev, smi, model):
    """``HttpLLMServer(fleet=...)`` over two warmed bf16 replicas: the
    front end's burst posted at once from a client thread each (the
    fork family ``n=2`` refused with a 400, as a fleet refuses it), every
    completion its expected finish reason and promise, tokens/s and
    client TTFT p50, no page leaked, no capture after warmup, B1 on
    every layer of every launch.  Returns the B1 launches."""
    import gc

    import torch

    from paddle_tpu_torch.inference.llm import Fleet, HttpLLMServer
    from paddle_tpu_torch.ops.cuda import registry

    fleet = Fleet(model, replicas=2, device=dev,
                  detokenizer=_toy_detokenizer, **_SERVE_ENGINE)
    fleet.warmup()
    captures = _fleet_captures(fleet)
    vocab = fleet.replicas[0].engine.vocab_size
    burst = [r for r in _front_end_requests(6, vocab) if r[0] != "n2"]
    base = sum(r.engine.stats["launches"] for r in fleet.replicas)
    registry.reset_counts()
    srv = HttpLLMServer(fleet=fleet).start()
    try:
        results, wall = _post_all(srv.address, [b for _, b, _ in burst])
        status, resp = _http(srv.address, "POST", "/v1/completions",
                             {"prompt_ids": [1, 2, 3], "n": 2, "seed": 0})
        if status != 400:
            raise RuntimeError(f"n=2 on a fleet got {status} {resp}")
    finally:
        srv.close()
    launches = registry.counts()["paged_ragged_attention"]
    engine_launches = sum(r.engine.stats["launches"]
                          for r in fleet.replicas) - base
    tokens, ttft = 0, []
    for (label, body, expect), res in zip(burst, results):
        if body.get("stream"):
            done, first, _ = res
            comps = done["completions"]
            ttft.append(first)
        else:
            status, resp = res
            if status != 200:
                raise RuntimeError(f"{label}: status {status} {resp}")
            comps = resp["completions"]
        _check_completions(label, comps, expect, vocab)
        tokens += sum(len(c["output_ids"]) for c in comps)
    leaked = sum(r.engine.num_blocks - r.engine.block_manager.num_free_blocks
                 for r in fleet.replicas)
    say("fleet_front_end", card=smi, replicas=2, requests=len(burst) + 1,
        http_wall_s=wall, http_tokens_per_s=tokens / wall,
        client_ttft_p50_ms=float(np.median(ttft)) * 1e3,
        router=fleet.router.stats(), kernel_launches=launches,
        engine_launches=engine_launches, pages_leaked=leaked,
        captures_after_warmup=[a - b for a, b in zip(
            _fleet_captures(fleet), captures)])
    if (launches != model.config.num_layers * engine_launches
            or leaked or _fleet_captures(fleet) != captures):
        raise RuntimeError("fleet front end: B1 launches off, pages "
                           "leaked or captures after warmup")
    del fleet, srv
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def fleet_disagg_phase(dev, smi, model, unified):
    """``disaggregate=True`` on the serving burst: replica 0 prefills,
    replica 1 decodes; each handoff's ms, and TTFT and tokens/s beside
    the unified fleet's burst (``unified``, the fleet phase's serial
    record).  Returns the B1 launches."""
    import gc

    import torch

    from paddle_tpu_torch.inference.llm import Fleet

    fleet = Fleet(model, replicas=2, disaggregate=True, device=dev,
                  **_SERVE_ENGINE)
    fleet.warmup()
    captures = _fleet_captures(fleet)
    _, counts, launches, rec = _fleet_burst(fleet, dev)
    b1 = counts["paged_ragged_attention"]
    moves = [e for e in fleet.events if e[1] == "migrate"]
    say("fleet_disagg", card=smi, roles=fleet.roles(), burst=rec,
        unified=unified, handoffs=len(moves),
        handoff_pages=[e[5] for e in moves],
        handoff_ms=fleet.migration_ms,
        handoff_ms_median=(float(np.median(fleet.migration_ms))
                           if fleet.migration_ms else None),
        ttft_p50_vs_unified=rec["ttft_p50_ms"] / unified["ttft_p50_ms"],
        tokens_per_s_vs_unified=rec["tokens_per_s"]
        / unified["tokens_per_s"], kernel_launches=b1)
    if (b1 != model.config.num_layers * launches or not moves
            or _fleet_captures(fleet) != captures):
        raise RuntimeError("disaggregated burst: no handoff, B1 launches "
                           "off or captures after warmup")
    del fleet
    gc.collect()
    torch.cuda.empty_cache()
    return b1


def _replay_device_ms(eng, pk, reps=20):
    """CUDA-event ms of replaying the graph of ``pk``'s bucket on its
    staged operands (median of ``reps``)."""
    import torch

    eng._ragged_fn(pk)                 # stage the operands, replay once
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eng._graphs.replay(pk["tb"])
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return float(np.median(ms))


def sim_phase(dev, smi, model):
    """The discrete-event simulator against the card: ``calibrate`` on a
    ``sim/workloads.py`` fleet trace of 64 requests through two GPT-124M
    bf16 replicas on the card (the real leg, stepped on a virtual clock)
    and through SimEngines replaying its tokens — decision-exact (fleet
    and engine event records equal) and token-exact, with
    ``timing_err``; the ``"h100"`` StepTimeModel's estimate for buckets 8
    and 256 (context 512) beside the replayed step's CUDA-event ms at
    that context; the wall time of a pure simulation of 8 replicas and
    2000 requests on the host, with the process's resident host bytes
    before it and with its fleet alive (the SimEngines share one host
    copy of the weights).  Returns the real leg's B1 launches."""
    import gc

    import torch

    from paddle_tpu_torch.framework.cost import StepTimeModel
    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.ops.cuda import registry
    from paddle_tpu_torch.sim import (
        calibrate,
        fleet_trace,
        simulate,
        thousand_tenant_trace,
    )

    trace = fleet_trace(64, 4000.0, 32, seed=0, prefix_len=32)
    registry.reset_counts()
    t0 = time.perf_counter()
    cal = calibrate(model, trace, replicas=2,
                    engine_kwargs=dict(_SERVE_ENGINE, device=dev))
    wall = time.perf_counter() - t0
    b1 = registry.counts()["paged_ragged_attention"]
    say("sim_calibrate", card=smi, requests=64, replicas=2,
        decisions_exact=cal["decisions_exact"],
        tokens_exact=cal["tokens_exact"], timing_err=cal["timing_err"],
        events_real=cal["events_real"], events_sim=cal["events_sim"],
        real_wall_s=cal["real"]["wall_s"], sim_wall_s=cal["sim"]["wall_s"],
        virtual_s=cal["real"]["virtual_s"], wall_s=wall,
        kernel_launches=b1)
    if not (cal["decisions_exact"] and cal["tokens_exact"]) or not b1:
        raise RuntimeError("calibration is not decision- and token-exact "
                           "against the card")
    gc.collect()
    torch.cuda.empty_cache()

    eng = LLMEngine(model, device=dev, **_SERVE_ENGINE)
    eng.warmup()
    stm = StepTimeModel.from_engine(eng)
    rng = np.random.RandomState(17)
    pages = eng.max_pages
    rows = {8: [(1, 512)] * 8, 256: [(32, 480)] * 8}
    ratio = {}
    for tb, spec in rows.items():
        pk = eng._pack_rows(
            [(rng.randint(0, eng.vocab_size, n), pos0,
              (np.arange(pages) + r * pages) % eng.num_blocks)
             for r, (n, pos0) in enumerate(spec)], tb)
        measured = _replay_device_ms(eng, pk)
        est = stm.step_seconds("ragged", tb) * 1e3
        ratio[tb] = {"estimate_ms": est, "replay_ms": measured,
                     "estimate_over_measured": est / measured}
    say("sim_step_time_model", card=smi, profile="h100",
        context_tokens=eng.max_model_len // 2, buckets=ratio,
        times_s=stm.to_dict()["times_s"])
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    def rss():
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) * 1024 for line in f
                        if line.startswith("VmRSS:"))

    trace = thousand_tenant_trace(2000, 2000.0, 32, seed=1)
    gc.collect()
    rss0 = rss()
    t0 = time.perf_counter()
    res, fleet = simulate(model, trace, replicas=8,
                          engine_kwargs=dict(_SERVE_ENGINE),
                          fleet_kwargs=dict(router_load_cap=2),
                          latency=True)
    wall = time.perf_counter() - t0
    rss1 = rss()
    engines = [r.engine for r in fleet.replicas]
    shared = all(e.params[g][k].data_ptr() == w.data_ptr()
                 for e in engines[1:] for g, sub in engines[0].params.items()
                 for k, w in sub.items())
    weights = sum(w.numel() * w.element_size()
                  for sub in engines[0].params.values() for w in sub.values())
    say("sim_simulate", replicas=8, requests=res["requests"],
        wall_s=wall, run_wall_s=res["wall_s"], steps=res["steps"],
        virtual_s=res["virtual_s"], ttft_ms=res["ttft_ms"],
        tpot_ms=res["tpot_ms"], requests_per_wall_s=res["requests_per_wall_s"],
        host_rss_before=rss0, host_rss_with_fleet=rss1,
        host_rss_delta=rss1 - rss0, weights_bytes_a_replica=weights,
        weights_shared_by_replicas=shared)
    if res["requests"] != 2000 or not shared:
        raise RuntimeError(f"the simulation finished {res['requests']} of "
                           f"2000 requests, or its replicas hold weights "
                           f"of their own")
    del fleet
    return b1


# --------------------------------------------------- tensor parallel --
# two ranks on the one card: gloo carries their all-reduces through the
# host, since NCCL refuses two ranks on one device
_TP_MESH = ["cuda:0", "cuda:0"]


def _tp_launches(before, after):
    """Each rank's (B1, B5) launches between two ``_rank_stats()``
    readings."""
    names = ("paged_ragged_attention", "paged_ragged_attention_quant")
    return [tuple(a["launches"][n] - b["launches"][n] for n in names)
            for b, a in zip(before, after)]


def _tp_run(eng, reqs):
    """Serve ``(prompt, new tokens, adapter)`` requests at once -> each
    one's output ids, in order."""
    rids = [eng.add_request(p, max_new_tokens=n, adapter_id=a)
            for p, n, a in reqs]
    outs = _drive(eng)
    return [outs[r].output_ids.tolist() for r in rids]


def _tp_pair(one, eng, scenarios, kernel):
    """Each scenario (a name and its requests) through the tp=1 engine
    ``one``, then through the tp=2 engine ``eng`` with every rank's
    launches read around it: tokens equal scenario by scenario, and on
    each rank ``kernel`` (0 = B1, 1 = B5) launched on every layer of
    every target launch (and every draft layer of every draft launch),
    the other kernel never.  Returns (each rank's launches of ``kernel``,
    the per-scenario records)."""
    rows, per_rank = [], [0] * eng.tp
    for name, reqs in scenarios:
        want = _tp_run(one, reqs)
        launches0 = eng.stats["launches"], eng.stats["draft_launches"]
        before = eng._rank_stats()
        got = _tp_run(eng, reqs)
        ranks = _tp_launches(before, eng._rank_stats())
        steps = eng.stats["launches"] - launches0[0]
        drafts = eng.stats["draft_launches"] - launches0[1]
        expect = eng.num_layers * steps + (
            len(eng._draft_layers) * drafts if eng._draft_bm is not None
            else 0)
        rows.append({"scenario": name, "requests": len(reqs),
                     "tokens_equal": got == want, "launches": steps,
                     "draft_launches": drafts, "expected": expect,
                     "rank_launches": ranks})
        if got != want:
            raise RuntimeError(f"tp=2 {name}: tokens {got} != tp=1 {want}")
        for r, launches in enumerate(ranks):
            if launches[kernel] != expect or launches[1 - kernel]:
                raise RuntimeError(f"tp=2 {name}: rank {r} launched "
                                   f"{launches}, want {expect} of kernel "
                                   f"{kernel} and none of the other")
            per_rank[r] += launches[kernel]
    return per_rank, rows


def tp_exactness_phase(dev):
    """Tensor parallelism on the exactness model (gpt_tiny widths, f32),
    two ranks on the one card against a tp=1 engine, token for token: a
    LoRA + lookahead engine over 12 pages through prefix-cache hits,
    preemption with recompute and three adapters over two slots; an int8
    engine (B5) drafting with the draft model and its n-gram leg (K = 4).
    On each rank B1 (B5) runs on every layer of every launch.  Then a
    tensor_parallel= past the visible devices must be refused.  Returns
    (B1, B5) launches summed over the ranks."""
    import torch

    from paddle_tpu_torch.inference.llm import LLMEngine, LoRAConfig

    model, prompts = _exactness_model_and_prompts(dev)
    base = dict(device=dev, block_size=8, max_batch=4, token_budget=16)
    b1 = b5 = 0
    rng = np.random.RandomState(31)
    cfg = dict(base, num_blocks=12, lookahead=True,
               lora=LoRAConfig(rank=4, max_adapters=3))
    t0 = time.perf_counter()
    one = LLMEngine(model, **cfg)
    eng = LLMEngine(model, mesh=_TP_MESH, **cfg)
    spawn_s = time.perf_counter() - t0
    for e in (one, eng):
        for i in range(3):
            e.add_adapter(f"a{i}", _lora_weights(e, 40 + i, 0.3, 0.3))
    long = [list(rng.randint(0, 128, 5)) for _ in range(4)]
    lora_prompts = [list(rng.randint(0, 128, 6 + i)) for i in range(5)]
    scenarios = [
        ("prefix_cache", [(p, 8, None) for p in prompts]),
        ("preemption", [(p, 40, None) for p in long]),
        ("lora_eviction", [(p, 8, a) for p, a in zip(
            lora_prompts, [None, "a0", "a1", "a2", "a0"])])]
    ranks, rows = _tp_pair(one, eng, scenarios, 0)
    b1 += sum(ranks)
    checks = {"prefix_hit_tokens":
              eng.prefix_cache_stats()["prefix_hit_tokens"],
              "preemptions": eng.scheduler.num_preemptions,
              "lora_evictions": eng.lora_stats()["evictions"],
              "staged_hits": eng.lifecycle_stats()["staged_hits"]}
    say("tp_exactness", engine="f32 lora + lookahead, 12 pages",
        backend=eng._tp.backend, spawn_s=spawn_s,
        graph_captures=eng._graphs.captures, scenarios=rows, **checks)
    if not all(checks.values()) or eng._graphs.captures:
        raise RuntimeError(f"tp_exactness missed a path: {checks}, "
                           f"{eng._graphs.captures} captures")
    del one, eng
    cfg = dict(base, quantize="int8", speculative={
        "method": "draft-model", "num_tokens": 4, "draft_layers": 1})
    one = LLMEngine(model, **cfg)
    eng = LLMEngine(model, mesh=_TP_MESH, **cfg)
    spec = [(p, 16, None) for p in _spec_prompts()]
    ranks, rows = _tp_pair(one, eng, [("int8_draft_and_ngram", spec)], 1)
    b5 += sum(ranks)
    st = eng.spec_stats()
    say("tp_exactness", engine="int8 draft-model K=4 (n-gram leg on)",
        backend=eng._tp.backend, scenarios=rows, spec_stats=st,
        spec_stats_equal=st == one.spec_stats())
    if not (st["model_drafts"] and st["ngram_drafts"]
            and st["accepted_tokens"]) or st != one.spec_stats():
        raise RuntimeError(f"tp int8 speculation: {st} vs "
                           f"{one.spec_stats()}")
    del one, eng
    k = torch.cuda.device_count()
    try:
        LLMEngine(model, tensor_parallel=k + 1, **base)
    except ValueError as e:
        refused = str(e)
    else:
        raise RuntimeError("tensor_parallel past the visible devices was "
                           "accepted")
    if f"exceeds the {k} visible devices" not in refused:
        raise RuntimeError(f"unexpected refusal: {refused}")
    say("tp_exactness_refusal", tensor_parallel=k + 1, error=refused)
    return b1, b5


def _tp_decode_window(eng, dev, prompts, window=16):
    """Prefill ``prompts``, then ``window`` decode steps on the host
    clock -> wall ms a step and, on a tensor-parallel engine, rank 0's ms
    a step in the command broadcasts, in the all-reduces (split into the
    copies through the host, which wait for rank 0's partial, and the
    exchange, which waits for the worker's) and in the rest, beside the
    worker's own all-reduce ms; the requests are then aborted."""
    import torch

    rids = [eng.add_request(p, max_new_tokens=4 * window) for p in prompts]
    while eng.scheduler.waiting or not all(
            r.prefill_done for r in eng.scheduler.running):
        eng.step()
    torch.cuda.synchronize(dev)
    ch = None if eng._tp is None else eng._tp.channel
    marks = None if ch is None else (ch.bcast_s, ch.allreduce_s,
                                     ch.allreduces, ch.exchange_s,
                                     eng._rank_stats()[1:])
    t0 = time.perf_counter()
    for _ in range(window):
        eng.step()
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) / window * 1e3
    out = {"rows": len(prompts), "wall_ms_per_step": wall}
    if ch is not None:
        bcast = (ch.bcast_s - marks[0]) / window * 1e3
        reduce = (ch.allreduce_s - marks[1]) / window * 1e3
        exchange = (ch.exchange_s - marks[3]) / window * 1e3
        workers = [(a["allreduce_s"] - b["allreduce_s"]) / window * 1e3
                   for b, a in zip(marks[4], eng._rank_stats()[1:])]
        out.update(broadcast_ms_per_step=bcast,
                   allreduce_ms_per_step=reduce,
                   allreduce_exchange_ms_per_step=exchange,
                   allreduce_host_copies_ms_per_step=reduce - exchange,
                   allreduces_per_step=(ch.allreduces - marks[2]) / window,
                   rest_ms_per_step=wall - bcast - reduce,
                   worker_allreduce_ms_per_step=workers)
    for r in rids:
        eng.abort_request(r)
    _drive(eng)
    return out


def tp_serving_phase(dev, smi):
    """GPT-124M bf16 at the serving settings, tensor-parallel over two
    ranks on the one card, against the tp=1 engine: the 16-request burst
    (tokens/s, TTFT p50, each rank's B1 launches equal to L x the
    engine's launches, the first greedy divergences with their top-2
    gaps); each rank's device bytes against the tp-aware memory model;
    wall ms a decode step with rank 0's host share split into broadcast,
    all-reduce and the rest; one greedy request through
    ``HttpLLMServer`` over the TP engine equal to its ``generate``.  The
    numbers measure what the TP path costs on one card, not a multi-card
    speedup.  Returns B1 launches summed over the ranks."""
    import torch

    from paddle_tpu_torch.inference.llm import HttpLLMServer, LLMEngine
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.ops.cuda import registry

    def held():
        torch.cuda.synchronize(dev)
        return torch.cuda.memory_allocated(dev)

    model = gpt_124m(device=dev, seed=0, dtype=torch.bfloat16).eval()
    prompts, sampled = _burst_prompts()
    rng = np.random.RandomState(77)
    window = [list(rng.randint(0, 50257, 128)) for _ in range(8)]
    greedy = list(rng.randint(0, 50257, 40))
    one = LLMEngine(model, device=dev, **_SERVE_ENGINE)
    one.warmup()
    want, _c, _l, rec1 = _fleet_burst(one, dev)
    win1 = _tp_decode_window(one, dev, window)
    del one
    # what a process's cuBLAS workspaces hold in the caching allocator
    # (a worker's GEMMs allocate its own): the bytes they give back
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    workspaces = None
    if clear is not None:
        workspaces = held()
        clear()
        workspaces -= held()
    torch.cuda.empty_cache()
    before = held()
    t0 = time.perf_counter()
    eng = LLMEngine(model, device=dev, mesh=_TP_MESH, **_SERVE_ENGINE)
    build_s = time.perf_counter() - t0
    built = held()
    warm = eng.warmup().compile_ms
    registry.reset_counts()
    s0 = eng._rank_stats()
    got, _counts, launches, rec2 = _fleet_burst(eng, dev)
    s1 = eng._rank_stats()
    ranks = _tp_launches(s0, s1)
    expect = eng.num_layers * launches
    divergences = _burst_divergences(model, dev, sampled, got, want)
    mm = eng.memory_model()
    nbytes = eng.dtype.itemsize
    sinks = 2 * eng.num_layers * eng._nh_local * eng.head_dim * nbytes
    embed = sum(w.numel() * w.element_size()
                for w in eng.params["embed"].values())
    shared = sum(w.numel() * w.element_size()
                 for w in eng.params["embed"].values()
                 if any(w.data_ptr() == p.data_ptr()
                        for p in model.parameters()))
    memory = [{"rank": 0, "device_bytes": built - before,
               "predicted": mm["weights_bytes"] - shared
               + mm["kv_pool_bytes"] + sinks,
               "note": "allocated at construction; the embeddings are "
                       "the model's own tensors (shared)"},
              {"rank": 1, "device_bytes": s1[1]["device_bytes"],
               "predicted": mm["weights_bytes"] + mm["kv_pool_bytes"]
               + sinks, "params_bytes": s1[1]["params_bytes"],
               "pool_bytes": s1[1]["pool_bytes"],
               "unattributed": s1[1]["device_bytes"]
               - s1[1]["params_bytes"] - s1[1]["pool_bytes"],
               "rank0_cublas_workspace_bytes": workspaces,
               "note": "all the worker process holds after the burst"}]
    win2 = _tp_decode_window(eng, dev, window)
    ids = eng.generate([greedy], max_new_tokens=16)[0][len(greedy):]
    srv = HttpLLMServer(engine=eng).start()
    try:
        status, body = _http(srv.address, "POST", "/v1/completions",
                             {"prompt_ids": [int(t) for t in greedy],
                              "max_new_tokens": 16})
    finally:
        srv.close()
    http_ids = body["completions"][0]["output_ids"] if status == 200 \
        else None
    say("tp_serving", model="gpt_124m", dtype="bfloat16", nvidia_smi=smi,
        backend=eng._tp.backend, build_s=build_s, warmup_ms=warm,
        tp1=rec1, tp2=rec2,
        tokens_per_s_ratio=rec2["tokens_per_s"] / rec1["tokens_per_s"],
        ttft_p50_ratio=rec2["ttft_p50_ms"] / rec1["ttft_p50_ms"],
        rank_launches=ranks, expected_launches=expect,
        greedy_divergences=divergences, memory_model=mm,
        rank_memory=memory, decode_window_tp1=win1,
        decode_window_tp2=win2, http_status=status,
        http_equal_generate=http_ids == ids.tolist(), embed_bytes=embed,
        graph_captures=eng._graphs.captures)
    if any(r[0] != expect or r[1] for r in ranks):
        raise RuntimeError(f"tp_serving launches {ranks} != {expect}")
    if http_ids != ids.tolist() or eng._graphs.captures:
        raise RuntimeError(f"tp_serving: HTTP {status} {http_ids} != "
                           f"generate {ids.tolist()}, or a graph was "
                           f"captured ({eng._graphs.captures})")
    del eng, model
    torch.cuda.empty_cache()
    return sum(r[0] for r in ranks)


def tp_phases(dev, smi):
    """The tensor-parallel phases, each main path's launches read around
    it on every rank -> their (B1, B5) launches summed over the ranks."""
    b1, b5 = tp_exactness_phase(dev)
    b1 += tp_serving_phase(dev, smi)
    return b1, b5


def fleet_phases(dev, smi):
    """The fleet and simulator phases, each main path driven with the
    counts at 0 -> their summed (B1, B5) launches."""
    import torch

    e1, e5 = fleet_exactness_phase(dev)
    torch.cuda.empty_cache()
    b1, unified, model = fleet_phase(dev, smi)
    b5 = fleet_int8_phase(dev, smi, model)
    b1 += fleet_front_end_phase(dev, smi, model)
    b1 += fleet_disagg_phase(dev, smi, model, unified)
    b1 += sim_phase(dev, smi, model)
    del model
    torch.cuda.empty_cache()
    return e1 + b1, e5 + b5


def lora_tier_phases(dev, smi):
    """The multi-LoRA and KV-tier phases, each main path driven with the
    counts at 0 -> their summed (B1, B5) launches."""
    import torch

    b1 = lora_exactness_phase(dev)
    t1, t5 = tier_exactness_phase(dev)
    s1, s5 = lora_serving_phase(dev, smi)
    torch.cuda.empty_cache()
    k1 = kv_tier_phase(dev, smi)
    torch.cuda.empty_cache()
    return b1 + t1 + s1 + k1, t5 + s5


# ------------------------------------------------------------ tooling --
def _lint_instances(eng_by_name, dev):
    """The kernel lint on the card: K005 and K001-K004 over every kernel
    instance of each engine's bucket grid and of the other main paths'
    shapes (``kernel_lint.MAIN_PATH_SHAPES``), each plan then held to the
    card's own account of the launch (the sources' ``*_info`` entries):
    grid, threads and dynamic shared bytes equal, the card's registers,
    spills, static shared bytes and blocks an SM checked by K002.  One
    ``kernel_resources`` line a kernel of each instance.  Raises on any
    finding or mismatch."""
    from paddle_tpu_torch.framework import kernel_lint as kl
    from paddle_tpu_torch.ops.cuda import layernorm_kernel as lnk

    findings = [f.format() for f in kl.check_registry()]
    calls = []
    for engine, eng in eng_by_name.items():
        calls += [(f"{engine}/{label}", name, ops, eng.max_pages)
                  for label, name, ops in kl.engine_calls(eng)]
    calls += [(label, name, ops, None)
              for label, name, ops in kl.main_path_calls()]
    mismatched = []
    for label, name, ops, max_pages in calls:
        slots = None
        if name == "layernorm_bwd":
            (_, c), dtype = ops["x2d"]
            info = lnk.bwd_kernel_info(dtype, c, dev)
            slots = info["blocks_per_sm"] * info["sms"]
        launches, facts = kl.launch_plan(name, slots=slots, **ops)
        records = kl.card_resources(name, launches, facts, **ops)
        findings += [f.format() for f in kl.check_plan(
            name, launches, facts, max_pages=max_pages, label=label)]
        if len(records) != len(launches):
            mismatched.append(f"{label}/{name}: {len(records)} kernels on "
                              f"the card, {len(launches)} planned")
        for ln, rec in zip(launches, records):
            plan = dict(grid=list(ln.grid), threads=ln.threads,
                        smem=ln.smem)
            card = dict(grid=[rec["grid_x"], rec["grid_y"], rec["grid_z"]],
                        threads=rec["threads"], smem=rec["smem"])
            say("kernel_resources", instance=label, kernel=name,
                launch=ln.kernel, registers=rec["regs"],
                spill_bytes=rec["local_bytes"],
                static_smem_bytes=rec["static_smem"],
                dynamic_smem_bytes=rec["smem"],
                blocks_per_sm=rec["blocks_per_sm"], grid=card["grid"],
                threads=rec["threads"], plan_equal=plan == card)
            if plan != card:
                mismatched.append(f"{label}/{ln.kernel}: plan {plan}, card "
                                  f"{card}")
    say("kernel_lint", instances=len(calls), findings=findings,
        plan_mismatches=mismatched)
    if findings or mismatched:
        raise RuntimeError(f"kernel lint: {findings} {mismatched}")


def tooling_phase(dev, smi):
    """The analysis tools on the card, over GPT-124M bf16 (random weights
    from seed 0, the serving settings): the serving burst inside
    ``warmup()``'s CaptureWatcher (``_serve_burst``: zero new captures),
    then ``analyze_engine`` (every graph rule and S001, D001 after the
    burst) with zero findings, the kernel lint over the bf16 and int8
    engines, FMT, Llama and training shapes with zero findings and every
    instance's resources equal to its plan (``_lint_instances``), and the
    census under ``"h100"`` per bucket beside the replayed step's device
    ms at buckets 8 and 256 measured here: the census is a lower bound,
    so an estimate above its measurement is a miscount and raises.
    Outside the main paths' counts."""
    import torch

    from paddle_tpu_torch.framework import analysis, cost
    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.models.gpt import gpt_124m

    model = gpt_124m(device=dev, seed=0, dtype=torch.bfloat16).eval()
    eng = LLMEngine(model, device=dev, **_SERVE_ENGINE)
    _launches, _p, _s, _outs, record = _serve_burst(
        eng, dev, "paged_ragged_attention")
    say("tooling_burst", card=smi, engine_launches=record["engine_launches"],
        graph_captures_after_warmup=record["graph_captures_after_warmup"],
        warmup_ms=record["warmup_ms"])
    t0 = time.perf_counter()
    found = analysis.analyze_engine(eng)
    say("analyze_engine", card=smi, engine="gpt124m bf16",
        seconds=time.perf_counter() - t0,
        findings=[f.format() for f in found],
        captured_state_tensors=len(eng._state_ptrs))
    if found:
        raise RuntimeError(f"analyze_engine: {[f.format() for f in found]}")

    t0 = time.perf_counter()
    census = cost.run_census(eng, profile="h100")
    census_s = time.perf_counter() - t0
    rng = np.random.RandomState(17)
    pages = eng.max_pages
    rows = {8: [(1, 512)] * 8, 256: [(32, 480)] * 8}
    measured = {}
    for tb, spec in rows.items():
        pk = eng._pack_rows(
            [(rng.randint(0, eng.vocab_size, n), pos0,
              (np.arange(pages) + r * pages) % eng.num_blocks)
             for r, (n, pos0) in enumerate(spec)], tb)
        measured[tb] = _replay_device_ms(eng, pk)
    over = []
    for e in census.entries:
        est_ms = e["roofline_s"] * 1e3
        rec = dict(bucket=e["bucket"], flops=e["cost"]["flops"],
                   matmul_flops=e["cost"]["matmul_flops"],
                   hbm_bytes=e["cost"]["hbm_bytes"],
                   peak_bytes=e["cost"]["peak_bytes"],
                   bound=e["roofline"], roofline_ms=est_ms)
        if e["bucket"] in measured:
            rec.update(replay_ms=measured[e["bucket"]],
                       estimate_over_measured=est_ms / measured[e["bucket"]])
            if est_ms > measured[e["bucket"]]:
                over.append(e["label"])
        say("census", card=smi, profile="h100", **rec)
    say("census_summary", card=smi, graphs=census.compile_count,
        families=census.families, seconds=census_s,
        findings=[f.format() for f in census.findings],
        weights_bytes=census.memory["weights_bytes"],
        kv_pool_bytes=census.memory["kv_pool_bytes"])
    if over or census.findings:
        raise RuntimeError(f"census estimate above the measured replay at "
                           f"{over}, or findings {census.findings}")

    int8 = LLMEngine(model, device=dev, quantize="int8", **_SERVE_ENGINE)
    _lint_instances({"bf16": eng, "int8": int8}, dev)
    del eng, int8
    torch.cuda.empty_cache()


def dispatch_phase(dev, smi, window=16, steps=5, repeats=7):
    """Host time of the eager paths that call the kernels one by one,
    for comparing trees in one call (``python3 chip_smoke.py dispatch``
    from each checkout): Llama-160M f32 decode at batch 8 (a 2048-slot
    cache, one decode kernel a layer a step) and the GPT-124M O2 bf16
    training step at 8 x 1024 (two flash and five LayerNorm kernel calls
    a layer, 74 a step), wall ms a step after warm-up, ``repeats``
    windows each.  Where the registry's kernels are ``torch.library``
    ops, also the host µs of one op call against one call of the wrapper
    it wraps, back to back in turns (op, wrapper, wrapper, op), at the
    decode's B6 shape and the training's B4a shape.  Only entry points
    that every tree of the port has; prints no contract line."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.models.llama import llama_160m
    from paddle_tpu_torch.ops.cuda import registry

    def windows(run, n):
        out = []
        for _ in range(repeats):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                run()
            torch.cuda.synchronize(dev)
            out.append((time.perf_counter() - t0) / n * 1e3)
        return out

    model = llama_160m(device=dev, seed=0).eval()
    ids = torch.as_tensor(np.random.RandomState(88).randint(
        0, 32000, (8, 1)), device=dev)
    state = {"cache": model.init_cache(8, 2048)}

    def decode():
        state["cache"] = model.decode_step(ids, state["cache"])[1]

    for _ in range(8):                                  # warm-up
        decode()
    ms = windows(decode, window)
    say("dispatch_llama_decode", card=smi, batch=8, window=window,
        ms_per_step=ms, median_ms=float(np.median(ms)))
    del model, state
    torch.cuda.empty_cache()

    gpt = gpt_124m(device=dev, seed=0, hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0)
    gpt = amp.decorate(gpt, level="O2", dtype="bfloat16")
    step = _trainer(gpt, TRAIN_LR)
    rng = np.random.RandomState(2024)
    vocab = gpt.config.vocab_size
    tok = torch.as_tensor(rng.randint(0, vocab, (8, 1024)), device=dev)
    labels = torch.as_tensor(rng.randint(0, vocab, (8, 1024)), device=dev)
    for _ in range(2):
        step(tok, labels)
    ms = windows(lambda: step(tok, labels), steps)
    say("dispatch_training_step", card=smi, batch=8, seq=1024, steps=steps,
        ms_per_step=ms, median_ms=float(np.median(ms)))
    del gpt, step
    torch.cuda.empty_cache()

    if getattr(registry.KERNELS["decode_attention"], "op", None) is None:
        return
    cases = {
        "decode_attention": _decode_case(
            dev, torch.float32, 8, 12, 4, 64, 2048,
            np.random.RandomState(26).randint(1, 81, 8), 26),
        "layernorm_fwd": _ln_inputs(dev, torch.bfloat16, 8192, 768,
                                    seed=98)[:3] + (1e-5,),
    }
    for name, args in cases.items():
        entry = registry.KERNELS[name]
        turns = {"op": [], "wrapper": []}
        for which in ("op", "wrapper", "wrapper", "op"):
            fn = entry.op if which == "op" else entry.kernel
            turns[which].append(call_ms(lambda: fn(*args), reps=300) * 1e3)
        say("dispatch_per_call", card=smi, kernel=name, op_us=turns["op"],
            wrapper_us=turns["wrapper"],
            op_minus_wrapper_us=float(np.mean(turns["op"])
                                      - np.mean(turns["wrapper"])))


def main():
    if not os.path.isdir(os.path.join(ROOT, "paddle_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout that holds "
                         "paddle_tpu_torch/")
    sys.path.insert(0, ROOT)
    import torch

    name, smi = device_phase()
    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["ln_bwd_designs"]:
        ln_bwd_designs_phase(dev)
        return
    if sys.argv[1:] == ["lora_tier"]:
        build_phase()
        lora_tier_phases(dev, smi)
        return
    if sys.argv[1:] == ["fleet"]:
        build_phase()
        fleet_phases(dev, smi)
        return
    if sys.argv[1:] == ["tp"]:
        build_phase()
        tp_phases(dev, smi)
        return
    if sys.argv[1:] == ["tooling"]:
        build_phase()
        tooling_phase(dev, smi)
        return
    if sys.argv[1:] == ["dispatch"]:
        build_phase()
        dispatch_phase(dev, smi)
        return
    if sys.argv[1:] == ["eager"]:
        build_phase()
        eager_api_phase(dev, smi)
        return
    if sys.argv[1:] == ["vision"]:
        build_phase()
        vision_phase(dev, smi)
        return
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}")
    build_phase()
    from paddle_tpu_torch.ops.cuda import registry

    covered = [k for names in PARITY_PHASES for k in names]
    missing = sorted(set(registry.KERNELS) - set(covered))
    if missing:
        raise RuntimeError(f"kernels {missing} have no parity phase")
    records = []
    for names, phase in PARITY_PHASES.items():
        records += phase({k: registry.KERNELS[k] for k in names}, dev)
    timing_harness_phase(dev)
    exactness_phase(dev)
    int8_exactness_phase(dev)
    fmt_exactness_phase(dev)
    spec_launches = spec_exactness_phase(dev)
    train_exactness_phase(dev)
    train_exactness_bf16_phase(dev)
    graphs_phase(dev)
    torch.cuda.empty_cache()
    launches, eng = serving_phase(dev)
    decode_profile_phase(eng, dev)
    del eng
    torch.cuda.empty_cache()
    # B1's main path is the serving burst and the front end's server
    # run, each driven with the counts at 0; the line sums them
    launches["paged_ragged_attention"] += front_end_phase(dev, smi)
    torch.cuda.empty_cache()
    # and the speculation phases: spec_exactness's runs, the speculative
    # bursts and the speculative engine behind the server
    launches["paged_ragged_attention"] += (spec_launches
                                           + speculative_phase(dev, smi))
    torch.cuda.empty_cache()
    launches.update(int8_serving_phase(dev))
    torch.cuda.empty_cache()
    # and the multi-LoRA and KV-tier phases' runs, B1's and B5's
    b1, b5 = lora_tier_phases(dev, smi)
    launches["paged_ragged_attention"] += b1
    launches["paged_ragged_attention_quant"] += b5
    torch.cuda.empty_cache()
    # and the fleet and simulator phases' runs, B1's and B5's
    b1, b5 = fleet_phases(dev, smi)
    launches["paged_ragged_attention"] += b1
    launches["paged_ragged_attention_quant"] += b5
    torch.cuda.empty_cache()
    # and the tensor-parallel phases' runs, summed over the ranks
    b1, b5 = tp_phases(dev, smi)
    launches["paged_ragged_attention"] += b1
    launches["paged_ragged_attention_quant"] += b5
    torch.cuda.empty_cache()
    # B6's main path is both dense-cache decoders: each is driven with
    # the counts at 0 and read just after; the line sums them
    launches["decode_attention"] = (fmt_decode_phase(dev)
                                    + llama_decode_phase(dev))
    torch.cuda.empty_cache()
    launches.update(training_phase(dev))
    torch.cuda.empty_cache()
    # and the eager Paddle API's BERT-base paths: the timed training steps
    # (B4a, B4b) and the eval forward (B2, B4a), each counted alone
    for kernel, n in eager_api_phase(dev, smi).items():
        launches[kernel] += n
    torch.cuda.empty_cache()
    # and the vision path's ViT-B/16 fit (B2, B3, B4a, B4b), counted alone
    for kernel, n in vision_phase(dev, smi).items():
        launches[kernel] += n
    torch.cuda.empty_cache()
    tooling_phase(dev, smi)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        if not rec["launches"]:
            raise RuntimeError(f"kernel {rec['name']} was not launched on "
                               f"the main path")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
