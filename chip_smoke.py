#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, decoding and training paths on
one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py kernels          # only the build and every
                                           # kernel's parity and times
                                           # (no contract line)
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
    python3 chip_smoke.py ops              # only the op-surface phase
                                           # (ends with the contract line)
    python3 chip_smoke.py speech           # only the speech path, the
                                           # vision zoo and gpt_6_7b
                                           # (no contract line)
    python3 chip_smoke.py train_features   # only remat, fp16 loss scaling,
                                           # the profiler, the tensor
                                           # checker and the sparse stage
                                           # (no contract line)
    python3 chip_smoke.py deploy           # only the deployment slice:
                                           # f16 kernel rows, f16 serving,
                                           # the f16 FMT, the IR passes,
                                           # the ViT predictor and the
                                           # profiler-window experiment
                                           # (no contract line)
    python3 chip_smoke.py c12_control      # only the profiler-window
                                           # experiment at the full run's
                                           # process age, no profiler
                                           # opened before it (~10 min;
                                           # no contract line)
    python3 chip_smoke.py c12_control sessions N   # the same after N
                                           # short torch.profiler sessions
    python3 chip_smoke.py c12_control port N K     # and the port's
                                           # Profiler after the K-th
    python3 chip_smoke.py program          # only the program tooling
                                           # (no contract line)
    python3 chip_smoke.py distributed      # only the distributed phase
                                           # (no contract line)

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
9b. distributed — the same GPT-124M steps (10) under ``DataParallel``
              over a one-rank NCCL group, bitwise equal to unwrapped
              (ms a step of both, a profiled step of each, the
              buckets' all-reduce device ms);
              then ``python -m paddle_tpu_torch.distributed.launch
              --nproc_per_node 2`` starts two ranks on the one card
              (gloo, ``distributed_rank``): every collective on CUDA
              tensors against numpy, GPT-124M in f32 at 2 x 1024 (one
              sequence a rank) for 3 AdamW steps under ``DataParallel``
              and under ``p_g_os``, each within ``DIST_REL_TOL`` of one
              process's steps over both sequences (ms a step, the
              all-reduce's host share, each rank's peak and at-rest
              bytes), the ZeRO-3 checkpoint written by both ranks and
              loaded back bitwise (``python3 chip_smoke.py
              distributed`` runs this group alone);
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
              (2 + 4 steps; B2, B3, B4a, B4b 12, 12, 25, 25 a step),
              the ResNet-50 fit (2 + 3 steps, BatchNorm statistics),
              ``evaluate`` with ``Accuracy``, ``predict`` and a
              ``save``/``load`` round trip, logits bitwise.
13. ops    — the rest of the op surface (``ops_phase``; ``python3
              chip_smoke.py ops`` runs it alone): B2/B3 through
              ``flash_attn`` (GPT-124M's 8 x 1024 x 12 x 64 bf16, causal),
              ``fused_multi_head_attention`` (BERT-base 8 x 512 x 768 bf16)
              and ``memory_efficient_attention``, each against the same
              call on the kernels' plain versions, with its launches;
              ``Lamb`` on the eager BERT-base step and ``Momentum`` on
              ResNet-50's ``Model.fit`` (O1, batch 64), one step's update
              held to the plain rule within 1e-6, ms a step and the
              optimizer's share of device time; every op of the A23b-2
              families once on the card against the port's CPU output;
              ``nms``, ``roi_align``, ``deformable_conv``, ``warpctc``
              and ``fft_r2c`` timed at their users' sizes.
14. train_features — GPT-124M at 8 x 1024 in O2 bf16 with residual
              dropout, 5 TrainSteps with ``remat=False`` then 5 with
              ``remat=True`` from the same weights, draws and batches
              (losses and parameters within 1e-5; B2 and B4a twice a
              step under remat), 3 more under ``profiler.Profiler``
              (operator and kernel calls equal to the launch plan,
              chrome trace to chiprun_out/); the same model in O2
              float16 with ``GradScaler()``, 10 steps held to a host
              replay of the scale rule, the first loss to f32's within
              1e-2, a skipped inf step (parameters and optimizer state
              bitwise, scale halved) and the tensor checker naming the
              op an inf reaches; a SECOND-style sparse stage at KITTI's
              41 x 1600 x 1408 grid (two samples of 16,000-20,000
              voxels) against the CPU port at 1e-4, host rulebook ms
              apart from device ms (``python3 chip_smoke.py
              train_features`` runs this group alone).
15. deploy — the float16 instances of B1, B5 and B6 at their main
              shapes (strict rule, bitwise repeatable, timed); GPT-124M
              ``LLMEngine(dtype="float16")`` behind ``PredictorServer``:
              8 greedy requests (7 Python wire clients, 1 native C
              client) token-equal to ``generate``, the f16 logits
              against f32's, then the int8 KV pool (B5, f16 q); the f16
              FusedMultiTransformer (B6); a naive 12-layer GPT
              composition under ``to_static(ir_passes=True)`` (rewrites
              a pass, B2/B3/B4a/B4b against the plan, loss and
              gradients against the unrewritten trace, a control without
              the causal mask beyond both limits) and the masked
              decode composition through ``decode_attention`` (B6 f16);
              ViT-B/16 calibrated by PTQ, saved, served by
              ``create_predictor`` with f16 mixed precision (B2, B4a),
              its output held to the f32 forward, a control that drops
              the attention's tail tile beyond the limit;
              profiler windows at this age of the process (ROADMAP C12)
              (``python3 chip_smoke.py deploy`` runs this group alone).
16. program — ResNet-50 (f32) exported on the card through
              ``save_inference_model`` with a dynamic batch (op counts),
              loaded back and run at batch 1 and 64 against the eager
              model, a control with one BatchNorm's epsilon changed;
              GPT-124M on the card refused by the exporter by its
              kernel's name; GPT-124M exported from a CPU copy, served by
              ``create_predictor`` at 8 x 1024 and held to the eager
              model on the card (B2, B4a), a control with one head blind
              to its last 64 keys; 3 SGD steps of the imported program's
              ``to_layer()`` at 4 x 1024, re-exported and reloaded;
              ResNet-50 through
              ONNX and the numpy runtime; B4a/B4b registered through
              ``register_pallas_op`` (strict rule, bitwise), a C
              extension's host op on a CUDA tensor; ``CostModel`` on the
              card; the ``program`` lint on the GPT artifact, clean and
              with a dead op (``python3 chip_smoke.py program`` runs this
              group alone).

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
B2's and B4a's, the ViT-B/16 fit B2's, B3's, B4a's and B4b's, the
op surface's attention entry points B2's and B3's, the speech path's
and gpt_6_7b's, the training features' remat and fp16 steps B2's,
B3's, B4a's and B4b's, and the deployment slice's f16 server run (B1),
its int8-KV run (B5), the f16 FMT and the decode pass (B6), the IR
passes' steps (B2, B3, B4a, B4b) and the predictor's runs (B2, B4a),
and the program tooling's eager GPT-124M forward (B2, B4a) and its
``register_pallas_op`` LayerNorm (B4a, B4b), and the distributed phase's
DataParallel steps at world size 1 and the two ranks' DataParallel and
``p_g_os`` steps, summed over the ranks (B2, B3, B4a, B4b).
The second-to-last
line is that JSON record; the last line is ``{"ok": true, "device":
{...}}``.  The script imports only torch, numpy and the port.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM HBM3
PEAK_FLOPS = {"torch.bfloat16": 989e12,        # dense tensor-core bf16
              "torch.float16": 989e12,         # dense tensor-core f16
              "torch.float32": 67e12}          # f32 outside the tensor cores


_T0 = time.perf_counter()


def say(phase, **fields):
    """One JSON line: the phase, its fields, and ``t``, the seconds since
    the script started (the smoke's time budget, line by line)."""
    print(json.dumps({"phase": phase, **fields,
                      "t": round(time.perf_counter() - _T0, 3)}), flush=True)


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
    within ``f32_tol * max(1, max|want|)`` (summation order); a bf16 or
    f16 output, every element within ``1e-2 |want| + 1e-3 rms(want)``
    (its own rounding is 2^-9 or 2^-11 relative; the kernels compute in
    f32).  Returns
    (max |err|, ||err|| / ||want||, the largest err / limit, ok).  Where
    the limit is 0 (a plain output that is identically zero, as dq and
    dk are for a single key) the ratio is 0 for an exact zero and
    infinite otherwise, so ``ok`` is still ``err <= limit``."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    if got.dtype in (torch.bfloat16, torch.float16):
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
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
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
        # every head dim the JAX kernel takes: odd ones (2-byte bf16
        # rows, scalar f32 loads), rows that are 8-byte aligned (D 4, 20,
        # 36, 100 in bf16), padded to 32, 64 or 128
        *[(f"d{d}_2x300x4x{d}_causal", dt, (2, 300, 4, d), True, False)
          for d in (1, 4, 7, 20, 36, 100) for dt in (f32, bf16)],
        ("d20_noncausal_2x77q_333k_x4x20", bf16, (2, 77, 4, 20), False,
         False, 333),
        ("d36_packed_2x129x4x36", bf16, (2, 129, 4, 36), False, True),
        # the speech path's Conformer (f32, d_model 144 over 4 heads) and
        # gpt_6_7b's eval forward (bf16, causal, D 128)
        ("conformer_16x250x4x36", f32, (16, 250, 4, 36), False, False),
        ("gpt6_7b_2x2048x32x128_causal", bf16, (2, 2048, 32, 128), True,
         True),
        # the float16 instances (O2 float16 under loss scaling): the CPU
        # shape, GPT-124M's step, D 36 (2-byte-aligned rows, padded tile)
        ("cpu_f16_1x128x2x64_causal", f16, (1, 128, 2, 64), True, False),
        ("gpt124m_f16_8x1024x12x64_causal", f16, (8, 1024, 12, 64), True,
         True),
        ("d36_f16_2x300x4x36_causal", f16, (2, 300, 4, 36), True, False),
        # ViT-B/16's attention as the float16 Predictor runs it, beside
        # the bf16 row of the vision phase: non-causal, 197 rows (a tail
        # in every 64-row tile column)
        ("vit_b16_f16_64x197x12x64", f16, (64, 197, 12, 64), False, False),
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

    # the f16 backward under loss scaling: dO at 2^16 times the size of
    # the gradient a token-mean loss hands one token, 1/(B*S), at GPT's
    # shape and at D 36 (dO of 2^16 * randn itself would overflow f16 in
    # dv whatever the kernel: |dv| reaches 2e5, over 65504)
    for i, (label, shape) in enumerate((
            ("gpt124m_f16_8x1024x12x64_causal_dO_x2^16", (8, 1024, 12, 64)),
            ("d36_f16_2x300x4x36_causal_dO_x2^16", (2, 300, 4, 36)))):
        q, k, v, dout = _flash_inputs(dev, f16, *shape, seed=90 + i,
                                      packed=shape[-1] == 64)
        dout = (dout.float() * (2.0 ** 16 / (shape[0] * shape[1]))).to(f16)
        check(label, f16, q, k, v, dout, True, shape[-1] == 64,
              1.0 / float(np.sqrt(shape[-1])))

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
    # the main paths' other shapes: the Conformer's, gpt_6_7b's forward
    # and GPT-124M's float16 step (the head-dim sweep's times, the
    # evidence for C7, are in PERF.md and no main path's: the parity rows
    # above still hold every head dim)
    _flash_kernel_times(fwd, bwd, dev, f32, (16, 250, 4, 36), False, flush,
                        note=" (Conformer eval and step)")
    _flash_kernel_times(fwd, None, dev, bf16, (2, 2048, 32, 128), True,
                        flush, note=" (gpt_6_7b eval forward)")
    _flash_kernel_times(fwd, bwd, dev, f16, (8, 1024, 12, 64), True, flush,
                        note=" (GPT-124M O2 float16 step)")
    _flash_kernel_times(fwd, None, dev, f16, (64, 197, 12, 64), False, flush,
                        note=" (ViT-B/16 float16 Predictor)")
    return records


def _flash_kernel_times(fwd, bwd, dev, dtype, shape, causal, flush,
                        note=""):
    """B2 (and B3 unless ``bwd`` is None) timed at one [B, S, N, D] shape
    against the bound, the plain versions and SDPA (its backward as
    forward + backward less forward); prints a ``kernel_time`` line
    each."""
    import torch

    q, k, v, dout = _flash_inputs(dev, dtype, *shape, seed=95)
    scale = 1.0 / float(np.sqrt(shape[-1]))
    out, lse = fwd.kernel(q, k, v, causal, scale)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)

    lib_f = time_ms(sdpa, flush)
    label = (f"{'x'.join(map(str, shape))} {str(dtype)[6:]} "
             f"{'causal' if causal else 'non-causal'}{note}")
    runs = [(fwd, (q, k, v, causal, scale), lib_f, "")]
    if bwd is not None:
        lib_fb = time_ms(lambda: torch.autograd.grad(
            sdpa(), (qt, kt, vt), dout.transpose(1, 2)), flush)
        runs.append((bwd, (q, k, v, out, lse, dout, causal, scale),
                     lib_fb - lib_f,
                     " backward (forward+backward minus forward)"))
    for entry, args, lib, what in runs:
        bound_ms, bound_by = _bound(entry, *args)
        say("kernel_time", kernel=entry.name, shape=label,
            kernel_ms=time_ms(lambda: entry.kernel(*args), flush),
            plain_ms=time_ms(lambda: entry.plain(*args), flush),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
            library="F.scaled_dot_product_attention" + what)


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
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    eps = 1e-5
    cases = [("cpu_256x128", f32, 256, 128), ("gpt124m_8192x768", bf16,
                                              8192, 768),
             ("gpt124m_f32_8192x768", f32, 8192, 768),
             ("ragged_rows_8190x768", bf16, 8190, 768),
             ("few_rows_5x768", bf16, 5, 768),
             ("tall_32768x768", bf16, 32768, 768),
             ("c2048_1000x2048", bf16, 1000, 2048),
             ("bert_f32_4096x768", f32, 4096, 768),
             # the Conformer's LayerNorms (16 x 250 frames of 144, f32)
             ("conformer_f32_4000x144", f32, 4000, 144),
             # wide rows, a block's each: gpt_6_7b's 4096, 8192, the
             # first width past a warp's, a partial last chunk, few rows
             ("wide_4096x4096", bf16, 4096, 4096),
             ("wide_f32_4096x4096", f32, 4096, 4096),
             ("wide_2048x8192", bf16, 2048, 8192),
             ("wide_f32_2048x8192", f32, 2048, 8192),
             ("wide_edge_300x2056", bf16, 300, 2056),
             ("wide_partial_f32_1000x3000", f32, 1000, 3000),
             ("wide_few_rows_3x8192", bf16, 3, 8192),
             # the float16 instances: GPT-124M's step and a wide row
             ("gpt124m_f16_8192x768", f16, 8192, 768),
             ("wide_f16_4096x4096", f16, 4096, 4096),
             # ViT-B/16's LayerNorms in the float16 Predictor (64 x 197
             # rows), beside the f32 row of the vision phase
             ("vit_b16_f16_12608x768", f16, 12608, 768)]
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
    for dtype, c in ((bf16, 768), (f32, 768), (bf16, 2048), (f32, 144),
                     (bf16, 4096), (f32, 4096), (bf16, 8192), (f32, 8192),
                     (f16, 768), (f16, 4096)):
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
    spilled = {k: p["local_bytes"] for k, p in plans.items()
               if int(k.split()[0]) > lnk.NARROW_C and p["local_bytes"]}
    if spilled:
        raise RuntimeError(f"layernorm wide backward spills: {spilled}")
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
    # the Conformer's (f32) and the wide rows (gpt_6_7b's 4096 and 8192)
    for dtype, rows, c, note in ((f32, 4000, 144, " (Conformer)"),
                                 (bf16, 4096, 4096, " (gpt_6_7b)"),
                                 (f16, 8192, 768, " (GPT-124M O2 float16)"),
                                 (f16, 12608, 768,
                                  " (ViT-B/16 float16 Predictor)")):
        x, g, b, dy = _ln_inputs(dev, dtype, rows, c, seed=94)
        _ln_kernel_times(fwd, bwd, x, g, b, dy, eps, flush,
                         f"{rows}x{c} {str(dtype)[6:]}{note}")
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


def _spills(log):
    """{mangled kernel name: (spill store bytes, spill load bytes)} of
    every function whose ptxas report shows a spill."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn and (int(m.group(1)) or int(m.group(2))):
            out[fn] = (int(m.group(1)), int(m.group(2)))
    return out


def build_phase():
    from paddle_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    built = _build.build()
    for name, (seconds, log) in built.items():
        report = [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
        say("build", kernel=name, seconds=seconds, ptxas=report,
            spills=_spills(log))
    wide = {f: n for f, n in _spills(built["layernorm"][1]).items()
            if "wide" in f}
    if wide:
        raise RuntimeError(f"the wide LayerNorm kernels spill: {wide}")
    # the float16 instances of B1/B5/B6, B2/B3 and B4 (``__half`` in the
    # mangled name)
    f16 = {f: n for name in ("flash_attention", "layernorm",
                             "ragged_attention", "decode_attention")
           for f, n in _spills(built[name][1]).items() if "6__half" in f}
    if f16:
        raise RuntimeError(f"the float16 kernel instances spill: {f16}")
    # every type's D > 64 ragged split instance over pools of q's type
    # (DL 4, ``Li4E``; ``aLi4E`` is an int8 pool's, see split_min_blocks)
    dl4 = {f: n for f, n in _spills(built["ragged_attention"][1]).items()
           if "ragged_split_kernel" in f and "Li4E" in f
           and "aLi4E" not in f}
    if dl4:
        raise RuntimeError(f"the D > 64 ragged split instances spill: {dl4}")
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
    Then the plain and lookahead engines' decode windows in four pairs of
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

    # lookahead against plain in four pairs of turns, which side first
    # alternating, 8 decode rows at depth ~128-224: wall and device ms a
    # step, busy share and the host split
    ab = {"plain": [], "lookahead": []}
    order = (("plain", _STEP_PARTS), ("lookahead", _LOOKAHEAD_PARTS))
    for pair in range(4):
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


# the ``record_function`` range the ops phase puts around ``opt.step``;
# its device-side row is the range's span, not a kernel
OPT_RANGE = "optimizer.step"


def _device_profile(prof, steps, wall_ms):
    """Device ms per step, its share of the unprofiled wall ms per step,
    and the device ops that take the most time, from a torch.profiler
    window of ``steps`` steps.  Only device-side entries (kernels,
    memcpy, memset) count: an operator's own row would count its
    kernels a second time, and a range's device row its span."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0 and e.key != OPT_RANGE]
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


# new tokens a request of the async window: the 256 measured steps and
# the steps before every request decodes (600 before, cut for the
# smoke's time budget: the profiled tail after the window measured
# nothing)
ASYNC_NEW_TOKENS = 320


def _async_window(eng, serve, steps=256):
    """Decode steps replayed by the async worker while ``serve(bodies)``
    runs 8 requests (128-token prompts, ASYNC_NEW_TOKENS new tokens;
    every other one streamed when it goes through the server) to their
    end.  The prompts
    are served once first with one new token, so the run's prefill is
    each prompt's last page.  torch.profiler covers the whole run,
    started and stopped while the worker is idle: device ms per engine
    step over the run; wall ms per step on the host clock over
    ``steps`` steps once every request is decoding; the busy share."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(77)
    bodies = [{"prompt_ids": [int(t) for t in rng.randint(0, 50257, 128)],
               "max_new_tokens": ASYNC_NEW_TOKENS, "stream": i % 2 == 0}
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


# ------------------------------------------------ the distributed slice --
DIST_REL_TOL = 1e-4      # world size 2 (f32) against one process
DIST_STEPS = 3


def _gpt_dp_step(model, dp_model, lr):
    """The training phase's ``_trainer`` for ``dp_model`` (``model``
    wrapped) and its optimizer."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep

    opt = optimizer.AdamW(learning_rate=lr, parameters=dp_model.parameters(),
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0))
    return TrainStep(dp_model, lambda lg, lb: model.loss(lg, lb), opt), opt


def _rel_l2(a, b):
    """||a - b|| / ||b|| in f64 (0 where both are 0)."""
    a, b = a.double(), b.double()
    den = float(b.norm())
    return float((a - b).norm()) / den if den else float((a - b).norm())


def _dist_world1_phase(dev, smi, steps=10):
    """GPT-124M as the training phase sets it up (bf16 O2, AdamW 1e-4 +
    global-norm clip, 8 x 1024) for ``steps`` steps unwrapped, then the
    same steps from the same weights under ``DataParallel`` over a
    one-rank NCCL group: losses and weights must be bitwise equal.
    Prints ms a step of both (the steps after the first), one more step
    of each under torch.profiler (device ms and busy share), the device
    ms of the buckets' all-reduces a step (CUDA events over the same
    buffers) and the DP run's kernel launches (the main path: counts
    reset just before, read just after), which it returns."""
    import torch
    from torch import distributed as tdist
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.ops.cuda import registry

    rng = np.random.RandomState(2024)
    batch, seq = 8, 1024

    def build():
        m = gpt_124m(device=dev, seed=0, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
        return amp.decorate(m, level="O2", dtype="bfloat16")

    vocab = 50304
    ids = torch.as_tensor(rng.randint(0, vocab, (batch, seq)), device=dev)
    labels = torch.as_tensor(rng.randint(0, vocab, (batch, seq)),
                             device=dev)

    def run(wrap):
        model = build()
        target = dist.DataParallel(model) if wrap else model
        step, _ = _gpt_dp_step(model, target, TRAIN_LR)
        losses = [step(ids, labels).item()]
        registry.reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        timed = [step(ids, labels) for _ in range(steps - 1)]
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {k: registry.counts()[k] for k in _TRAIN_KERNELS}
        losses += [x.item() for x in timed]
        weights = {n: p.detach().clone() for n, p in
                   model.named_parameters()}
        ms = wall / (steps - 1) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(ids, labels)
            torch.cuda.synchronize(dev)
        prof_row = _device_profile(prof, 1, ms)
        prof_row.pop("top_device_us_per_step")
        return losses, weights, ms, launches, target, prof_row

    env = dist.init_parallel_env(device=dev)
    try:
        assert dist.get_world_size() == 1 and env.device_id == dev.index
        backend = tdist.get_backend()
        plain_losses, plain_w, plain_ms, _, _, plain_prof = run(False)
        torch.cuda.empty_cache()
        dp_losses, dp_w, dp_ms, launches, dp, dp_prof = run(True)
        bufs = [torch.empty(sum(dist.parallel._leaf(p).numel()
                                for p in b.params),
                            dtype=dist.parallel._leaf(b.params[0]).dtype,
                            device=dev) for b in dp._buckets]
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        for f in bufs:
            tdist.all_reduce(f)
        reps = 10
        start.record()
        for _ in range(reps):
            for f in bufs:
                tdist.all_reduce(f)
        end.record()
        torch.cuda.synchronize(dev)
        allreduce_ms = start.elapsed_time(end) / reps
        bucket_bytes = [f.numel() * f.element_size() for f in bufs]
    finally:
        dist.destroy_process_group()
    bitwise = (plain_losses == dp_losses
               and all(torch.equal(plain_w[n], dp_w[n]) for n in plain_w))
    want = _expected_train_launches(12, steps - 1)
    say("distributed_world1", model="gpt_124m", dtype="bfloat16 (O2)",
        backend=backend, batch=batch, seq=seq, steps=steps,
        losses_plain=plain_losses, losses_dp=dp_losses,
        bitwise_equal=bitwise, ms_per_step_plain=plain_ms,
        ms_per_step_dp=dp_ms, profiled_step_plain=plain_prof,
        profiled_step_dp=dp_prof, buckets=len(bufs),
        bucket_bytes=bucket_bytes,
        allreduce_device_ms_per_step=allreduce_ms,
        kernel_launches=launches, expected_launches=want, nvidia_smi=smi)
    if backend != "nccl":
        raise RuntimeError(f"a one-card group formed over {backend}")
    if not bitwise:
        raise RuntimeError("DataParallel at world size 1 is not bitwise "
                           "equal to the unwrapped steps")
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")
    return launches


def distributed_rank(out_dir):
    """One rank of the world-size-2 check, started by the launcher
    (``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2
    chip_smoke.py distributed_rank DIR``), both ranks on card 0 over
    gloo: every collective on CUDA tensors against numpy; GPT-124M in
    f32, one sequence of 2 x 1024 a rank, ``DIST_STEPS`` AdamW steps
    under ``DataParallel`` and then under ``p_g_os``, each against one
    process's steps over both sequences (rank 0 runs those first); the
    ZeRO-3 checkpoint written by both ranks, loaded back whole by rank 0
    and compared with the gathered weights.  Writes its results to
    ``DIR/rank<r>.json``."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                         save_state_dict)
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.ops.cuda import registry

    dev = torch.device("cuda", 0)
    env = dist.init_parallel_env(device="cuda:0", timeout=600)
    rank, world = env.rank, env.world_size
    out = {"rank": rank, "world": world,
           "backend": torch.distributed.get_backend()}

    # the collectives on CUDA tensors, each against numpy
    x = np.arange(8, dtype=np.float32)[rank * 4:(rank + 1) * 4]
    other = np.arange(8, dtype=np.float32)[(1 - rank) * 4:(2 - rank) * 4]
    T = lambda a: paddle.to_tensor(a, place=dev)  # noqa: E731
    checks = {}
    for op, fn in (("sum", np.add), ("max", np.maximum),
                   ("min", np.minimum), ("prod", np.multiply),
                   ("avg", lambda a, b: (a + b) / 2)):
        got = dist.all_reduce(T(x + 1), op=op).numpy()
        checks[f"all_reduce_{op}"] = bool(np.allclose(
            got, fn(x + 1, other + 1)))
    raw = torch.as_tensor(x, device=dev)
    dist.all_reduce(raw)
    checks["all_reduce_raw"] = bool(np.array_equal(raw.cpu().numpy(),
                                                   x + other))
    checks["psum_28"] = float(dist.all_reduce(T(np.float32(x.sum())))
                              .numpy()) == 28.0
    checks["all_gather"] = bool(np.array_equal(
        dist.all_gather([], T(x)).numpy(), np.arange(8.0)))
    checks["reduce_scatter"] = bool(np.array_equal(
        dist.reduce_scatter(None, T(np.ones(8, np.float32))).numpy(),
        2.0 * np.ones(4)))
    checks["broadcast"] = bool(np.array_equal(
        dist.broadcast(T(x), src=1).numpy(), np.arange(4.0, 8.0)))
    red = dist.reduce(T(x), dst=0).numpy()
    checks["reduce"] = bool(np.array_equal(red, x + other if rank == 0
                                           else x))
    parts = [T(np.full(2, 10.0 * i, np.float32)) for i in range(world)]
    checks["scatter"] = bool(np.array_equal(
        dist.scatter(T(np.zeros(2, np.float32)),
                     parts if rank == 0 else None, src=0).numpy(),
        np.full(2, 10.0 * rank)))
    a2a = dist.alltoall(T(x))
    checks["alltoall"] = bool(np.array_equal(
        a2a.numpy(), np.concatenate([np.arange(8.0)[2 * rank:2 * rank + 2],
                                     np.arange(8.0)[4 + 2 * rank:
                                                    6 + 2 * rank]])))
    if rank == 0:
        dist.send(T(x), dst=1)
        checks["send_recv"] = True
    else:
        got = T(np.zeros(4, np.float32))
        dist.recv(got, src=0)
        checks["send_recv"] = bool(np.array_equal(got.numpy(), other))
    checks["p2p_permute"] = bool(np.array_equal(
        dist.p2p_permute(T(x), [(0, 1), (1, 0)]).numpy(), other))
    objs = []
    dist.all_gather_object(objs, rank)
    checks["all_gather_object"] = objs == [0, 1]
    dist.barrier()
    out["collectives"] = checks

    # GPT-124M in f32: one sequence a rank; rank 0 first runs one process
    # over both sequences from the same weights
    rng = np.random.RandomState(77)
    ids = torch.as_tensor(rng.randint(0, 50304, (2, 1024)), device=dev)
    labels = torch.as_tensor(rng.randint(0, 50304, (2, 1024)), device=dev)
    mine = slice(rank, rank + 1)
    lr = TRAIN_LR

    def build():
        return gpt_124m(device=dev, seed=0, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)

    ref_losses, ref_w = None, None
    if rank == 0:
        model = build()
        step, _ = _gpt_dp_step(model, model, lr)
        ref_losses = [step(ids, labels).item() for _ in range(DIST_STEPS)]
        ref_w = {n: p.detach().clone() for n, p in model.named_parameters()}
        del model, step
        torch.cuda.empty_cache()

    def against(losses, weights):
        """(mean loss rel err a step, rel L2 of all the weights, the
        largest per-parameter rel L2) of the ranks' run against rank 0's
        one-process run.  A parameter whose gradient is rounding noise
        (the key bias: softmax ignores it) keeps a tiny norm that Adam's
        normalised steps fill with that noise, so the bound is on the
        whole model's weights."""
        allc = []
        dist.all_gather_object(allc, losses)
        if rank:
            return None, None, None
        mean = np.mean(allc, axis=0)
        loss_rel = max(abs(m - r) / abs(r) for m, r in zip(mean, ref_losses))
        num = sum(float((weights[n].double() - ref_w[n].double()).square()
                        .sum()) for n in ref_w)
        den = sum(float(ref_w[n].double().square().sum()) for n in ref_w)
        return (loss_rel, (num / den) ** 0.5,
                max(_rel_l2(weights[n], ref_w[n]) for n in ref_w))

    def run(level):
        model = build()
        target = dist.DataParallel(model) if level == "dp" else model
        step, opt = _gpt_dp_step(model, target, lr)
        if level != "dp":
            target, opt, _ = group_sharded_parallel(target, opt, level=level)
            step = TrainStep(target, lambda lg, lb: model.loss(lg, lb), opt)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        losses = [step(ids[mine], labels[mine]).item()]
        registry.reset_counts()
        if level == "dp":
            target.stats["allreduce_s"] = 0.0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses += [step(ids[mine], labels[mine]).item()
                   for _ in range(DIST_STEPS - 1)]
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {k: registry.counts()[k] for k in _TRAIN_KERNELS}
        rec = {"losses": losses, "ms_per_step": wall / (DIST_STEPS - 1)
               * 1e3, "launches": launches,
               "peak_bytes": torch.cuda.max_memory_allocated(dev),
               "state_bytes_at_rest": torch.cuda.memory_allocated(dev)
               - base + sum(p.numel() * p.element_size()
                            for p in model.parameters()
                            if p.untyped_storage().nbytes())}
        if level == "dp":
            rec["allreduce_host_share"] = (target.stats["allreduce_s"]
                                           / wall)
        if level == "p_g_os":
            sd = target.state_dict()
            weights = {n: v for n, v in sd.items()}
            ckpt = os.path.join(out_dir, "zero3")
            save_state_dict(sd, ckpt)
            dist.barrier()
            if rank == 0:
                back = load_state_dict(ckpt)
                rec["checkpoint_bitwise"] = all(
                    torch.equal(back[n].to(dev), weights[n]) for n in weights)
        else:
            weights = {n: p.detach() for n, p in model.named_parameters()}
        (rec["loss_rel"], rec["weight_rel_l2"],
         rec["worst_param_rel_l2"]) = against(losses, weights)
        del model, target, step, opt
        torch.cuda.empty_cache()
        return rec

    out["dp"] = run("dp")
    out["p_g_os"] = run("p_g_os")
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _dist_launcher_phase(smi):
    """The world-size-2 check (``distributed_rank``) through the
    launcher; returns the ranks' kernel launches, summed."""
    import shutil

    out_dir = os.path.join(ROOT, "build", "chip_smoke_distributed")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir",
         os.path.join(out_dir, "logs"), os.path.join(ROOT, "chip_smoke.py"),
         "distributed_rank", out_dir],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode:
        for r in range(2):
            log = os.path.join(out_dir, "logs", f"workerlog.{r}")
            if os.path.exists(log):
                print(f"--- rank {r} log ---\n" + open(log).read()[-4000:],
                      flush=True)
        raise RuntimeError(f"the launcher's ranks failed "
                           f"({proc.returncode}): {proc.stderr[-2000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    say("distributed_world2", model="gpt_124m", dtype="float32",
        backend=r0["backend"], devices="both ranks on cuda:0",
        batch="2 x 1024, one sequence a rank", steps=DIST_STEPS,
        launcher_wall_s=wall,
        collectives={k: all(r["collectives"][k] for r in ranks)
                     for k in r0["collectives"]},
        **{f"{level}_{k}": [r[level].get(k) for r in ranks]
           for level in ("dp", "p_g_os")
           for k in ("ms_per_step", "peak_bytes", "state_bytes_at_rest",
                     "allreduce_host_share", "launches")},
        **{f"{level}_{k}": r0[level][k] for level in ("dp", "p_g_os")
           for k in ("loss_rel", "weight_rel_l2", "worst_param_rel_l2")},
        zero3_checkpoint_bitwise=r0["p_g_os"]["checkpoint_bitwise"],
        rel_tol=DIST_REL_TOL, nvidia_smi=smi)
    bad = [k for r in ranks for k, ok in r["collectives"].items() if not ok]
    if bad or any(r["backend"] != "gloo" or r["world"] != 2 for r in ranks):
        raise RuntimeError(f"collectives on CUDA tensors failed: {bad}")
    for level in ("dp", "p_g_os"):
        if not (r0[level]["loss_rel"] <= DIST_REL_TOL
                and r0[level]["weight_rel_l2"] <= DIST_REL_TOL):
            raise RuntimeError(f"world size 2 {level} drifted from one "
                               f"process: {r0[level]}")
    if not r0["p_g_os"]["checkpoint_bitwise"]:
        raise RuntimeError("the ZeRO-3 checkpoint did not load back "
                           "bitwise")
    want = _expected_train_launches(12, DIST_STEPS - 1)
    launches = {k: 0 for k in _TRAIN_KERNELS}
    for r in ranks:
        for level in ("dp", "p_g_os"):
            if r[level]["launches"] != want:
                raise RuntimeError(f"rank {r['rank']} {level} launches "
                                   f"{r[level]['launches']} != {want}")
            for k in launches:
                launches[k] += r[level]["launches"][k]
    return launches


def distributed_phases(dev, smi):
    """The distributed slice: DataParallel at world size 1 over NCCL
    (bitwise against unwrapped), then two gloo ranks on the card through
    the launcher (collectives, DataParallel and p_g_os against one
    process, the ZeRO-3 checkpoint).  Returns B2/B3/B4a/B4b launches of
    both, summed."""
    import torch

    launches = _dist_world1_phase(dev, smi)
    torch.cuda.empty_cache()
    for k, n in _dist_launcher_phase(smi).items():
        launches[k] += n
    return launches


# ----------------------------------------------------- the hybrid slice --
HYBRID_REL_TOL = 1e-5    # mp = 2 / sep = 2 (f32) against one process
HYBRID_STEPS = 3
HYBRID_NO_SP_STEPS = 2
HYBRID_CP_FORWARDS = 3
# a ring backward's launches: the ring is a torch composition (no B2/B3),
# each LayerNorm one forward and one backward
HYBRID_RING_LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
                        "layernorm_fwd": 25, "layernorm_bwd": 25}


def _rel_l2_all(got, want):
    """||got - want|| / ||want|| over every tensor of two dicts, in f64."""
    num = sum(float((got[n].double() - want[n].double()).square().sum())
              for n in want)
    den = sum(float(want[n].double().square().sum()) for n in want)
    return (num / den) ** 0.5


def _hybrid_world1_phase(dev, smi, steps=5):
    """GPT-124M O2 bf16 at 8 x 1024, AdamW 1e-4 + ClipGradByGlobalNorm(1.0):
    ``steps`` steps of the plain port step, then the same steps from the
    same seed through ``fleet.init`` (every degree 1, a one-rank NCCL
    world), ``distributed_model`` and ``distributed_optimizer``: losses
    and weights must be bitwise equal.  Prints ms a step of both and the
    fleet run's kernel launches (the main path: counts reset just before
    the steps after the first, read just after), which it returns."""
    import torch
    from torch import distributed as tdist

    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.ops.cuda import registry

    rng = np.random.RandomState(2025)
    batch, seq = 8, 1024
    ids = torch.as_tensor(rng.randint(0, 50304, (batch, seq)), device=dev)
    labels = torch.as_tensor(rng.randint(0, 50304, (batch, seq)),
                             device=dev)

    def run(through_fleet):
        model = amp.decorate(
            gpt_124m(device=dev, seed=0, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0),
            level="O2", dtype="bfloat16")
        opt = optimizer.AdamW(learning_rate=TRAIN_LR,
                              parameters=model.parameters(),
                              grad_clip=optimizer.ClipGradByGlobalNorm(1.0))
        target = model
        if through_fleet:
            target = fleet.distributed_model(model)
            opt = fleet.distributed_optimizer(opt)
        step = TrainStep(target, lambda lg, lb: model.loss(lg, lb), opt)
        losses = [step(ids, labels).item()]
        registry.reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        timed = [step(ids, labels) for _ in range(steps - 1)]
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {k: registry.counts()[k] for k in _TRAIN_KERNELS}
        losses += [x.item() for x in timed]
        weights = {n: p.detach().clone() for n, p in
                   model.named_parameters()}
        return losses, weights, wall / (steps - 1) * 1e3, launches, opt

    plain_losses, plain_w, plain_ms, _, _ = run(False)
    torch.cuda.empty_cache()
    hcg = fleet.init(is_collective=True, device=dev)
    try:
        backend = tdist.get_backend()
        degrees = (hcg.get_data_parallel_world_size(),
                   hcg.get_model_parallel_world_size(),
                   hcg.get_pipe_parallel_world_size(),
                   hcg.get_sharding_parallel_world_size())
        fleet_losses, fleet_w, fleet_ms, launches, opt = run(True)
        wrapped = type(opt).__name__
    finally:
        dist.destroy_process_group()
    bitwise = (plain_losses == fleet_losses
               and all(torch.equal(plain_w[n], fleet_w[n]) for n in plain_w))
    want = _expected_train_launches(12, steps - 1)
    say("hybrid_world1", model="gpt_124m", dtype="bfloat16 (O2)",
        backend=backend, degrees_dp_mp_pp_sharding=degrees,
        optimizer=wrapped, batch=batch, seq=seq, steps=steps,
        losses_plain=plain_losses, losses_fleet=fleet_losses,
        bitwise_equal=bitwise, ms_per_step_plain=plain_ms,
        ms_per_step_fleet=fleet_ms, kernel_launches=launches,
        expected_launches=want, nvidia_smi=smi)
    if backend != "nccl" or degrees != (1, 1, 1, 1):
        raise RuntimeError(f"fleet.init at world size 1 formed {backend} "
                           f"with degrees {degrees}")
    if not bitwise:
        raise RuntimeError("fleet at world size 1 is not bitwise equal to "
                           "the plain steps")
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")
    return launches


def _timed_collectives(mp_layers, seconds):
    """Wrap ``mp_layers``' collectives so that their host seconds add up
    in ``seconds[0]``; returns the originals, to put back."""
    names = ("all_reduce", "all_gather", "reduce_scatter")
    originals = {n: getattr(mp_layers, n) for n in names}

    def timed(fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                seconds[0] += time.perf_counter() - t0
        return call

    for n in names:
        setattr(mp_layers, n, timed(originals[n]))
    return originals


def hybrid_rank(out_dir):
    """One rank of the hybrid slice's two-rank checks, started by the
    launcher (``python -m paddle_tpu_torch.distributed.launch
    --nproc_per_node 2 chip_smoke.py hybrid_rank DIR``), both ranks on
    card 0 over gloo.  (b) GPT-124M in f32 (dropout 0, 2 x 1024 tokens)
    under ``fleet.init(mp_degree=2)`` with ``sequence_parallel=True``:
    ``HYBRID_STEPS`` AdamW steps with ``ClipGradByGlobalNorm(1.0)``
    against one process's dense steps on the same batch (rank 0 runs
    those first), then two steps without sequence parallelism (each run's
    launches counted over its steps after the first); (c) the eval
    forward with ``cp_mode="ring"`` and ``"ulysses"`` under
    ``use_mesh(build_mesh(sep=2))`` against the dense forward (each
    timed over ``HYBRID_CP_FORWARDS`` forwards after one to warm up,
    the dense one too), and one ring backward against the dense
    gradients, its launches counted.  Writes its results to
    ``DIR/rank<r>.json``."""
    import hashlib

    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers
    from paddle_tpu_torch.distributed.fleet.spmd import use_mesh
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.ops.cuda import registry

    dev = torch.device("cuda", 0)
    env = dist.init_parallel_env(device="cuda:0", timeout=600)
    rank = env.rank
    out = {"rank": rank, "world": env.world_size,
           "backend": torch.distributed.get_backend()}
    rng = np.random.RandomState(78)
    ids = torch.as_tensor(rng.randint(0, 50304, (2, 1024)), device=dev)
    labels = torch.as_tensor(rng.randint(0, 50304, (2, 1024)), device=dev)

    def build(**kw):
        return gpt_124m(device=dev, seed=0, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0, **kw)

    def adamw(params):
        return optimizer.AdamW(learning_rate=TRAIN_LR, parameters=params,
                               grad_clip=optimizer.ClipGradByGlobalNorm(1.0))

    def memory(fn):
        """(result, peak bytes, bytes at rest after) of ``fn``."""
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        res = fn()
        torch.cuda.synchronize(dev)
        return (res, torch.cuda.max_memory_allocated(dev),
                torch.cuda.memory_allocated(dev) - base)

    ref = None
    if rank == 0:
        def dense():
            model = build()
            step = TrainStep(model, lambda lg, lb: model.loss(lg, lb),
                             adamw(model.parameters()))
            losses, after = [], {}
            t0 = time.perf_counter()
            for i in range(HYBRID_STEPS):
                losses.append(step(ids, labels).item())
                if i == 0:
                    t0 = time.perf_counter()
                if i + 1 in (HYBRID_NO_SP_STEPS, HYBRID_STEPS):
                    after[i + 1] = {n: p.detach().clone()
                                    for n, p in model.named_parameters()}
            ms = (time.perf_counter() - t0) / (HYBRID_STEPS - 1) * 1e3
            return model, step, losses, after, ms

        (model, step, losses, after, ms), peak, rest = memory(dense)
        ref = {"losses": losses, "after": after}
        out["one_process"] = {"ms_per_step": ms, "peak_bytes": peak,
                              "state_bytes_at_rest": rest}
        del model, step
        torch.cuda.empty_cache()

    def train(sp, steps):
        """``steps`` steps through fleet at mp = 2: losses, the gathered
        weights, the replicated parameters' digest, ms a step after the
        first, the collectives' host share and the launches of those
        steps."""
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                                   "pp_degree": 1, "sharding_degree": 1}
        fleet.init(is_collective=True, device=dev, strategy=strategy)
        model = build(sequence_parallel=sp)
        tp = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(adamw(tp.parameters()))
        step = TrainStep(tp, lambda lg, lb: model.loss(lg, lb), opt)
        losses = [step(ids, labels).item()]
        seconds = [0.0]
        originals = _timed_collectives(mp_layers, seconds)
        registry.reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        try:
            losses += [step(ids, labels).item() for _ in range(steps - 1)]
            torch.cuda.synchronize(dev)
        finally:
            for n, fn in originals.items():
                setattr(mp_layers, n, fn)
        wall = time.perf_counter() - t0
        launches = {k: registry.counts()[k] for k in _TRAIN_KERNELS}
        whole = {k: v._data for k, v in tp.state_dict().items()}
        digest = hashlib.sha256()
        replicated = []
        for n, p in model.named_parameters():
            if "mp" not in (getattr(p, "mesh_axes", None) or ()):
                replicated.append(n)
                digest.update(p.detach().cpu().numpy().tobytes())
        rec = {"losses": losses, "launches": launches,
               "replicated": len(replicated),
               "replicated_sha256": digest.hexdigest(),
               "sp_marked": sum(getattr(p, "sequence_parallel", False)
                                for p in model.parameters())}
        if steps > 1:
            rec["ms_per_step"] = wall / (steps - 1) * 1e3
            rec["collectives_host_share"] = seconds[0] / wall
        return rec, whole, model, tp, step

    def against(rec, whole, nsteps):
        if rank == 0:
            want = ref["after"][nsteps]
            rec["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(
                rec["losses"], ref["losses"][:nsteps]))
            rec["weight_rel_l2"] = _rel_l2_all(whole, want)
        got = []
        dist.all_gather_object(got, rec["replicated_sha256"])
        rec["replicated_bitwise_across_ranks"] = len(set(got)) == 1

    (rec, whole, model, tp, step), peak, rest = memory(
        lambda: train(True, HYBRID_STEPS))
    rec["peak_bytes"], rec["state_bytes_at_rest"] = peak, rest
    against(rec, whole, HYBRID_STEPS)
    out["sp"] = rec
    del whole, model, tp, step
    torch.cuda.empty_cache()
    rec, whole, model, tp, step = train(False, HYBRID_NO_SP_STEPS)
    against(rec, whole, HYBRID_NO_SP_STEPS)
    out["no_sp"] = rec
    del whole, model, tp, step, ref
    torch.cuda.empty_cache()

    # (c) context parallelism over sep = 2, against the dense model
    mesh = fleet.build_mesh(sep=2)

    def forwards(model):
        """The logits and the ms of a forward over ``HYBRID_CP_FORWARDS``
        after one to warm up."""
        with torch.no_grad(), use_mesh(mesh):
            got = model(ids)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(HYBRID_CP_FORWARDS):
                model(ids)
            torch.cuda.synchronize(dev)
        return got, (time.perf_counter() - t0) / HYBRID_CP_FORWARDS * 1e3

    dense = build()
    dense.eval()
    want, dense_ms = forwards(dense)
    cp = {"dense_forward_ms": dense_ms, "forwards": HYBRID_CP_FORWARDS}
    for mode in ("ring", "ulysses"):
        model = build(cp_mode=mode)
        model.eval()
        got, ms = forwards(model)
        cp[mode] = {"forward_ms": ms,
                    "logits_rel_l2": _rel_l2_all({"x": got}, {"x": want})}
        del model, got
    del want
    dense.train()
    dense.loss(dense(ids), labels).backward()
    want = {n: p.grad for n, p in dense.named_parameters()}
    model = build(cp_mode="ring")
    registry.reset_counts()
    with use_mesh(mesh):
        loss = model.loss(model(ids), labels)
        loss.backward()
    cp["ring_backward"] = {
        "grad_rel_l2": _rel_l2_all({n: p.grad for n, p in
                                    model.named_parameters()}, want),
        "launches": {k: registry.counts()[k] for k in _TRAIN_KERNELS}}
    out["cp"] = cp
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _hybrid_launcher_phase(smi):
    """The two-rank checks (``hybrid_rank``) through the launcher;
    returns the ranks' kernel launches of the mp = 2 steps with and
    without sequence parallelism, summed."""
    import shutil

    out_dir = os.path.join(ROOT, "build", "chip_smoke_hybrid")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir",
         os.path.join(out_dir, "logs"), os.path.join(ROOT, "chip_smoke.py"),
         "hybrid_rank", out_dir],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode:
        for r in range(2):
            log = os.path.join(out_dir, "logs", f"workerlog.{r}")
            if os.path.exists(log):
                print(f"--- rank {r} log ---\n" + open(log).read()[-4000:],
                      flush=True)
        raise RuntimeError(f"the launcher's ranks failed "
                           f"({proc.returncode}): {proc.stderr[-2000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    say("hybrid_world2", model="gpt_124m (vocab 50304, hidden 768, 12 "
        "layers, 12 heads)", dtype="float32", backend=r0["backend"],
        devices="both ranks on cuda:0", parallel="mp_degree=2",
        batch="2 x 1024 on both ranks", steps=HYBRID_STEPS,
        no_sp_steps=HYBRID_NO_SP_STEPS,
        launcher_wall_s=wall, one_process=r0["one_process"],
        **{f"{level}_{k}": [r[level].get(k) for r in ranks]
           for level in ("sp", "no_sp")
           for k in ("losses", "ms_per_step", "collectives_host_share",
                     "peak_bytes", "state_bytes_at_rest", "launches",
                     "replicated", "sp_marked")},
        **{f"{level}_{k}": r0[level][k] for level in ("sp", "no_sp")
           for k in ("loss_rel", "weight_rel_l2",
                     "replicated_bitwise_across_ranks")},
        rel_tol=HYBRID_REL_TOL, nvidia_smi=smi)
    say("hybrid_sep2", model="gpt_124m", dtype="float32",
        batch="2 x 1024", cp=[r["cp"] for r in ranks],
        rel_tol=HYBRID_REL_TOL, nvidia_smi=smi)
    if any(r["backend"] != "gloo" or r["world"] != 2 for r in ranks):
        raise RuntimeError(f"the two ranks formed {r0['backend']}")
    for level in ("sp", "no_sp"):
        rec = r0[level]
        if not (rec["loss_rel"] <= HYBRID_REL_TOL
                and rec["weight_rel_l2"] <= HYBRID_REL_TOL
                and rec["replicated_bitwise_across_ranks"]):
            raise RuntimeError(f"mp = 2 {level} drifted from one process: "
                               f"{rec}")
    for r in ranks:
        cp = r["cp"]
        worst = max(cp["ring"]["logits_rel_l2"],
                    cp["ulysses"]["logits_rel_l2"],
                    cp["ring_backward"]["grad_rel_l2"])
        if not worst <= HYBRID_REL_TOL:
            raise RuntimeError(f"rank {r['rank']} sep = 2 drifted from the "
                               f"dense model: {cp}")
    launches = {k: 0 for k in _TRAIN_KERNELS}
    for level, steps in (("sp", HYBRID_STEPS), ("no_sp", HYBRID_NO_SP_STEPS)):
        want = _expected_train_launches(12, steps - 1)
        for r in ranks:
            if r[level]["launches"] != want:
                raise RuntimeError(f"rank {r['rank']} {level} launches "
                                   f"{r[level]['launches']} != {want}")
            for k in launches:
                launches[k] += r[level]["launches"][k]
    for r in ranks:
        if r["cp"]["ring_backward"]["launches"] != HYBRID_RING_LAUNCHES:
            raise RuntimeError(f"rank {r['rank']} ring backward launches "
                               f"{r['cp']['ring_backward']['launches']} != "
                               f"{HYBRID_RING_LAUNCHES}")
    return launches


def hybrid_kernels_phase(dev):
    """B2/B3 at a tensor-parallel rank's attention (2 x 1024 x 6 x 64 f32
    causal, strided q/k/v as the sliced qkv gives them) and B4a/B4b at
    its LayerNorm rows (1024 x 768 under sequence parallelism, 2048 x 768
    without), each against its plain version through the parity rule of
    the kernel phases, then timed after ``cold_l2`` against the bound,
    the plain versions and SDPA / ``F.layer_norm``."""
    import torch

    from paddle_tpu_torch.ops.cuda import registry

    fwd = registry.KERNELS["flash_attention_fwd"]
    bwd = registry.KERNELS["flash_attention_bwd"]
    q, k, v, dout = _flash_inputs(dev, torch.float32, 2, 1024, 6, 64,
                                  seed=120, packed=True)
    scale = 0.125
    out, lse = fwd.kernel(q, k, v, True, scale)
    grads = bwd.kernel(q, k, v, out, lse, dout, True, scale)
    torch.cuda.synchronize()
    want_out, want_lse = fwd.plain(q, k, v, True, scale)
    want_grads = bwd.plain(q, k, v, out, lse, dout, True, scale)
    pairs = {"out": (out, want_out, 1e-4), "lse": (lse, want_lse, 1e-4)}
    pairs.update({f"d{n}": (g, w, 5e-4)
                  for n, g, w in zip("qkv", grads, want_grads)})
    report = {name: _parity(*p) for name, p in pairs.items()}
    _say_parity("flash_attention", "mp2_rank_2x1024x6x64_causal",
                torch.float32, report, causal=True, strided_qkv=True)
    if not all(r[3] for r in report.values()):
        raise RuntimeError(f"flash attention at the mp rank's shape: "
                           f"{report}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    _flash_kernel_times(fwd, bwd, dev, torch.float32, (2, 1024, 6, 64),
                        True, flush, note=" (GPT-124M mp = 2, a rank)")
    lfwd = registry.KERNELS["layernorm_fwd"]
    lbwd = registry.KERNELS["layernorm_bwd"]
    for rows, note in ((1024, "sequence-parallel rank"),
                       (2048, "mp = 2 rank without SP")):
        x, g, b, dy = _ln_inputs(dev, torch.float32, rows, 768,
                                 seed=121 + rows)
        y, mu, rstd = lfwd.kernel(x, g, b, 1e-5)
        dx, dg, db = lbwd.kernel(x, g, mu, rstd, dy)
        torch.cuda.synchronize()
        wy, wmu, wrstd = lfwd.plain(x, g, b, 1e-5)
        wdx, wdg, wdb = lbwd.plain(x, g, wmu, wrstd, dy, 1e-5)
        report = {name: _parity(got, w, tol) for name, got, w, tol in (
            ("y", y, wy, 1e-5), ("mu", mu, wmu, 1e-5),
            ("rstd", rstd, wrstd, 1e-5), ("dx", dx, wdx, 1e-4),
            ("dgamma", dg, wdg, 1e-4), ("dbeta", db, wdb, 1e-4))}
        _say_parity("layernorm", f"{note.split()[0]}_{rows}x768",
                    torch.float32, report)
        if not all(r[3] for r in report.values()):
            raise RuntimeError(f"layernorm at {rows} x 768: {report}")
        _ln_kernel_times(lfwd, lbwd, x, g, b, dy, 1e-5, flush,
                         f"{rows}x768 f32 (GPT-124M {note})")


def hybrid_phases(dev, smi):
    """The hybrid slice: (a) fleet at world size 1 over NCCL, bitwise
    against the plain step; (d) the kernels at a rank's shapes; (b) and
    (c) two gloo ranks on the card through the launcher.  Returns
    B2/B3/B4a/B4b launches of (a) and of both ranks' (b), summed."""
    import torch

    launches = _hybrid_world1_phase(dev, smi)
    torch.cuda.empty_cache()
    hybrid_kernels_phase(dev)
    torch.cuda.empty_cache()
    for k, n in _hybrid_launcher_phase(smi).items():
        launches[k] += n
    return launches


# ------------------------------------------------ the parallel slice --
PARALLEL_SEED = 23
PARALLEL_REL_TOL = 1e-5  # pp = 2, ep = 2 (f32) against one process
# (a) and (b): GPT-124M f32 over pp = 2, 4 x 1024, 4 microbatches
PARALLEL = {"preset": "gpt_124m", "batch": 4, "seq": 1024, "micro": 4,
            "steps": 3, "vpp_steps": 2,
            "moe": (768, 3072, 8, 4, 1024)}   # d, hidden, experts, b, t
PS = {"slots": 26, "dim": 10, "hidden": (400, 400, 400), "batch": 2048,
      "keys": 10 ** 6, "zipf": 1.1, "steps": 20, "capacity": 2 ** 18,
      "table_lr": 0.01, "lr": 0.001, "eps": 1e-3}


def _expected_pp_launches(layers, micro, steps):
    """A pipeline stage's step: one flash forward and backward per layer
    per microbatch, two LayerNorms per block per microbatch, and the
    head's ``ln_f`` once on the replicated output, each forward and
    backward."""
    per = layers * micro
    return {"flash_attention_fwd": per * steps,
            "flash_attention_bwd": per * steps,
            "layernorm_fwd": (2 * per + 1) * steps,
            "layernorm_bwd": (2 * per + 1) * steps}


def _memory(dev, fn):
    """(``fn()``, peak bytes, bytes at rest after) on the card ``dev``."""
    import torch

    if dev.type != "cuda":
        raise RuntimeError(f"device memory is read on the card, not {dev}")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    res = fn()
    torch.cuda.synchronize(dev)
    return (res, torch.cuda.max_memory_allocated(dev),
            torch.cuda.memory_allocated(dev) - base)


def _timed_calls(targets, seconds):
    """Wrap each (owner, attribute) of ``targets`` so that its host
    seconds add up in ``seconds[0]``; returns a function that puts the
    originals back."""
    originals = [(o, n, getattr(o, n)) for o, n in targets]

    def timed(fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                seconds[0] += time.perf_counter() - t0
        return call

    for o, n, fn in originals:
        setattr(o, n, timed(fn))

    def restore():
        for o, n, fn in originals:
            setattr(o, n, fn)
    return restore


def _leaf_rel(got, want):
    """max over leaves of ||got - want|| / ||want|| and the whole tree's,
    over {group: {name: tensor}} trees, in f64."""
    worst, num, den = 0.0, 0.0, 0.0
    for g in want:
        for k, w in want[g].items():
            w = w.double()
            d = float((got[g][k].double().to(w.device) - w).square().sum())
            n = float(w.square().sum())
            worst = max(worst, (d / max(n, 1e-30)) ** 0.5)
            num, den = num + d, den + n
    return worst, (num / den) ** 0.5


def parallel_rank(out_dir):
    """One rank of the parallel slice's two-rank checks, started by the
    launcher (``python -m paddle_tpu_torch.distributed.launch
    --nproc_per_node 2 chip_smoke.py parallel_rank DIR``), both ranks on
    the card over gloo, weights from ``PARALLEL_SEED``.  (a) GPT-124M f32
    (dropout 0, 4 x 1024, 4 microbatches) through ``SpmdTrainStep`` over
    pp = 2: ``PARALLEL["steps"]`` AdamW steps (epsilon 1e-3) with
    ``ClipGradByGlobalNorm(1.0)`` against one process's plain
    ``TrainStep`` on the same weights and batch (rank 0 runs it first):
    the losses and the gathered ``state_dict`` leaf by leaf; (b) the same
    with ``virtual_pp=2`` for ``PARALLEL["vpp_steps"]`` steps; each run's
    launches counted over its steps after the first, ms a step, the
    pp messages' host share, peak and at-rest bytes.  (c) An
    expert-parallel ``MoELayer`` (GShard top-2, 8 experts, ep = 2, each
    rank 4 x 1024 tokens): one forward and backward against one
    process's layer with the same weights on the rank's tokens (the
    experts' gradients summed over both ranks' tokens), its ms and the
    all-to-all's host share.  Writes ``DIR/rank<r>.json``."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        MoELayer, moe_layer)
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.cuda import registry
    from paddle_tpu_torch.parallel import SpmdTrainStep, pipeline

    cfg = PARALLEL
    dev = torch.device("cuda", 0)
    env = dist.init_parallel_env(device="cuda:0", timeout=600)
    rank = env.rank
    out = {"rank": rank, "world": env.world_size,
           "backend": torch.distributed.get_backend()}
    rng = np.random.RandomState(PARALLEL_SEED)
    b, t = cfg["batch"], cfg["seq"]

    def build():
        return getattr(gpt, cfg["preset"])(
            device=dev, seed=PARALLEL_SEED, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)

    probe = build().config
    vocab, layers = probe.vocab_size, probe.num_layers
    ids = torch.as_tensor(rng.randint(0, vocab, (b, t)), device=dev)
    labels = torch.as_tensor(rng.randint(0, vocab, (b, t)), device=dev)

    def adamw(params):
        # epsilon 1e-3, as the CPU parity tests: at 1e-8 an element whose
        # gradient is rounding noise (attention's key bias) moves by about
        # the learning rate either way, in either run, and no leaf-by-leaf
        # comparison holds
        return optimizer.AdamW(learning_rate=TRAIN_LR, parameters=params,
                               epsilon=1e-3,
                               grad_clip=optimizer.ClipGradByGlobalNorm(1.0))

    def params_of(model):
        return {g: {k: v.detach().clone() for k, v in sub.items()}
                for g, sub in model.functional_decompose()["params"].items()}

    ref = None
    if rank == 0:
        def one_process():
            model = build()
            step = TrainStep(model, lambda lg, lb: model.loss(lg, lb),
                             adamw(model.parameters()))
            losses, after = [], {}
            t0 = time.perf_counter()
            for i in range(cfg["steps"]):
                losses.append(step(ids, labels).item())
                if i == 0:
                    t0 = time.perf_counter()
                if i + 1 in (cfg["vpp_steps"], cfg["steps"]):
                    after[i + 1] = params_of(model)
            ms = (time.perf_counter() - t0) / (cfg["steps"] - 1) * 1e3
            return losses, after, ms

        (losses, after, ms), peak, rest = _memory(dev, one_process)
        ref = {"losses": losses, "after": after}
        out["one_process"] = {"ms_per_step": ms, "peak_bytes": peak,
                              "state_bytes_at_rest": rest}
        torch.cuda.empty_cache()
    dist.barrier()

    def train(v, steps):
        model = build()
        tr = SpmdTrainStep(model, adamw(model.parameters()),
                           fleet.build_mesh(pp=2),
                           n_microbatches=cfg["micro"], virtual_pp=v)
        losses = [tr.step(ids, labels).item()]
        seconds = [0.0]
        restore = _timed_calls(
            [(pipeline._Link, "isend"), (pipeline._Link, "recv"),
             (pipeline._Link, "drain"), (torch.distributed, "broadcast")],
            seconds)
        registry.reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        try:
            losses += [tr.step(ids, labels).item()
                       for _ in range(steps - 1)]
            torch.cuda.synchronize(dev)
        finally:
            restore()
        wall = time.perf_counter() - t0
        rec = {"losses": losses,
               "launches": {k: registry.counts()[k] for k in _TRAIN_KERNELS},
               "ms_per_step": wall / (steps - 1) * 1e3,
               "p2p_host_share": seconds[0] / wall,
               "stage_layers": tr.num_layers // 2,
               "stage_param_bytes": sum(
                   lf.t.numel() * lf.t.element_size() for lf in tr.leaves
                   if lf.group == "blocks")}
        return rec, tr.state_dict()["params"]

    for v, steps in ((1, cfg["steps"]), (2, cfg["vpp_steps"])):
        (rec, whole), peak, rest = _memory(dev, lambda: train(v, steps))
        rec["peak_bytes"], rec["state_bytes_at_rest"] = peak, rest
        rec["expected_launches"] = _expected_pp_launches(
            layers // 2, cfg["micro"], steps - 1)
        if rank == 0:
            rec["loss_rel"] = max(abs(a - c) / abs(c) for a, c in zip(
                rec["losses"], ref["losses"][:steps]))
            rec["weight_rel_l2_worst_leaf"], rec["weight_rel_l2"] = \
                _leaf_rel(whole, ref["after"][steps])
        out[f"vpp{v}"] = rec
        del whole
        torch.cuda.empty_cache()

    # (c) MoE over ep = 2: each rank its tokens, the experts split
    d, hidden, experts, mb, mt = cfg["moe"]
    wr = np.random.RandomState(PARALLEL_SEED)
    sd = {"gate_weight": wr.randn(d, experts) * 0.02,
          "w1": wr.randn(experts, d, hidden) * 0.02,
          "b1": wr.randn(experts, hidden) * 0.02,
          "w2": wr.randn(experts, hidden, d) * 0.02,
          "b2": wr.randn(experts, d) * 0.02}
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    paddle.set_device("gpu:0")
    group = dist.new_group([0, 1])
    k = experts // 2
    layer = MoELayer(d, hidden, experts, gate="gshard", group=group)
    layer.set_state_dict({n: paddle.to_tensor(
        v if n == "gate_weight" else v[rank * k:(rank + 1) * k])
        for n, v in sd.items()})
    dense = MoELayer(d, hidden, experts, gate="gshard")
    dense.set_state_dict({n: paddle.to_tensor(v) for n, v in sd.items()})
    xr = np.random.RandomState(PARALLEL_SEED + 1 + rank)
    x_np = xr.randn(mb, mt, d).astype(np.float32)
    dy = paddle.to_tensor(xr.randn(mb, mt, d).astype(np.float32))

    def fwd_bwd(m):
        x = paddle.to_tensor(x_np, stop_gradient=False)
        y = m(x)
        (y * dy).sum().backward()
        return y, x

    fwd_bwd(layer)                      # warm up
    for p in layer.parameters():
        p._data.grad = None
    seconds = [0.0]
    restore = _timed_calls([(moe_layer, "alltoall")], seconds)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    try:
        y, x = fwd_bwd(layer)
        torch.cuda.synchronize(dev)
    finally:
        restore()
    wall = time.perf_counter() - t0
    wy, wx = fwd_bwd(dense)
    grads = {n: p.grad._data for n, p in dense.named_parameters()}
    summed = {}
    for n in ("w1", "b1", "w2", "b2"):
        buf = grads[n].cpu().clone()
        torch.distributed.all_reduce(buf, group=group.process_group)
        summed[n] = buf[rank * k:(rank + 1) * k].to(dev)
    summed["gate_weight"] = grads["gate_weight"]
    rel = {"out": _rel_l2_all({"x": y._data}, {"x": wy._data}),
           "dx": _rel_l2_all({"x": x.grad._data}, {"x": wx.grad._data}),
           "grads": _rel_l2_all({n: p.grad._data for n, p in
                                 layer.named_parameters()}, summed)}
    out["moe"] = {"ms_fwd_bwd": wall * 1e3,
                  "all_to_all_host_share": seconds[0] / wall,
                  "tokens": mb * mt, "rel_l2": rel,
                  "aux_loss": float(layer.l_aux)}
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _parallel_launcher_phase(smi):
    """The two-rank checks (``parallel_rank``) through the launcher;
    returns both ranks' kernel launches of (a) and (b), summed."""
    import shutil

    out_dir = os.path.join(ROOT, "build", "chip_smoke_parallel")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir",
         os.path.join(out_dir, "logs"), os.path.join(ROOT, "chip_smoke.py"),
         "parallel_rank", out_dir],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode:
        for r in range(2):
            log = os.path.join(out_dir, "logs", f"workerlog.{r}")
            if os.path.exists(log):
                print(f"--- rank {r} log ---\n" + open(log).read()[-4000:],
                      flush=True)
        raise RuntimeError(f"the launcher's ranks failed "
                           f"({proc.returncode}): {proc.stderr[-2000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    for v in (1, 2):
        key = f"vpp{v}"
        say(f"parallel_pp2_vpp{v}", model=PARALLEL["preset"],
            dtype="float32", backend=r0["backend"],
            devices="both ranks on cuda:0", parallel=f"pp=2 virtual_pp={v}",
            batch=f"{PARALLEL['batch']} x {PARALLEL['seq']}",
            microbatches=PARALLEL["micro"], launcher_wall_s=wall,
            one_process=r0.get("one_process"),
            **{k: [r[key][k] for r in ranks] for k in (
                "losses", "ms_per_step", "p2p_host_share", "peak_bytes",
                "state_bytes_at_rest", "stage_param_bytes", "launches",
                "expected_launches")},
            **{k: r0[key][k] for k in ("loss_rel", "weight_rel_l2",
                                       "weight_rel_l2_worst_leaf")},
            rel_tol=PARALLEL_REL_TOL, nvidia_smi=smi)
    say("parallel_moe_ep2", d_model=PARALLEL["moe"][0],
        d_hidden=PARALLEL["moe"][1], experts=PARALLEL["moe"][2],
        gate="gshard (top-2, capacity factor 2)", dtype="float32",
        moe=[r["moe"] for r in ranks], rel_tol=PARALLEL_REL_TOL,
        nvidia_smi=smi)
    if any(r["backend"] != "gloo" or r["world"] != 2 for r in ranks):
        raise RuntimeError(f"the two ranks formed {r0['backend']}")
    launches = {k: 0 for k in _TRAIN_KERNELS}
    for v in (1, 2):
        rec = r0[f"vpp{v}"]
        if not (rec["loss_rel"] <= PARALLEL_REL_TOL
                and rec["weight_rel_l2_worst_leaf"] <= PARALLEL_REL_TOL):
            raise RuntimeError(f"pp = 2 virtual_pp = {v} drifted from one "
                               f"process: {rec}")
        for r in ranks:
            got = r[f"vpp{v}"]
            if got["launches"] != got["expected_launches"]:
                raise RuntimeError(f"rank {r['rank']} vpp{v} launches "
                                   f"{got['launches']} != "
                                   f"{got['expected_launches']}")
            for k in launches:
                launches[k] += got["launches"][k]
    for r in ranks:
        worst = max(r["moe"]["rel_l2"].values())
        if not worst <= PARALLEL_REL_TOL:
            raise RuntimeError(f"rank {r['rank']} ep = 2 drifted from one "
                               f"process: {r['moe']}")
    return launches


def _zipf_ids(rng, n, keys, a):
    """``n`` draws of a Zipf(``a``) law truncated to ranks 1..``keys``
    (inverse CDF), as ids 0..keys-1."""
    cdf = np.cumsum(np.arange(1, keys + 1, dtype=np.float64) ** -a)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random_sample(n)), keys - 1)


def parameter_server_phase(dev, smi):
    """(d) DeepFM (Criteo's 26 categorical fields, the DeepFM paper's
    400-400-400 network, embeddings of 10) over batches of 2048 whose
    ids are Zipf(1.1) over 10^6 keys a slot (seeded), ``PS["steps"]``
    Adagrad steps (the tables' own Adagrad and the dense one, epsilon
    1e-3 for the comparison: at the defaults a row element whose
    gradient is rounding noise moves by the learning rate either way,
    and no two summation orders agree past 1e-4), three times from the
    same weights: on the card through ``DistributedEmbedding`` over the
    host ``SparseTable``, on the card through
    ``HotRowCache(capacity=2**18)``, and the host-table run on the CPU;
    then the card's host-table run once more at the optimizers' default
    epsilons (the table's 1e-8, Adagrad's 1e-6), timed and not compared.
    Prints ms a step after the first, the share of the step spent inside
    the tables' pull and push, the cache's hit rate, and the losses of
    each compared run against the CPU run's."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.ps import HotRowCache, SparseTable
    from paddle_tpu_torch.models.deepfm import DeepFM

    rng = np.random.RandomState(PARALLEL_SEED)
    n = PS["batch"] * PS["slots"]
    offsets = np.arange(PS["slots"], dtype=np.int64) * PS["keys"]
    batches = []
    for _ in range(PS["steps"]):
        ids = _zipf_ids(rng, n, PS["keys"], PS["zipf"]).reshape(
            PS["batch"], PS["slots"]) + offsets
        y = ((ids[:, 0] + ids[:, 1]) % 3 == 0).astype(np.float32)
        batches.append((ids.astype(np.int64), y[:, None]))
    before = paddle.get_device()

    def model_on(device, cache, eps=PS["eps"]):
        paddle.set_device(device)
        paddle.seed(PARALLEL_SEED)
        kw = dict(optimizer="adagrad", learning_rate=PS["table_lr"])
        if eps is not None:
            kw["epsilon"] = eps
        fo, emb = SparseTable(1, seed=PARALLEL_SEED, **kw), \
            SparseTable(PS["dim"], seed=PARALLEL_SEED + 1, **kw)
        if cache:
            fo, emb = (HotRowCache(t, capacity=PS["capacity"],
                                   device=device, **kw) for t in (fo, emb))
        return DeepFM(sparse_feature_dim=PS["dim"], num_slots=PS["slots"],
                      hidden_sizes=PS["hidden"], table_lr=PS["table_lr"],
                      table_optimizer="adagrad", table=emb,
                      first_order_table=fo)

    gpu = f"gpu:{dev.index or 0}"
    weights = {k: v.numpy() for k, v in
               model_on(gpu, False).state_dict().items()}

    def run(device, cache, eps=PS["eps"]):
        model = model_on(device, cache, eps)
        model.set_state_dict({k: paddle.to_tensor(v)
                              for k, v in weights.items()})
        opt = optimizer.Adagrad(learning_rate=PS["lr"],
                                parameters=model.parameters(),
                                **({} if eps is None else {"epsilon": eps}))
        tables = [model.fo_table.table, model.emb_table.table]
        seconds = [0.0]
        restore = _timed_calls([(t, m) for t in tables
                                for m in ("pull", "push")], seconds)
        losses = []
        t0 = time.perf_counter()
        try:
            for i, (ids, y) in enumerate(batches):
                if i == 1:
                    seconds[0] = 0.0
                    t0 = time.perf_counter()
                loss = model.loss(model(paddle.to_tensor(ids)),
                                  paddle.to_tensor(y))
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(float(loss))
        finally:
            restore()
        wall = time.perf_counter() - t0
        rec = {"ms_per_step": wall / (len(batches) - 1) * 1e3,
               "table_call_share": seconds[0] / wall, "losses": losses}
        if cache:
            rec["cache"] = {name: t.stats() for name, t in
                            zip(("first_order", "embedding"), tables)}
        return rec

    try:
        host = run(gpu, False)
        cached = run(gpu, True)
        cpu = run("cpu", False)
        default_eps = run(gpu, False, eps=None)
    finally:
        paddle.set_device(before)
    for rec in (host, cached):
        rec["loss_rel_vs_cpu"] = max(abs(a - b) / abs(b) for a, b in
                                     zip(rec["losses"], cpu["losses"]))
    cached["loss_rel_vs_host_table"] = max(
        abs(a - b) / abs(b) for a, b in zip(cached["losses"],
                                            host["losses"]))
    say("parallel_parameter_server", model="DeepFM", slots=PS["slots"],
        embedding_dim=PS["dim"], hidden=PS["hidden"], batch=PS["batch"],
        ids=f"Zipf({PS['zipf']}) over {PS['keys']} keys a slot",
        steps=PS["steps"], capacity=PS["capacity"], card_host_table=host,
        card_hot_row_cache=cached, cpu_host_table=cpu,
        card_host_table_default_epsilon=default_eps,
        rel_tol=PARALLEL_REL_TOL, nvidia_smi=smi)
    for name, rec in (("host table", host), ("hot-row cache", cached)):
        if not rec["loss_rel_vs_cpu"] <= PARALLEL_REL_TOL:
            raise RuntimeError(f"DeepFM on the card ({name}) drifted from "
                               f"the CPU run: {rec['loss_rel_vs_cpu']}")
    if not cached["loss_rel_vs_host_table"] <= PARALLEL_REL_TOL:
        raise RuntimeError("the hot-row cache drifted from the host table")


def parallel_kernels_phase(dev):
    """B2/B3 at a pipeline stage's microbatch (1 x 1024 x 12 x 64 f32
    causal, strided q/k/v as GPT's qkv gives them) and B4a/B4b at its
    LayerNorm rows (1024 x 768 f32), each against its plain version
    through the parity rule of the kernel phases, then timed after
    ``cold_l2`` against the bound, the plain versions and SDPA /
    ``F.layer_norm``."""
    import torch

    from paddle_tpu_torch.ops.cuda import registry

    fwd = registry.KERNELS["flash_attention_fwd"]
    bwd = registry.KERNELS["flash_attention_bwd"]
    q, k, v, dout = _flash_inputs(dev, torch.float32, 1, 1024, 12, 64,
                                  seed=230, packed=True)
    scale = 0.125
    out, lse = fwd.kernel(q, k, v, True, scale)
    grads = bwd.kernel(q, k, v, out, lse, dout, True, scale)
    torch.cuda.synchronize()
    want_out, want_lse = fwd.plain(q, k, v, True, scale)
    want_grads = bwd.plain(q, k, v, out, lse, dout, True, scale)
    pairs = {"out": (out, want_out, 1e-4), "lse": (lse, want_lse, 1e-4)}
    pairs.update({f"d{n}": (g, w, 5e-4)
                  for n, g, w in zip("qkv", grads, want_grads)})
    report = {name: _parity(*p) for name, p in pairs.items()}
    _say_parity("flash_attention", "pp_stage_microbatch_1x1024x12x64_causal",
                torch.float32, report, causal=True, strided_qkv=True)
    if not all(r[3] for r in report.values()):
        raise RuntimeError(f"flash attention at the stage's shape: "
                           f"{report}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    _flash_kernel_times(fwd, bwd, dev, torch.float32, (1, 1024, 12, 64),
                        True, flush, note=" (GPT-124M pp = 2, a microbatch)")
    lfwd = registry.KERNELS["layernorm_fwd"]
    lbwd = registry.KERNELS["layernorm_bwd"]
    x, g, b, dy = _ln_inputs(dev, torch.float32, 1024, 768, seed=231)
    y, mu, rstd = lfwd.kernel(x, g, b, 1e-5)
    dx, dg, db = lbwd.kernel(x, g, mu, rstd, dy)
    torch.cuda.synchronize()
    wy, wmu, wrstd = lfwd.plain(x, g, b, 1e-5)
    wdx, wdg, wdb = lbwd.plain(x, g, wmu, wrstd, dy, 1e-5)
    report = {name: _parity(got, w, tol) for name, got, w, tol in (
        ("y", y, wy, 1e-5), ("mu", mu, wmu, 1e-5),
        ("rstd", rstd, wrstd, 1e-5), ("dx", dx, wdx, 1e-4),
        ("dgamma", dg, wdg, 1e-4), ("dbeta", db, wdb, 1e-4))}
    _say_parity("layernorm", "pp_stage_microbatch_1024x768", torch.float32,
                report)
    if not all(r[3] for r in report.values()):
        raise RuntimeError(f"layernorm at 1024 x 768: {report}")
    _ln_kernel_times(lfwd, lbwd, x, g, b, dy, 1e-5, flush,
                     "1024x768 f32 (GPT-124M pp = 2, a microbatch)")


def parallel_phases(dev, smi):
    """The parallel slice: the kernels at a stage's microbatch; (a)-(c)
    on two gloo ranks on the card through the launcher; (d) the
    parameter server.  Returns B2/B3/B4a/B4b launches of both ranks' (a)
    and (b), summed."""
    import torch

    parallel_kernels_phase(dev)
    torch.cuda.empty_cache()
    launches = _parallel_launcher_phase(smi)
    torch.cuda.empty_cache()
    parameter_server_phase(dev, smi)
    torch.cuda.empty_cache()
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
VIT_STEPS = (2, 4)           # warm-up, timed
RESNET_STEPS = (2, 3)
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


def _fit(dev, smi, label, model, steps, seed, make_opt=None):
    """``Model.fit`` over a 4-worker loader under O1 for ``warmup +
    timed`` steps, the main path (counts reset just before, read just
    after); then one profiled ``train_batch``.  The optimizer is
    ``make_opt(parameters)``, AdamW(1e-4) by default.  Returns
    (launches, fields for the line, the hapi Model, a held-out batch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.cuda import registry

    warmup, timed = steps
    n = (warmup + timed) * VIT_BATCH
    hapi = paddle.Model(model)
    opt = (make_opt(model.parameters()) if make_opt is not None
           else paddle.optimizer.AdamW(learning_rate=1e-4,
                                       parameters=model.parameters()))
    hapi.prepare(opt, paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
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
    if make_opt is not None:
        prof_fields["optimizer_device_share"] = _range_share(prof,
                                                             OPT_RANGE)
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
      3072, 1000 classes, full depth) fit for 2 + 4 steps — the main
      path: wall and device ms a step, busy share, images/s, FLOPs
      (``hapi.flops`` x 3 for forward + backward) over the bf16 dense
      peak, peak memory, the ms the main thread waits on the loader a
      step; B2, B3, B4a and B4b must launch 12, 12, 25 and 25 times a
      step on this path alone;
    - ResNet-50 fit for 2 + 3 steps under the same loader: images/s,
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
TP_NEW = 32       # new tokens a request of the TP burst


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
    want, _c, _l, rec1 = _fleet_burst(one, dev, new=TP_NEW)
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
    got, _counts, launches, rec2 = _fleet_burst(eng, dev, new=TP_NEW)
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


# bound of the tp=2 page payload against tp=1's, layer by layer: max |a - b|
# within 2^-4 of the layer's max |b| (a few bf16 ulps of the K/V values,
# grown over the layers by the all-reduces' bf16 rounding); the payload
# with its two ranks' head halves swapped must exceed it
A20B_PAYLOAD_BOUND = 2.0 ** -4


def _counted_tier_bytes(eng):
    """Sum ``last_tier_bytes`` over every step ``eng`` takes from now on
    -> a one-element list holding the running total."""
    moved = [0]
    step = eng.step

    def counted():
        out = step()
        moved[0] += eng.last_tier_bytes
        return out

    eng.step = counted
    return moved


def _tier_pages(eng):
    """Pages the tier moved, by its event records: demoted, swapped in,
    promoted and adopted from the store."""
    return sum(e[3] if e[1] in ("demote", "swap_in", "store_adopt") else e[2]
               for e in eng.events
               if e[1] in ("demote", "swap_in", "store_adopt", "promote"))


def _rank_launches(eng, before, kernel):
    """Each rank's launches of ``kernel`` (0 = B1, 1 = B5) since the
    ``_rank_stats()`` reading ``before``."""
    return [r[kernel] for r in _tp_launches(before, eng._rank_stats())]


def _per_page_ms(ms, eng, kind):
    """Host ms a page of the ``kind`` tier moves timed by _timed_hook."""
    pages = sum(e[3] for e in eng.events if e[1] == kind)
    return sum(ms) / pages if pages else None


def _payload_error(a, b, nh):
    """Worst ratio, over the layers, of max |a - b| to the bound
    A20B_PAYLOAD_BOUND x max |b| of the bf16 pages ``a`` / ``b`` (int16 bit
    patterns [L, n, bs, Nh, D]), and the same for ``a`` with its two
    ranks' head halves swapped (the control)."""
    import torch

    def f32(x):
        return torch.from_numpy(np.ascontiguousarray(x)).view(
            torch.bfloat16).float()

    a, b = f32(a), f32(b)
    swapped = torch.cat([a[..., nh // 2:, :], a[..., :nh // 2, :]], dim=-2)

    def worst(x):
        return max(float((x[l] - b[l]).abs().max())
                   / (A20B_PAYLOAD_BOUND * float(b[l].abs().max()))
                   for l in range(b.shape[0]))

    return worst(a), worst(swapped)


def _a20b_tier(model, dev, smi, prompts, sampled, layers):
    """(a): the burst through a tp=2 and a tp=1 engine starved to 72
    pages (a full-length sequence is 64), ``kv_tier`` at ``"always"``, so
    that each preempts, demotes and swaps in -> (B1 launches summed over the
    tp=2 engine's ranks, that engine)."""
    import torch

    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.ops.cuda import registry

    tier = {"host_bytes": "2GiB", "store_bytes": "1GiB", "policy": "always"}
    runs = {}
    for tp in (1, 2):
        mesh = dict(mesh=_TP_MESH) if tp > 1 else {}
        eng = LLMEngine(model, device=dev, num_blocks=72, kv_tier=tier,
                        **mesh, **_SERVE_ENGINE)
        eng.warmup()
        demote_ms, swap_ms = [], []
        _timed_hook(eng, "demote_hook", "demote", demote_ms)
        _timed_hook(eng, "swap_in_hook", "swap_in", swap_ms)
        moved = _counted_tier_bytes(eng)
        # _fleet_burst zeroes rank 0's counts: read the ranks after that
        registry.reset_counts()
        before = eng._rank_stats()
        steps0 = eng.stats["launches"]
        outs, _counts, launches, rec = _fleet_burst(eng, dev, new=TP_NEW)
        ranks = _rank_launches(eng, before, 0)
        runs[tp] = dict(
            outs=outs, ranks=ranks, launches=launches,
            record=rec, tier=eng.tier_stats(), tier_bytes=moved[0],
            pages=_tier_pages(eng), demote_ms=demote_ms, swap_in_ms=swap_ms,
            demote_ms_a_page=_per_page_ms(demote_ms, eng, "demote"),
            swap_in_ms_a_page=_per_page_ms(swap_ms, eng, "swap_in"),
            preemptions=eng.scheduler.num_preemptions)
        if any(r != layers * (eng.stats["launches"] - steps0)
               for r in ranks):
            raise RuntimeError(f"(a) tp={tp}: B1 launches {ranks} a rank "
                               f"for {launches} engine launches")
        if tp == 1:
            del eng
            torch.cuda.empty_cache()
    one, two = runs[1], runs[2]
    divergences = _burst_divergences(model, dev, sampled, two["outs"],
                                     one["outs"])
    want_bytes = two["pages"] * eng.page_bytes * eng.tp
    say("tp_a20b_tier", nvidia_smi=smi, model="gpt_124m", dtype="bfloat16",
        seed=24, num_blocks=72, page_bytes_a_rank=eng.page_bytes,
        tp1={k: v for k, v in one.items() if k != "outs"},
        tp2={k: v for k, v in two.items() if k != "outs"},
        tier_stats_equal=two["tier"] == one["tier"],
        tier_bytes_expected=want_bytes,
        greedy_divergences=divergences,
        demote_ms_a_page_ratio=(two["demote_ms_a_page"]
                                / one["demote_ms_a_page"]
                                if one["demote_ms_a_page"] else None),
        swap_in_ms_a_page_ratio=(two["swap_in_ms_a_page"]
                                 / one["swap_in_ms_a_page"]
                                 if one["swap_in_ms_a_page"] else None))
    host = two["tier"]["host_pool"]
    if (two["tier"] != one["tier"] or two["tier_bytes"] != want_bytes
            or two["tier_bytes"] != one["tier_bytes"]
            or not (host["demoted_chains"] and host["swapped_in_chains"])
            or not two["preemptions"]):
        raise RuntimeError(f"(a) the tier at tp=2 {two['tier']} moved "
                           f"{two['tier_bytes']} bytes, tp=1 {one['tier']} "
                           f"{one['tier_bytes']}, expected {want_bytes}")
    return sum(two["ranks"]), eng


def _a20b_migration(model, dev, smi, prompts, layers):
    """(b): four running requests exported from a tp=2 engine into a tp=1
    engine and back, against the unmigrated tp=2 run -> B1 launches
    summed over the tp=2 engine's ranks and the tp=1 engine's."""
    import torch

    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.ops.cuda import registry

    four = prompts[:4]
    e2 = LLMEngine(model, device=dev, mesh=_TP_MESH, **_SERVE_ENGINE)
    e1 = LLMEngine(model, device=dev, **_SERVE_ENGINE)
    e1.warmup()
    # both engines' rank 0 is this process: its counts hold both, the
    # worker's its own
    registry.reset_counts()
    base = e2._rank_stats()
    steps2, steps1 = e2.stats["launches"], e1.stats["launches"]
    # the unmigrated run, with the top-2 logits the gate reads
    ref_ids = [e2.add_request(p, max_new_tokens=TP_NEW, logprobs=2,
                              request_id=f"ref{i}")
               for i, p in enumerate(four)]
    ref = _drive(e2)
    # the same requests on both engines up to the first decode steps
    rids = [f"m{i}" for i in range(4)]
    for eng in (e2, e1):
        for rid, p in zip(rids, four):
            eng.add_request(p, max_new_tokens=TP_NEW, request_id=rid)
        while eng.scheduler.waiting or not all(
                r.prefill_done for r in eng.scheduler.running):
            eng.step()
        for _ in range(2):
            eng.step()
    torch.cuda.synchronize(dev)
    errors, controls, positions = [], [], []
    for rid in rids:
        a, b = e2.export_request(rid), e1.export_request(rid)
        ids_a, ids_b = a["request"].all_ids, b["request"].all_ids
        n = min(a["request"].num_cached, b["request"].num_cached)
        agree = next((i for i in range(n) if ids_a[i] != ids_b[i]), n)
        pos = agree // e2.block_size
        positions.append(agree)
        err, ctl = _payload_error(a["k_pages"][:, :pos], b["k_pages"][:, :pos],
                                  e2.num_heads)
        errv, ctlv = _payload_error(a["v_pages"][:, :pos],
                                    b["v_pages"][:, :pos], e2.num_heads)
        errors.append(max(err, errv))
        controls.append(min(ctl, ctlv))
    for rid in rids:
        e1.abort_request(rid)
    _drive(e1)
    # tp=2 -> tp=1, four decode steps there, then back
    ms = {"export_2": [], "import_1": [], "export_1": [], "import_2": []}

    def move(src, dst, label_src, label_dst):
        for rid in rids:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            st = src.export_request(rid)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            dst.import_request(st["request"], st["seq"], st["k_pages"],
                               st["v_pages"])
            torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            src.release_request(rid)
            ms[label_src].append((t1 - t0) * 1e3)
            ms[label_dst].append((t2 - t1) * 1e3)

    move(e2, e1, "export_2", "import_1")
    outs = {}
    for _ in range(4):
        for o in e1.step():
            outs[o.request_id] = o
    move(e1, e2, "export_1", "import_2")
    outs.update(_drive(e2))
    got = [outs[r].output_ids.tolist() for r in rids]
    want = [ref[r].output_ids.tolist() for r in ref_ids]
    divergences = _first_divergences(got, want, [ref[r] for r in ref_ids],
                                     0.5)
    worker = _rank_launches(e2, base, 0)[1]
    process = registry.counts()["paged_ragged_attention"]
    launches2 = e2.stats["launches"] - steps2
    launches1 = e1.stats["launches"] - steps1
    say("tp_a20b_migration", nvidia_smi=smi, requests=4,
        payload_bound=f"max|a-b| <= 2^-4 max|b| a layer",
        payload_err_over_limit=errors, control_err_over_limit=controls,
        compared_positions=positions, divergences=divergences,
        tokens_equal=sum(g == w for g, w in zip(got, want)),
        ms=ms, ms_median={k: float(np.median(v)) for k, v in ms.items()},
        page_bytes_global=e2.page_bytes * e2.tp,
        rank0_process_launches=process, worker_launches=worker,
        engine_launches_tp2=launches2, engine_launches_tp1=launches1)
    e2._tp.close()
    if (max(errors) > 1 or min(controls) <= 1
            or worker != layers * launches2
            or process != layers * (launches1 + launches2)):
        raise RuntimeError(f"(b) payload {errors} (control {controls}) or "
                           f"launches {process} / {worker} for "
                           f"{launches1} + {launches2}")
    return process + worker


def _a20b_int8(model, dev, smi, prompts, layers):
    """(c): eight burst prompts, 16 new tokens, through a tp=2 and a
    tp=1 int8-KV engine starved to 64 pages under the tier -> B5
    launches summed over the tp=2 engine's ranks."""
    from paddle_tpu_torch.inference.llm import LLMEngine

    tier = {"host_bytes": "1GiB", "store_bytes": "512MiB",
            "policy": "always"}
    eight = prompts[:8]
    res = {}
    for tp in (1, 2):
        mesh = dict(mesh=_TP_MESH) if tp > 1 else {}
        eng = LLMEngine(model, device=dev, num_blocks=64, kv_tier=tier,
                        quantize={"weights": False, "kv_cache": True},
                        **mesh, **_SERVE_ENGINE)
        before = eng._rank_stats()
        steps0 = eng.stats["launches"]
        rids = [eng.add_request(p, max_new_tokens=16, logprobs=2 if tp == 1
                                else 0) for p in eight]
        outs = _drive(eng)
        res[tp] = dict(outs=[outs[r] for r in rids], tier=eng.tier_stats(),
                       ranks=_rank_launches(eng, before, 1),
                       b1=_rank_launches(eng, before, 0),
                       launches=eng.stats["launches"] - steps0,
                       preemptions=eng.scheduler.num_preemptions)
        if eng._tp is not None:
            eng._tp.close()
        del eng
    got = [o.output_ids.tolist() for o in res[2]["outs"]]
    want = [o.output_ids.tolist() for o in res[1]["outs"]]
    divergences = _first_divergences(got, want, res[1]["outs"], 0.5)
    two = res[2]
    say("tp_a20b_int8", nvidia_smi=smi, requests=8, num_blocks=64,
        tokens_equal=sum(g == w for g, w in zip(got, want)),
        divergences=divergences, tier_stats_equal=two["tier"]
        == res[1]["tier"], tier=two["tier"], preemptions=two["preemptions"],
        rank_launches_b5=two["ranks"], engine_launches=two["launches"])
    if (two["tier"] != res[1]["tier"] or not two["preemptions"]
            or not two["tier"]["host_pool"]["swapped_in_chains"]
            or any(r != layers * two["launches"] for r in two["ranks"])
            or any(two["b1"])):
        raise RuntimeError(f"(c) int8 tier at tp=2: {two['tier']} vs "
                           f"{res[1]['tier']}, B5 {two['ranks']} B1 "
                           f"{two['b1']} for {two['launches']} launches")
    return sum(two["ranks"])


def _a20b_fleet(model, dev, smi, prompts, sampled, layers, want):
    """(d): ``Fleet(replicas=2, tensor_parallel=2)`` on the card, four
    rank processes: the burst against tp=1's outputs ``want``, then a
    drain of replica 1 migrating its running requests -> B1 launches
    summed over the four ranks."""
    import torch

    from paddle_tpu_torch.inference.llm import Fleet
    from paddle_tpu_torch.ops.cuda import registry

    t0 = time.perf_counter()
    fleet = Fleet(model, replicas=2, device=dev, tensor_parallel=2,
                  migration="always", **_SERVE_ENGINE)
    build_s = time.perf_counter() - t0
    engines = [r.engine for r in fleet.replicas]

    def ranks_around(run):
        """``run()`` with each rank's B1 launches read around it: both
        replicas' rank 0 is this process (``run`` zeroes its counts),
        each worker counts its own -> (run's result, the process's
        launches, each worker's, each engine's launches)."""
        workers = [e._rank_stats()[1] for e in engines]
        base = [e.stats["launches"] for e in engines]
        res = run()
        process = registry.counts()["paged_ragged_attention"]
        own = [e._rank_stats()[1]["launches"]["paged_ragged_attention"]
               - w["launches"]["paged_ragged_attention"]
               for e, w in zip(engines, workers)]
        steps = [e.stats["launches"] - n for e, n in zip(engines, base)]
        if process != layers * sum(steps) or own != [layers * n
                                                     for n in steps]:
            raise RuntimeError(f"(d) B1 launches {process} / {own} for "
                               f"engine launches {steps}")
        return res, process, own, steps

    (got, _c, _l, rec), p1, w1, n1 = ranks_around(
        lambda: _fleet_burst(fleet, dev, new=TP_NEW))
    divergences = _burst_divergences(model, dev, sampled, got, want)
    stats = [e._rank_stats() for e in engines]
    (handoffs, outs, _c, _l), p2, w2, n2 = ranks_around(
        lambda: _drain_migration(fleet, dev, prompts[:8], new=TP_NEW))
    drain_div = _burst_divergences(model, dev, sampled, outs, want[:8])
    torch.cuda.synchronize(dev)
    watched = len(fleet.warmup()._graphs)
    say("tp_a20b_fleet", nvidia_smi=smi, replicas=2, tensor_parallel=2,
        rank_processes=sum(len(e._tp.processes) + 1 for e in engines),
        build_s=build_s, burst=rec, tokens_per_s=rec["tokens_per_s"],
        greedy_divergences=divergences,
        rank_device_bytes=[[s["device_bytes"] for s in st] for st in stats],
        rank_params_bytes=[[s["params_bytes"] for s in st] for st in stats],
        rank_pool_bytes=[[s["pool_bytes"] for s in st] for st in stats],
        device_bytes_note="rank 0 of both replicas is this process: its "
                          "device_bytes is the process's, both replicas' "
                          "rank 0 and the model",
        burst_launches={"rank0_process": p1, "workers": w1,
                        "engines": n1},
        handoffs=handoffs, migrated=fleet.stats["migrated"],
        migrated_bytes=fleet.stats["migrated_bytes"],
        drain_divergences=drain_div,
        drain_launches={"rank0_process": p2, "workers": w2, "engines": n2},
        watched_graphs=watched)
    moved = sum(h["pages"] for h in handoffs) * engines[0].page_bytes * 2
    if not fleet.stats["migrated"] or watched or \
            fleet.stats["migrated_bytes"] != moved:
        raise RuntimeError(f"(d) the drain moved {fleet.stats} (expected "
                           f"{moved} bytes), or {watched} graphs watched")
    for e in engines:
        e._tp.close()
    del fleet, engines
    return p1 + sum(w1) + p2 + sum(w2)


def _a20b_analysis(eng, dev, smi):
    """(e): the analysis tools on (a)'s tp=2 engine: findings, the
    census's collective bytes against the count derived from the body,
    and the step model's decode step against a measured one."""
    from paddle_tpu_torch.framework import analysis, cost

    t0 = time.perf_counter()
    findings = analysis.analyze_engine(eng)
    census = cost.run_census(eng, profile="h100")
    model = cost.StepTimeModel.from_engine(eng, profile="h100")
    tools_s = time.perf_counter() - t0
    hidden = eng.num_heads * eng.head_dim
    derived = {e["bucket"]: 2 * eng.num_layers * e["bucket"] * hidden
               * eng.dtype.itemsize * 2 for e in census.entries}
    got = {e["bucket"]: e["cost"]["collective_bytes"].get("mp")
           for e in census.entries}
    rng = np.random.RandomState(2424)
    window = [list(rng.randint(0, 50257, 128)) for _ in range(8)]
    measured = _tp_decode_window(eng, dev, window)
    predicted = model.times_s[("ragged", 8)] * 1e3
    say("tp_a20b_analysis", nvidia_smi=smi, tools_s=tools_s,
        findings=[f.format() for f in findings + census.findings],
        collective_bytes=got, derived=derived,
        roofline={e["label"]: e["roofline"] for e in census.entries},
        predicted_decode_ms=predicted, measured_decode=measured,
        predicted_over_measured=predicted / measured["wall_ms_per_step"])
    if findings or census.findings or got != derived:
        raise RuntimeError(f"(e) findings {findings + census.findings}, "
                           f"collective bytes {got} != {derived}")


def tp_a20b_phase(dev, smi):
    """A20b on one card: GPT-124M bf16 at the serving settings (random
    weights from seed 24), ranks on the one card over gloo.  (a) the host
    KV tier at tp=2 against tp=1 on a pool starved to 72 pages; (b) four
    running requests migrated tp=2 -> tp=1 -> tp=2, the payload in the
    global layout against tp=1's; (c) the int8-KV tier at tp=2 (B5); (d)
    ``Fleet(replicas=2, tensor_parallel=2)``: the burst and a drain that
    migrates; (e) ``analyze_engine``, ``run_census`` and the step model
    on (a)'s engine.  Returns (B1, B5) launches summed over the ranks."""
    import gc

    import torch

    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.models.gpt import gpt_124m

    model = gpt_124m(device=dev, seed=24, dtype=torch.bfloat16).eval()
    layers = model.config.num_layers
    prompts, sampled = _burst_prompts()
    laps = [time.perf_counter()]
    b1, eng = _a20b_tier(model, dev, smi, prompts, sampled, layers)
    _a20b_analysis(eng, dev, smi)
    eng._tp.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    laps.append(time.perf_counter())
    b1 += _a20b_migration(model, dev, smi, prompts, layers)
    gc.collect()
    torch.cuda.empty_cache()
    laps.append(time.perf_counter())
    b5 = _a20b_int8(model, dev, smi, prompts, layers)
    gc.collect()
    torch.cuda.empty_cache()
    laps.append(time.perf_counter())
    one = LLMEngine(model, device=dev, **_SERVE_ENGINE)
    one.warmup()
    want, _c, _l, _rec = _fleet_burst(one, dev, new=TP_NEW)
    del one
    gc.collect()
    torch.cuda.empty_cache()
    b1 += _a20b_fleet(model, dev, smi, prompts, sampled, layers, want)
    gc.collect()
    torch.cuda.empty_cache()
    laps.append(time.perf_counter())
    say("tp_a20b", b1_launches=b1, b5_launches=b5,
        seconds={k: laps[i + 1] - laps[i] for i, k in enumerate(
            ("tier_and_analysis", "migration", "int8", "fleet"))})
    del model
    return b1, b5


def tp_phases(dev, smi):
    """The tensor-parallel phases, each main path's launches read around
    it on every rank -> their (B1, B5) launches summed over the ranks."""
    b1, b5 = tp_exactness_phase(dev)
    b1 += tp_serving_phase(dev, smi)
    a1, a5 = tp_a20b_phase(dev, smi)
    return b1 + a1, b5 + a5


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


# ------------------------------------------------------------ the op surface --
# The op families of ROADMAP A23b-2: every op they register is called once
# on the card against the port's own CPU output (``ops`` phase).
OPS_FAMILIES = ("misc_ops", "vision_ops", "optim_ops", "fused_ops", "seq_ops",
                "sparse_ops", "graph_ops", "conv_extra", "fft_ops")
# left out of the card check: a host op over Pillow, which the card's
# machine lacks, and the collectives, which wait for distributed (A23b-6)
OPS_LEFT_OUT = ("decode_jpeg", "all_gather", "all_reduce", "broadcast",
                "p_recv", "p_recv_array", "reduce", "reduce_scatter")
# random ops: a generator's stream differs between the CPU and the card,
# so each is held by shape, dtype and range [lo, hi]
OPS_RANDOM = {"uniform_inplace": (-1.0, 1.0), "exponential_": (0.0, np.inf),
              "dirichlet": (0.0, 1.0), "truncated_gaussian_random":
              (-2.0, 2.0), "gumbel_softmax": (0.0, 1.0),
              "class_center_sample": (-1, 9),
              "weighted_sample_neighbors": (0, 3)}
OPS_TOL = 1e-5          # the CPU sweep's default (rtol 1e-5, atol 1e-6)
OPS_ATTN_TOL = 1e-4     # the kernel against its plain version, f32


def _op_cases():
    """Seeded numpy inputs for every newly registered op but
    ``OPS_LEFT_OUT``: name -> (args, kwargs, tolerance)."""
    rng = np.random.RandomState(2026)
    f32 = np.float32

    def u(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(f32)

    def pos(*shape, lo=0.1, hi=2.0):
        return rng.uniform(lo, hi, shape).astype(f32)

    def ints(hi, *shape, dtype=np.int64):
        return rng.randint(0, hi, shape).astype(dtype)

    def a(v, dtype=f32):
        return np.array(v, dtype)

    def layer(c=16, heads=2, ffn=32):
        hd = c // heads
        return [[u(3, heads, hd, c)], [u(3, heads, hd)], [u(c, c)], [u(c)],
                [u(c, ffn)], [u(ffn)], [u(ffn, c)], [u(c)],
                [pos(c)], [u(c)], [pos(c)], [u(c)]]

    spd = u(3, 3)
    lu_in = u(4, 4) + 4 * np.eye(4, dtype=f32)
    import torch
    lu, piv = torch.linalg.lu_factor(torch.from_numpy(lu_in))
    anchors = np.sort(u(18, 2, 2, lo=2, hi=22), axis=1)
    boxes = a([[[0, 0, 2, 2], [1, 1, 3, 3], [5, 5, 6, 6]]])
    adam = (u(4), u(4), a(0.1), np.zeros(4, f32), np.zeros(4, f32),
            a([0.9]), a([0.999]))
    lists = ([u(4)], [u(4)], a(0.1), [np.zeros(4, f32)], [np.zeros(4, f32)],
             [a([0.9])], [a([0.999])])
    bn = (u(2, 3, 4, 4), np.zeros(3, f32), np.ones(3, f32), pos(3), u(3))
    T = OPS_TOL
    c = {
        # misc
        "accuracy": ((pos(4, 3), ints(3, 4, 1), ints(3, 4, 1)), {}),
        "add_n": (([u(2, 3), u(2, 3), u(2, 3)],), {}),
        "assign_out_": ((u(2, 3), u(2, 3)), {}),
        "assign_value": (([2, 2], "float32", [1., 2., 3., 4.]), {}),
        "assign_value_": ((u(4), [1., 2., 3., 4.]), {}),
        "auc": ((u(6, 2, lo=0, hi=1), ints(2, 6, 1),
                 np.zeros((1, 4096), np.int64),
                 np.zeros((1, 4096), np.int64)), {}),
        "batch_norm_": (bn, {}),
        "bce_loss": ((u(3, 4, lo=0.1, hi=0.9), ints(2, 3, 4, dtype=f32)), {}),
        "cast": ((u(2, 3, lo=-3, hi=3), "int32"), {}),
        "class_center_sample": ((ints(3, 8), 10, 5), {}),
        "clip_by_norm": ((u(3, 4), 0.5), {}),
        "coalesce_tensor": (([u(3, 4), u(2)],), {}),
        "copy_to": ((u(3, 4),), {}),
        "cross_entropy_with_softmax": ((u(4, 5), ints(5, 4, 1)), {}),
        "dirichlet": ((np.full((100, 3), 2.0, f32),), {}),
        "divide_scalar": ((u(3, 4),), {"scalar": 2.0}),
        "dropout": ((u(100),), {"p": 0.5, "training": False}),
        "elementwise_pow": ((pos(3, 4), u(3, 4)), {}),
        "exponential_": ((np.zeros(500, f32),), {"lam": 2.0}),
        "fill": ((u(2, 3), 1.5), {}),
        "fill_diagonal_tensor": ((u(3, 3), u(3)), {}),
        "frobenius_norm": ((u(3, 4),), {}),
        "full_": ((u(2, 3), 7.0), {}),
        "full_batch_size_like": ((u(4, 3), [-1, 5], 2.5), {}),
        "gumbel_softmax": ((u(50, 4),), {}),
        "hsigmoid_loss": ((u(3, 8), ints(6, 3), u(5, 8)),
                          {"num_classes": 6}),
        "huber_loss": ((u(3, 4), np.zeros((3, 4), f32)), {"delta": 1.0}),
        "i0e": ((u(3, 4),), {}),
        "i1e": ((u(3, 4),), {}),
        "kldiv_loss": ((u(3, 4, lo=-2, hi=0), pos(3, 4, lo=0.1, hi=1.0)),
                       {"reduction": "none"}),
        "log_loss": ((u(4, 1, lo=0.1, hi=0.9), ints(2, 4, 1, dtype=f32)), {}),
        "logsigmoid": ((u(3, 4),), {}),
        "lu_unpack": ((lu.numpy(), piv.numpy()), {}),
        "margin_cross_entropy": ((u(4, 5), ints(5, 4)),
                                 {"margin1": 1.0, "margin2": 0.0,
                                  "margin3": 0.0, "scale": 1.0}),
        "masked_matmul": ((u(3, 4), u(4, 3), ints(2, 3, 3, dtype=f32)), {}),
        "matrix_rank_tol": ((spd @ spd.T + np.eye(3, dtype=f32),), {}),
        "mean_all": ((u(3, 4),), {}),
        "merge_selected_rows": ((a([1, 1, 2], np.int64), u(3, 4)), {}),
        "multiplex": (([u(3, 4), u(3, 4)], ints(2, 3, 1, dtype=np.int32)),
                      {}),
        "nextafter": ((u(3, 4), u(3, 4)), {}),
        "npu_identity": ((u(3, 4),), {}),
        "p_norm": ((u(3, 4),), {"porder": 2.0, "axis": 1}),
        "pad3d": ((u(1, 2, 3, 3, 3), [1, 1, 0, 2, 1, 0]), {}),
        "renorm": ((u(3, 4),), {"p": 2.0, "axis": 0, "max_norm": 1.0}),
        "repeat_interleave_with_tensor_index":
            ((u(3), a([1, 2, 1], np.int32)), {"axis": 0}),
        "reverse": ((u(3, 4), [0]), {}),
        "rrelu": ((u(20),), {"training": False}),
        "shape": ((u(3, 4),), {}),
        "shard_index": ((a([[1], [6], [11]], np.int64), 12, 3, 0), {}),
        "share_buffer": ((u(3, 4), u(2)), {}),
        "sigmoid_cross_entropy_with_logits":
            ((u(3, 4), ints(2, 3, 4, dtype=f32)), {}),
        "spectral_norm": ((u(4, 5), u(4), u(5)), {"power_iters": 2}),
        "split_with_num": ((u(6, 3), 2), {"axis": 0}),
        "squared_l2_norm": ((u(3, 4),), {}),
        "sync_batch_norm_": (bn, {}),
        "tanh_shrink": ((u(3, 4),), {}),
        "thresholded_relu": ((u(3, 4, lo=-2, hi=2),), {}),
        "trans_layout": ((u(2, 3, 4), [2, 0, 1]), {}),
        "tril_triu": ((u(3, 4),), {"lower": True}),
        "truncated_gaussian_random": (([500],), {}),
        "uniform_inplace": ((u(500),), {}),
        # vision
        "affine_grid": ((a([[[1, 0, 0], [0, 1, 0]]]), [1, 1, 4, 4]), {}),
        "bicubic_interp": ((u(1, 2, 4, 4),), {"size": [8, 8]}),
        "bilinear_interp": ((u(1, 2, 4, 4),), {"size": [8, 8]}),
        "box_coder": ((a([[0, 0, 2, 2]]), a([[0.1, 0.1, 0.2, 0.2]]),
                       a([[1, 1, 3, 3]])),
                      {"code_type": "decode_center_size"}),
        "channel_shuffle": ((u(1, 4, 2, 2), 2), {}),
        "deformable_conv": ((u(1, 2, 5, 5), u(1, 18, 5, 5, lo=-0.1, hi=0.1),
                             u(3, 2, 3, 3)), {"paddings": (1, 1)}),
        "distribute_fpn_proposals":
            ((a([[0, 0, 10, 10], [0, 0, 200, 200]]),),
             {"rois_num": a([2], np.int32)}),
        "fold": ((u(1, 8, 9), [4, 4], [2, 2]), {}),
        "generate_proposals":
            ((pos(1, 2, 3, 3, lo=0.1, hi=0.9), u(1, 8, 3, 3, lo=-0.1,
                                                 hi=0.1),
              a([[24, 24]]), np.stack([anchors[:, 0, 0], anchors[:, 0, 1],
                                       anchors[:, 1, 0], anchors[:, 1, 1]],
                                      1), np.full((18, 4), 0.1, f32)),
             {"pre_nms_top_n": 5, "post_nms_top_n": 3}),
        "grid_sample": ((u(1, 2, 4, 4), u(1, 3, 3, 2, lo=-0.9, hi=0.9)), {}),
        "linear_interp": ((u(1, 2, 4),), {"size": [8],
                                          "data_format": "NCW"}),
        "matrix_nms": ((boxes, np.stack([np.zeros((1, 3), f32),
                                         a([[0.9, 0.8, 0.7]])], 1)),
                       {"post_threshold": 0.05, "nms_top_k": 5,
                        "keep_top_k": 5}),
        "multiclass_nms3": ((boxes, a([[[0.9, 0.3, 0.6],
                                        [0.2, 0.8, 0.1]]])),
                            {"score_threshold": 0.05, "nms_top_k": 5,
                             "keep_top_k": 9, "nms_threshold": 0.1,
                             "background_label": -1}),
        "nearest_interp": ((u(1, 2, 4, 4),), {"size": [8, 8],
                                              "align_corners": False}),
        "nms": ((a([[0, 0, 1, 1], [0.01, 0, 1.01, 1], [2, 2, 3, 3]]),),
                {"iou_threshold": 0.5}),
        "prior_box": ((u(1, 2, 4, 4), u(1, 3, 16, 16), [2.0]),
                      {"max_sizes": [4.0]}),
        "psroi_pool": ((u(1, 8, 6, 6), a([[0.5, 0.5, 4.5, 4.5]])),
                       {"boxes_num": a([1], np.int32), "pooled_height": 2,
                        "pooled_width": 2, "output_channels": 2}),
        "roi_align": ((u(1, 2, 6, 6), a([[0, 0, 4, 4]])),
                      {"boxes_num": a([1], np.int32), "pooled_height": 2,
                       "pooled_width": 2}),
        "roi_pool": ((u(1, 2, 6, 6), a([[0, 0, 4, 4]])),
                     {"boxes_num": a([1], np.int32), "pooled_height": 2,
                      "pooled_width": 2}),
        "trilinear_interp": ((u(1, 1, 3, 3, 3),),
                             {"size": [6, 6, 6], "data_format": "NCDHW"}),
        "yolo_box": ((u(1, 14, 2, 2), a([[16, 16]], np.int32),
                      [1, 2, 3, 4]), {"class_num": 2,
                                      "downsample_ratio": 8}),
        "yolo_loss": ((u(1, 14, 2, 2), u(1, 2, 4, lo=0.2, hi=0.8),
                       ints(2, 1, 2, dtype=np.int32)),
                      {"anchors": [1, 2, 3, 4], "anchor_mask": [0, 1],
                       "class_num": 2, "downsample_ratio": 8}),
        # optim
        "adadelta_": ((u(4), u(4), np.zeros(4, f32), np.zeros(4, f32)), {}),
        "adagrad_": ((u(4), u(4), np.zeros(4, f32), a(0.1)), {}),
        "adam_": (adam, {}),
        "adamax_": ((u(4), u(4), a(0.1), np.zeros(4, f32), np.zeros(4, f32),
                     a([0.9])), {}),
        "adamw_": (adam, {}),
        "average_accumulates_": ((u(4), np.zeros(4, f32), np.zeros(4, f32),
                                  np.zeros(4, f32), np.zeros(1, np.int64),
                                  np.zeros(1, np.int64),
                                  np.zeros(1, np.int64)), {}),
        "check_finite_and_unscale_": (([u(4), u(3)], a(2.0)), {}),
        "fused_adam_": (lists, {}),
        "lamb_": (adam, {}),
        "merged_adam_": (lists, {}),
        "merged_momentum_": (([u(4)], [u(4)], [np.zeros(4, f32)], a(0.1)),
                             {}),
        "momentum_": ((u(4), u(4), np.zeros(4, f32), a(0.1)), {"mu": 0.9}),
        "rmsprop_": ((u(4), np.zeros(4, f32), u(4), np.zeros(4, f32),
                      a(0.1)), {}),
        "sgd_": ((u(4), a(0.1), u(4)), {}),
        "update_loss_scaling_": (([u(4)], a(False, bool), a(32768.0),
                                  a([5], np.int32), a([0], np.int32)), {}),
        # fused (the flash route needs a head_dim the kernels take: 8)
        "add_act_xpu": ((u(3, 4), u(3, 4)), {"act_type": "gelu"}),
        "conv2d_xpu": ((u(2, 3, 6, 6), u(4, 3, 3, 3), u(4)),
                       {"paddings": (1, 1), "act_type": "relu"}),
        "embedding_with_eltwise_add_xpu":
            (([ints(5, 2, 2), ints(6, 2, 2)], [u(5, 6), u(6, 6)]), {}),
        "fc_xpu": ((u(3, 4), u(4, 5), u(5)), {"act_type": "tanh"}),
        "flash_attn": ((u(1, 8, 2, 8), u(1, 8, 2, 8), u(1, 8, 2, 8)), {}),
        "flash_attn_unpadded": ((u(8, 2, 8), u(8, 2, 8), u(8, 2, 8),
                                 a([0, 5, 8], np.int32),
                                 a([0, 5, 8], np.int32), 5, 5), {}),
        "fused_attention": ((u(1, 4, 16), u(3, 2, 8, 16), u(3, 2, 8),
                             u(16, 16), u(16)),
                            {"num_heads": 2, "ln2_scale": pos(16),
                             "ln2_bias": u(16)}),
        "fused_dropout_add": ((u(3, 4), u(3, 4)), {"p": 0.0}),
        "fused_linear_param_grad_add": ((u(4, 3), u(4, 5)), {}),
        "fused_multi_transformer_xpu": ((u(1, 4, 16), *layer()),
                                        {"num_heads": 2}),
        "generate_sequence_xpu": ((u(3, 4),), {"axis": 1}),
        "memory_efficient_attention": ((u(1, 8, 2, 8), u(1, 8, 2, 8),
                                        u(1, 8, 2, 8)), {}),
        "multi_encoder_xpu": ((u(2, 4, 16), *layer()), {"num_heads": 2}),
        "yolo_box_xpu": ((u(2, 14, 3, 3), a([[96, 96], [64, 80]], np.int32),
                          [10, 13, 16, 30], 2), {}),
        # seq
        "edit_distance": ((a([[1, 2, 3, 0]], np.int64),
                           a([[1, 3, 3, 2]], np.int64)), {}),
        "frame": ((u(16), 4, 2), {}),
        "gather_tree": ((ints(5, 3, 2, 2), ints(2, 3, 2, 2)), {}),
        "overlap_add": ((u(4, 7), 2), {}),
        "rnn": ((u(3, 2, 4), [u(1, 2, 8), u(1, 2, 8)],
                 [u(32, 4), u(32, 8), u(32), u(32)]),
                {"hidden_size": 8, "mode": "LSTM", "is_test": True}),
        "viterbi_decode": ((u(1, 3, 4), u(4, 4), a([3], np.int64)),
                           {"include_bos_eos_tag": False}),
        "warpctc": ((np.log(pos(5, 1, 4, lo=0.1, hi=1.0)),
                     a([[1, 2]], np.int32), a([5], np.int64),
                     a([2], np.int64)), {}),
        "warprnnt": ((np.log(pos(1, 4, 3, 3, lo=0.1, hi=1.0)),
                      a([[1, 2]], np.int32), a([4], np.int32),
                      a([2], np.int32)), {}),
        # sparse
        "coalesce": ((a([[0, 0, 0], [1, 1, 0]], np.int64), a([1., 2., 4.])),
                     {"shape": [2, 2]}),
        "sparse_coo_tensor": ((a([1., 2.]), a([[0, 1], [1, 0]], np.int64),
                               [2, 2]), {}),
        "to_dense": ((a([[0, 1], [1, 0]], np.int64), a([1., 2.]), [2, 2]),
                     {}),
        "to_sparse_coo": ((a([[1, 0], [0, 2]]),), {"sparse_dim": 2}),
        "to_sparse_csr": ((a([[1, 0], [0, 2]]),), {}),
        "values": ((a([[0, 1], [1, 0]], np.int64), a([1., 2.])), {}),
        # graph
        "reindex_graph": ((a([0, 5, 9], np.int64), a([5, 9, 0], np.int64),
                           a([2, 1], np.int64)), {}),
        "segment_pool": ((u(4, 3), a([0, 0, 1, 1], np.int32)), {}),
        "send_u_recv": ((u(4, 3), a([0, 1, 2], np.int32),
                         a([1, 2, 3], np.int32)), {}),
        "send_ue_recv": ((u(4, 3), u(3, 3), a([0, 1, 2], np.int32),
                          a([1, 2, 3], np.int32)), {}),
        "send_uv": ((u(4, 3), u(4, 3), a([0, 1], np.int32),
                     a([1, 2], np.int32)), {}),
        "weighted_sample_neighbors": ((a([1, 2, 0, 2], np.int64),
                                       a([0, 2, 4], np.int64), pos(4),
                                       a([0, 1], np.int64)),
                                      {"sample_size": 1}),
        # conv_extra
        "conv3d_transpose": ((u(1, 2, 3, 3, 3), u(2, 2, 2, 2, 2)), {}),
        "depthwise_conv2d": ((u(1, 2, 5, 5), u(2, 1, 3, 3)),
                             {"stride": 1, "padding": 0, "groups": 2}),
        "depthwise_conv2d_transpose": ((u(1, 2, 4, 4), u(2, 1, 3, 3)),
                                       {"groups": 2}),
        # fft
        "fft_c2c": (((u(8) + 1j * u(8)).astype(np.complex64), [0]), {}),
        "fft_c2r": ((np.fft.rfft(u(8)).astype(np.complex64), [0]), {}),
        "fft_r2c": ((u(8), [0]), {}),
    }
    loose = {"bce_loss": 1e-4, "kldiv_loss": 1e-4, "log_loss": 1e-4,
             "sigmoid_cross_entropy_with_logits": 1e-4, "grid_sample": 1e-4,
             "flash_attn": OPS_ATTN_TOL, "memory_efficient_attention":
             OPS_ATTN_TOL, "fused_attention": OPS_ATTN_TOL,
             "multi_encoder_xpu": OPS_ATTN_TOL,
             "fused_multi_transformer_xpu": OPS_ATTN_TOL,
             "flash_attn_unpadded": OPS_ATTN_TOL}
    return {n: (args, kw, loose.get(n, T)) for n, (args, kw) in c.items()}


def _new_ops():
    """The inventory ops registered by the A23b-2 families, less
    ``OPS_LEFT_OUT``."""
    from paddle_tpu_torch.ops.inventory import OP_INVENTORY
    from paddle_tpu_torch.ops.registry import OPS

    mods = tuple(f"paddle_tpu_torch.ops.{m}" for m in OPS_FAMILIES)
    out = []
    for name in OP_INVENTORY:
        od = OPS[name]
        fn = od.body if od.body is not None else od.user_fn
        if fn.__module__ in mods and name not in OPS_LEFT_OUT:
            out.append(name)
    return sorted(out)


def _on(paddle, device, args, kwargs):
    """The case's numpy arrays (alone or in a list) as Tensors on
    ``device``, everything else as it is."""
    paddle.set_device(device)

    def wrap(v):
        if isinstance(v, np.ndarray):
            return paddle.to_tensor(v)
        if isinstance(v, list) and v and all(isinstance(e, np.ndarray)
                                             for e in v):
            return [paddle.to_tensor(e) for e in v]
        return v
    return [wrap(v) for v in args], dict(kwargs)


def _leaves(out):
    import torch

    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    data = getattr(out, "_data", out)
    if isinstance(data, torch.Tensor):
        return [data.detach().cpu()]
    return []


def _op_on(paddle, name, case, device):
    from paddle_tpu_torch.ops.registry import OPS

    args, kwargs, _ = case
    targs, tkw = _on(paddle, device, args, kwargs)
    return _leaves(OPS[name].user_fn(*targs, **tkw))


def _op_verdict(name, got, want, tol):
    """(ok, worst |err|) of the card's outputs against the CPU's."""
    import torch

    if len(got) != len(want):
        return False, f"{len(got)} outputs, CPU {len(want)}"
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return False, f"{tuple(g.shape)} {g.dtype} vs CPU " \
                f"{tuple(w.shape)} {w.dtype}"
        if name in OPS_RANDOM:
            lo, hi = OPS_RANDOM[name]
            gf = g.double()
            if g.numel() and (float(gf.min()) < lo - 1e-6
                              or float(gf.max()) > hi + 1e-6):
                return False, f"range [{float(gf.min())}, " \
                    f"{float(gf.max())}] outside [{lo}, {hi}]"
            continue
        if g.is_floating_point() or g.is_complex():
            err = float((g - w).abs().max()) if g.numel() else 0.0
            worst = max(worst, err)
            if not torch.allclose(g, w, rtol=tol, atol=tol, equal_nan=True):
                return False, err
        elif not torch.equal(g, w):
            return False, "integer outputs differ"
    return True, worst


def _ops_one_each(paddle, dev, smi):
    """Every newly registered op once on the card against its CPU
    output, from ``_op_cases``' inputs."""
    cases = _op_cases()
    want_names = _new_ops()
    if sorted(cases) != want_names:
        raise RuntimeError(
            f"op cases {sorted(set(cases) ^ set(want_names))} differ from "
            f"the registered ops")
    gpu = f"gpu:{dev.index or 0}"
    failed, worst = {}, {}
    for name in want_names:
        try:
            want = _op_on(paddle, name, cases[name], "cpu")
            got = _op_on(paddle, name, cases[name], gpu)
            ok, err = _op_verdict(name, got, want, cases[name][2])
        except Exception as e:  # reported, then the phase fails
            ok, err = False, f"{type(e).__name__}: {e}"
        if ok:
            worst[name] = err
        else:
            failed[name] = str(err)[:300]
    paddle.set_device(gpu)
    top = sorted(worst, key=worst.get)[-5:]
    say("ops_on_card", card=smi, ops=len(want_names),
        left_out=list(OPS_LEFT_OUT), random_by_range=sorted(OPS_RANDOM),
        agree=len(worst), failed=failed,
        worst_max_abs_err={n: worst[n] for n in top})
    if failed:
        raise RuntimeError(f"ops on the card against the CPU: {failed}")


def _events_ms(fn, reps=3):
    """Median ms of ``reps`` calls of ``fn`` by CUDA events, after one
    call that builds and warms it."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def _heavy_ops(paddle, dev, smi):
    """Five ops at the sizes their users run, timed, no threshold."""
    from paddle_tpu_torch.ops.registry import OPS

    rng = np.random.RandomState(7)
    paddle.set_device(f"gpu:{dev.index or 0}")

    def t(a):
        return paddle.to_tensor(np.ascontiguousarray(a))

    xy = rng.uniform(0, 1000, (2000, 2)).astype(np.float32)
    wh = rng.uniform(10, 100, (2000, 2)).astype(np.float32)
    boxes = t(np.concatenate([xy, xy + wh], 1))
    scores = t(rng.uniform(0, 1, 2000).astype(np.float32))
    feat = t(rng.uniform(-1, 1, (1, 256, 200, 272)).astype(np.float32))
    rxy = rng.uniform(0, 1000, (512, 2)).astype(np.float32)
    rwh = rng.uniform(16, 256, (512, 2)).astype(np.float32)
    rois = t(np.concatenate([rxy, rxy + rwh], 1))
    x3 = t(rng.uniform(-1, 1, (2, 256, 50, 68)).astype(np.float32))
    off = t(rng.uniform(-1, 1, (2, 18, 50, 68)).astype(np.float32))
    w3 = t(rng.uniform(-0.05, 0.05, (256, 256, 3, 3)).astype(np.float32))
    logits = t(rng.uniform(-1, 1, (500, 16, 29)).astype(np.float32))
    labels = t(rng.randint(1, 29, (16, 80)).astype(np.int32))
    in_len = t(np.full(16, 500, np.int64))
    lab_len = t(np.full(16, 80, np.int64))
    sig = t(rng.uniform(-1, 1, (16, 16000)).astype(np.float32))
    runs = {
        "nms_2000_boxes": lambda: OPS["nms"].user_fn(boxes, 0.5, scores),
        "roi_align_512x7x7_on_1x256x200x272": lambda: OPS["roi_align"]
        .user_fn(feat, rois, pooled_height=7, pooled_width=7,
                 spatial_scale=0.25, sampling_ratio=2),
        "deformable_conv_resnet50_stage3_2x256x50x68": lambda:
        OPS["deformable_conv"].user_fn(x3, off, w3, paddings=(1, 1)),
        "warpctc_16x500x29_labels_80": lambda: OPS["warpctc"].user_fn(
            logits, labels, in_len, lab_len),
        "fft_r2c_16x16000": lambda: OPS["fft_r2c"].user_fn(sig, [1]),
    }
    ms = {k: _events_ms(fn) for k, fn in runs.items()}
    kept = int(runs["nms_2000_boxes"]()[1].item())
    say("ops_heavy_times", card=smi, ms=ms, nms_kept_of_2000=kept,
        threshold=None)
    return ms


def _attention_entry_points(paddle, dev, smi):
    """B2/B3 through the new entry points at full width, each call held
    to the same call with the flash kernels replaced by their plain
    versions on f32 copies; B2 and B3 must launch exactly as the calls
    predict.  The attention outputs are held by ``_parity``'s
    elementwise rule; ``fused_multi_head_attention``'s output, a
    LayerNorm of a residual sum rounded to bf16 after f32 projections of
    the bf16 context, is held as a layer's output, within
    ``VISION_GRAD_RTOL`` of its norm (one-ulp flips of the context move
    it by more than the elementwise rule's 1e-2 at a few elements).
    The gradients are held as the ViT step's are (each within
    ``VISION_GRAD_RTOL`` of its norm plus ``VISION_GRAD_FLOOR`` of the
    largest): the plain route's backward reads its own forward's output
    and lse, which differ from the kernels' by their rounding, so the
    elementwise rule of the kernel phase, which feeds both backwards the
    kernel forward's, does not apply (dq of the first causal rows
    cancels; rel-L2 errors ~2e-4 on the card).  ``flash_attn`` and
    ``memory_efficient_attention`` take the flash phase's inputs
    (standard normal).  Returns the launches (counts at 0 before each
    call)."""
    import torch

    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops import attention
    from paddle_tpu_torch.ops.cuda import registry

    rng = np.random.RandomState(16)
    bf16 = paddle.bfloat16

    def t(shape, scale=None):
        a = (rng.randn(*shape) if scale is None
             else rng.uniform(-scale, scale, shape))
        return paddle.to_tensor(a.astype(np.float32)).astype(bf16)

    def run(fn, inputs, backward):
        for x in inputs:
            x.stop_gradient = not backward
            x.clear_gradient()
        out = fn(*inputs)
        res = {"out": out._data.detach().clone()}
        if backward:
            dout = torch.from_numpy(np.random.RandomState(3).randn(
                *out.shape).astype(np.float32)).to(out._data.device,
                                                   out._data.dtype)
            out.backward(paddle.to_tensor(dout))
            res.update({f"d{i}": x.grad._data.clone()
                        for i, x in enumerate(inputs)})
        return res

    def by_norm(got, plain, keys):
        top = max(float(plain[k].float().norm()) for k in keys)
        return {k: float((got[k].float() - plain[k].float()).norm())
                / (VISION_GRAD_RTOL * float(plain[k].float().norm())
                   + VISION_GRAD_FLOOR * top) for k in keys}

    gpt = [t((8, 1024, 12, 64)) for _ in range(3)]
    bert = [t((8, 512, 768)), t((3, 12, 64, 768), 0.05),
            t((768, 768), 0.05), t((3, 12, 64), 0.02), t((768,), 0.02),
            t((768,), 0.1) + 1.0, t((768,), 0.02)]
    mea = [t((8, 512, 12, 64)) for _ in range(3)]
    calls = [
        ("flash_attn", "8x1024x12x64 bf16 causal (GPT-124M training)",
         lambda q, k, v: paddle.flash_attn(q, k, v, causal=True), gpt,
         True, False, {"flash_attention_fwd": 1, "flash_attention_bwd": 1}),
        ("incubate.nn.functional.fused_multi_head_attention",
         "8x512x768, 12 heads bf16, no mask, training, dropout 0 "
         "(BERT-base)",
         lambda x, qkv, lw, qb, lb, s, c: IF.fused_multi_head_attention(
             x, qkv, lw, qkv_bias=qb, linear_bias=lb, ln_scale=s,
             ln_bias=c, num_heads=12, training=True, dropout_rate=0.0,
             attn_dropout_rate=0.0), bert, True, True,
         {"flash_attention_fwd": 1, "flash_attention_bwd": 1}),
        ("memory_efficient_attention", "8x512x12x64 bf16, forward",
         lambda q, k, v: paddle.memory_efficient_attention(q, k, v), mea,
         False, False, {"flash_attention_fwd": 1, "flash_attention_bwd": 0}),
    ]
    launches = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
    for name, shape, fn, inputs, backward, layer, want in calls:
        registry.reset_counts()
        got = run(fn, inputs, backward)
        torch.cuda.synchronize(dev)
        counts = {k: registry.counts()[k] for k in want}
        with _PlainKernels() as plain_calls:
            attention.flash_attention_cuda = _f32_plain_flash(plain_calls)
            plain = run(fn, inputs, backward)
        report = {"out": _parity(got["out"], plain["out"], OPS_ATTN_TOL)}
        over = {"out": report["out"][2]}
        if layer:
            over = by_norm(got, plain, ["out"])
            report["out"] = report["out"][:3] + (
                bool(torch.isfinite(got["out"]).all()),)
        if backward:
            over.update(by_norm(got, plain, [k for k in got if k != "out"]))
        fwd_ms = _events_ms(lambda: fn(*inputs))

        def fwd_bwd():
            out = fn(*inputs)
            out.backward(paddle.ones_like(out))
        both_ms = _events_ms(fwd_bwd) if backward else None
        for x in inputs:
            x.clear_gradient()
        say("ops_attention_entry", card=smi, entry=name, shape=shape,
            max_abs_err={k: r[0] for k, r in report.items()},
            err_over_limit=over, launches=counts, expected=want,
            plain_run_calls=plain_calls, forward_ms=fwd_ms,
            forward_backward_ms=both_ms)
        bad = {k: v for k, v in over.items() if not v <= 1.0}
        bad.update({k: r for k, r in report.items() if not r[3]})
        if bad or counts != want:
            raise RuntimeError(f"{name}: kernels against plain, over the "
                               f"limit {bad}; launches {counts} != {want}")
        for k, n in counts.items():
            launches[k] += n
    return launches


class _RuleCheck:
    """Wraps ``opt.step``: every call runs in a ``record_function``
    range named ``OPT_RANGE``; the call numbered ``at`` also
    snapshots each parameter, its gradient as ``step`` will use it
    (plus the coupled decay) and its state, and holds the update
    ``step`` makes to ``opt.rule`` from the snapshot."""

    def __init__(self, opt, at=1):
        self.opt, self.at, self.calls = opt, at, 0
        self.report = None
        self._step = opt.step
        opt.step = self

    def __call__(self):
        import torch
        from torch.profiler import record_function

        opt = self.opt
        check = self.calls == self.at
        self.calls += 1
        if check:
            snap = []
            wd = float(opt._weight_decay or 0.0) \
                if not opt._decay_applied_in_rule() else 0.0
            with torch.no_grad():
                for item in opt._parameters:
                    p = item._data
                    if p.grad is None:
                        continue
                    g = p.grad.clone()
                    if wd:
                        g = g + wd * p
                    state = opt._accumulators.get(id(item)) \
                        or opt._init_state(p)
                    snap.append((p, p.detach().clone(), g, {
                        k: (v.clone() if isinstance(v, torch.Tensor) else v)
                        for k, v in state.items()}))
            lr = opt.get_lr()
        with record_function(OPT_RANGE):
            self._step()
        if check:
            worst = 0.0
            with torch.no_grad():
                for p, before, g, state in snap:
                    want = opt.rule(before, g, state, lr)[0]
                    scale = max(float(want.abs().max()), 1e-30)
                    worst = max(worst,
                                float((p - want).abs().max()) / scale)
            self.report = {"params": len(snap), "worst_rel_err": worst}


def _range_share(prof, name):
    """Device time of the kernels launched inside the ``name`` range
    (its host row's device total), over all kernel time of the window
    (the range's own device row, its span, left out)."""
    from torch.autograd import DeviceType

    rows = prof.key_averages()
    total = sum(e.self_device_time_total for e in rows
                if e.device_type == DeviceType.CUDA and e.key != name)
    mine = sum(e.device_time_total for e in rows
               if e.device_type == DeviceType.CPU and e.key == name)
    return mine / total if total else None


def _lamb_bert(paddle, dev, smi, warmup=3, steps=5):
    """``Lamb(lamb_weight_decay=0.01)`` on the eager BERT-base
    pretraining step (8 x 512, f32): one step's update held to the plain
    rule, ms a step and the optimizer's share of device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models.bert import (
        BertForPretraining,
        bert_base_config,
    )

    cfg = bert_base_config()
    paddle.seed(0)
    model = BertForPretraining(cfg)
    opt = paddle.optimizer.Lamb(learning_rate=1e-3, lamb_weight_decay=0.01,
                                parameters=model.parameters())
    check = _RuleCheck(opt)
    (ids, types, mask, mlm, nsp), _ = _bert_batch(cfg, seed=2024)

    def step():
        loss = model.loss(*model(ids, types, mask), mlm, nsp)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss)

    losses = [step() for _ in range(warmup)]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    losses += [step() for _ in range(steps)]
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize(dev)
    fields = _device_profile(prof, 1, ms)
    share = _range_share(prof, OPT_RANGE)
    say("ops_optimizer", card=smi, optimizer="Lamb(lr 1e-3, "
        "lamb_weight_decay=0.01)", model="BertForPretraining(bert_base_"
        "config()) f32 eager", batch=BERT_BATCH, seq=BERT_SEQ,
        warmup_steps=warmup, timed_steps=steps, losses=losses,
        ms_per_step=ms, optimizer_device_share=share,
        rule_check=check.report, rule_rtol=1e-6,
        **{k: v for k, v in fields.items() if k != "wall_ms_per_step"})
    if (check.report is None or check.report["worst_rel_err"] > 1e-6
            or not all(np.isfinite(losses))):
        raise RuntimeError(f"Lamb on BERT-base: rule {check.report}, "
                           f"losses {losses}")
    del model, opt


def _momentum_resnet(paddle, dev, smi):
    """``Momentum(0.1, 0.9, weight_decay=1e-4)`` on ResNet-50's
    ``Model.fit`` under O1 at batch 64 (PaddleClas ResNet50.yaml's
    optimizer), 2 + 3 steps, one step's update held to the plain rule."""
    import torch

    from paddle_tpu_torch.vision.models import resnet50

    paddle.seed(0)
    net = resnet50()
    checks = []

    def make_opt(params):
        opt = paddle.optimizer.Momentum(0.1, 0.9, parameters=params,
                                        weight_decay=1e-4)
        checks.append(_RuleCheck(opt))
        return opt

    launches, fields, _, _ = _fit(dev, smi, "resnet50", net, RESNET_STEPS,
                                  seed=21, make_opt=make_opt)
    report = checks[0].report
    say("ops_optimizer", optimizer="Momentum(0.1, 0.9, weight_decay=1e-4)",
        rule_check=report, rule_rtol=1e-6, kernel_launches=launches,
        **fields)
    if report is None or report["worst_rel_err"] > 1e-6:
        raise RuntimeError(f"Momentum on ResNet-50: rule {report}")
    del net
    torch.cuda.empty_cache()


def ops_phase(dev, smi):
    """The rest of the op surface on the card (ROADMAP A23b-2):

    - B2/B3 through the new entry points at full width:
      ``paddle.flash_attn`` at GPT-124M's training shape (8 x 1024 x 12
      x 64 bf16, causal, forward and backward),
      ``incubate.nn.functional.fused_multi_head_attention`` at BERT-base
      widths (8 x 512 x 768, 12 heads, bf16, no mask, training with both
      dropout rates 0, forward and backward) and
      ``memory_efficient_attention`` at the same shape (forward), each
      held to the same call with the kernels' plain versions (f32
      copies) under ``_parity``, with its launches;
    - the new optimizers on full-width models with the recipes users
      run: ``Lamb`` on the eager BERT-base step, ``Momentum`` on
      ResNet-50's ``Model.fit`` under O1; each one step's update of
      every parameter within 1e-6 relative of the plain rule, ms a step
      and the optimizer's share of device time;
    - every newly registered op (but ``OPS_LEFT_OUT``) once on the card
      against the port's CPU output (random ops by shape and range);
    - five heavy ops timed, no threshold.

    Returns the B2/B3 launches of the entry-point calls."""
    import torch

    import paddle_tpu_torch as paddle

    paddle.set_device(f"gpu:{dev.index or 0}")
    launches = _attention_entry_points(paddle, dev, smi)
    torch.cuda.empty_cache()
    _lamb_bert(paddle, dev, smi)
    torch.cuda.empty_cache()
    _momentum_resnet(paddle, dev, smi)
    torch.cuda.empty_cache()
    _ops_one_each(paddle, dev, smi)
    _heavy_ops(paddle, dev, smi)
    paddle.set_device(f"gpu:{dev.index or 0}")
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- the speech path --
SPEECH_SR = 16000
SPEECH_SECONDS = 10
# the Conformer paper's front end: 80 log-mel channels, 25 ms windows
# every 10 ms
SPEECH_FRONT_END = dict(sr=SPEECH_SR, n_fft=512, win_length=400,
                        hop_length=160, n_mels=80)
SPEECH_LABEL_LEN = 100       # characters in 10 s of read speech, about
# the card's f32 (TF32 off) against the CPU port on the same weights and
# features: cuDNN's convolutions, the flash and LayerNorm kernels and the
# CPU's sum in other orders, through 8 blocks (Conformer) or 3 bi-GRU
# layers over 251 steps (DeepSpeech2)
SPEECH_F32_TOL = 1e-4
SPEECH_KERNELS = _EAGER_KERNELS


def _waves(paddle, batch, seed):
    """``batch`` synthetic 10 s waveforms at 16 kHz from ``seed``: a few
    harmonic tones under noise, as a Tensor on the current device."""
    rng = np.random.RandomState(seed)
    t = np.arange(SPEECH_SR * SPEECH_SECONDS) / SPEECH_SR
    f0 = rng.uniform(90, 250, (batch, 1))
    wave = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6, (batch, 1)))
               / k for k in range(1, 6))
    wave = wave + 0.05 * rng.randn(batch, t.size)
    return paddle.to_tensor((0.1 * wave).astype(np.float32))


def _log_mel(paddle, wave):
    """[B, samples] -> log-mel features [B, T, 80] through the port's
    ``audio.features.LogMelSpectrogram``."""
    from paddle_tpu_torch.audio.features import LogMelSpectrogram

    return LogMelSpectrogram(**SPEECH_FRONT_END)(wave).transpose([0, 2, 1])


def _ctc_labels(paddle, batch, vocab, seed):
    rng = np.random.RandomState(seed)
    return paddle.to_tensor(rng.randint(1, vocab + 1,
                                        (batch, SPEECH_LABEL_LEN))
                            .astype(np.int32))


def _on_cpu_like(paddle, make, model, dev):
    """``make()`` built on the CPU with ``model``'s weights (moved from
    the card by name); the current device is the card again after."""
    paddle.set_device("cpu")
    twin = make()
    twin.set_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    paddle.set_device(f"gpu:{dev.index or 0}")
    return twin


def _profiled_steps(step, steps, dev):
    """``steps`` calls of ``step``, each timed on the host clock to a
    synchronize, then one more under torch.profiler, the card's activity
    alone -> (losses, wall ms of each step, ``_device_profile`` of the
    profiled one against the median wall ms).  Host operators are not
    traced: ``_device_profile`` reads none, and a step of ~10^5 launches
    (DeepSpeech2's GRU loop) costs tens of seconds of profiler overhead
    with them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    losses, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize(dev)
    wall = float(np.median(walls))
    return losses, walls, _device_profile(prof, 1, wall)


def _greedy_ctc(logits):
    """Greedy CTC decode of logits [B, T, V] (blank 0): argmax a frame,
    repeats merged, blanks dropped -> a list of label lists."""
    best = logits.argmax(-1).cpu().numpy()
    out = []
    for row in best:
        keep = np.concatenate([[True], row[1:] != row[:-1]]) & (row != 0)
        out.append(row[keep].tolist())
    return out


def speech_phase(dev, smi, steps=3):
    """The speech path at full width: 16 synthetic 16 kHz waveforms of
    10 s (from a seed) -> ``LogMelSpectrogram`` (80 channels, 25 ms /
    10 ms) -> ``Conformer()`` at the JAX package's defaults (feat 80,
    d_model 144, 8 blocks, 4 heads, conv 15, vocab 29, dropout 0.1), f32
    -> CTC -> AdamW, ``steps`` steps (every LayerNorm on B4a/B4b; the
    attention's dropout takes the plain route in training, as the JAX
    dispatcher sends it); then one step of ``Conformer(dropout=0.0)``
    (B2 and B3 at head_dim 36 in the model) and an eval forward with a
    greedy CTC decode (B2 at 16 x 251 x 4 x 36).  The first step's loss
    of the dropout-free model and the eval logits are held against the
    port on the CPU at batch 2 on the same weights and features (the
    card's and the CPU's dropout draws differ, so the dropout model is
    not), at ``SPEECH_F32_TOL``.  Then ``DeepSpeech2()`` at its defaults
    (feat 64, 3 bi-GRU layers of 256) on 8 waveforms: 2 steps, the first
    loss against the CPU port at batch 2; host-bound (a Python loop of
    GRU cell launches and CTC's recursion), with wall and device ms a
    step.  Each main path runs with the counts at 0 and is read just
    after; returns the kernels' launches, summed."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.conformer import Conformer
    from paddle_tpu_torch.models.deepspeech import DeepSpeech2
    from paddle_tpu_torch.ops.cuda import registry

    paddle.set_device(f"gpu:{dev.index or 0}")
    launches = dict.fromkeys(SPEECH_KERNELS, 0)

    def count(fn):
        registry.reset_counts()
        out = fn()
        torch.cuda.synchronize(dev)
        for k, n in _counts(registry).items():
            launches[k] += n
        return out

    # the front end, on the card and (for two waveforms) on the CPU
    wave = _waves(paddle, 16, seed=7)
    t0 = time.perf_counter()
    feats = _log_mel(paddle, wave)
    torch.cuda.synchronize(dev)
    front_ms = (time.perf_counter() - t0) * 1e3
    paddle.set_device("cpu")
    cpu_feats = _log_mel(paddle, paddle.to_tensor(wave.numpy()[:2]))
    paddle.set_device(f"gpu:{dev.index or 0}")
    feat_err = _parity(torch.as_tensor(feats.numpy()[:2]), cpu_feats._data,
                       SPEECH_F32_TOL)
    say("speech_front_end", waves=list(wave.shape), feats=list(feats.shape),
        ms=front_ms, against_cpu_max_abs_err=feat_err[0],
        err_over_limit=feat_err[2], nvidia_smi=smi)
    if not feat_err[3]:
        raise RuntimeError(f"log-mel features differ from the CPU's: "
                           f"{feat_err}")
    labels = _ctc_labels(paddle, 16, 29, seed=8)

    # Conformer at its defaults, dropout 0.1: the training steps
    paddle.seed(0)
    model = Conformer()
    n_params = sum(p.size for p in model.parameters())
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())

    def step():
        loss = model.loss(model(feats), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    torch.cuda.reset_peak_memory_stats(dev)
    losses, walls, prof = count(lambda: _profiled_steps(step, steps, dev))
    n_ln = 6 * len(model.blocks)
    step_counts = dict(launches)
    say("speech_conformer_training", params=n_params, batch=16,
        frames=feats.shape[1], losses=losses, wall_ms=walls, **prof,
        launches=step_counts, layernorms_a_forward=n_ln,
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
        nvidia_smi=smi)
    want = {"layernorm_fwd": n_ln * (steps + 1),
            "layernorm_bwd": n_ln * (steps + 1),
            "flash_attention_fwd": 0, "flash_attention_bwd": 0}
    if step_counts != want:
        raise RuntimeError(f"Conformer step launches {step_counts} != {want}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"Conformer losses not finite: {losses}")

    # dropout 0.0: B2/B3 at head_dim 36 inside the model; its first step
    # held against the CPU port at batch 2
    paddle.seed(1)
    model0 = Conformer(dropout=0.0)
    cpu0 = _on_cpu_like(paddle, lambda: Conformer(dropout=0.0), model0, dev)
    small_f, small_l = feats[:2], labels[:2]
    loss_small = model0.loss(model0(small_f), small_l)
    paddle.set_device("cpu")
    cpu_small = cpu0.loss(cpu0(paddle.to_tensor(small_f.numpy())),
                          paddle.to_tensor(small_l.numpy()))
    paddle.set_device(f"gpu:{dev.index or 0}")
    loss_err = abs(float(loss_small) - float(cpu_small)) / max(
        1.0, abs(float(cpu_small)))
    opt0 = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=model0.parameters())
    before = dict(launches)

    def step0():
        loss = model0.loss(model0(feats), labels)
        loss.backward()
        opt0.step()
        opt0.clear_grad()
        return loss

    t0 = time.perf_counter()
    loss0 = float(count(step0))
    wall0 = (time.perf_counter() - t0) * 1e3
    d36 = {k: launches[k] - before[k] for k in launches}
    say("speech_conformer_no_dropout_step", loss=loss0, wall_ms=wall0,
        launches=d36, batch2_loss=float(loss_small),
        batch2_cpu_loss=float(cpu_small), batch2_loss_rel_err=loss_err,
        tolerance=SPEECH_F32_TOL)
    if d36["flash_attention_fwd"] != len(model0.blocks) or \
            d36["flash_attention_bwd"] != len(model0.blocks):
        raise RuntimeError(f"dropout-free step launches {d36}: B2 and B3 "
                           f"must run once a block")
    if not loss_err <= SPEECH_F32_TOL:
        raise RuntimeError(f"Conformer batch-2 loss {float(loss_small)} "
                           f"vs CPU {float(cpu_small)}")

    # eval forward + greedy CTC decode (B2 at 16 x T' x 4 x 36)
    model.eval()
    before = dict(launches)
    with paddle.no_grad():
        t0 = time.perf_counter()
        logits = count(lambda: model(feats))
        eval_ms = (time.perf_counter() - t0) * 1e3
    decoded = _greedy_ctc(logits._data)
    ev = {k: launches[k] - before[k] for k in launches}
    cpu_model = _on_cpu_like(paddle, Conformer, model, dev)
    cpu_model.eval()
    paddle.set_device("cpu")
    with paddle.no_grad():
        cpu_logits = cpu_model(paddle.to_tensor(small_f.numpy()))
    paddle.set_device(f"gpu:{dev.index or 0}")
    lerr = _parity(logits._data[:2].cpu(), cpu_logits._data, SPEECH_F32_TOL)
    say("speech_conformer_eval", logits=list(logits.shape), ms=eval_ms,
        launches=ev, decoded_lengths=[len(d) for d in decoded],
        batch2_logits_max_abs_err=lerr[0], err_over_limit=lerr[2],
        finite=bool(torch.isfinite(logits._data).all()))
    if ev["flash_attention_fwd"] != len(model.blocks) or not lerr[3]:
        raise RuntimeError(f"Conformer eval: launches {ev}, logits "
                           f"against the CPU {lerr}")
    del model, model0, opt, opt0, cpu0, cpu_model
    torch.cuda.empty_cache()

    # DeepSpeech2 at its defaults: 64 log-mel channels, 8 waveforms
    ds_wave = _waves(paddle, 8, seed=9)
    from paddle_tpu_torch.audio.features import LogMelSpectrogram

    ds_front = dict(SPEECH_FRONT_END, n_mels=64)
    ds_feats = LogMelSpectrogram(**ds_front)(ds_wave).transpose([0, 2, 1])
    ds_labels = _ctc_labels(paddle, 8, 28, seed=10)
    paddle.seed(2)
    ds = DeepSpeech2()
    cpu_ds = _on_cpu_like(paddle, DeepSpeech2, ds, dev)
    ds_opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                    parameters=ds.parameters())
    first = ds.loss(ds(ds_feats[:2]), ds_labels[:2])
    paddle.set_device("cpu")
    cpu_first = cpu_ds.loss(cpu_ds(paddle.to_tensor(ds_feats.numpy()[:2])),
                            paddle.to_tensor(ds_labels.numpy()[:2]))
    paddle.set_device(f"gpu:{dev.index or 0}")
    ds_err = abs(float(first) - float(cpu_first)) / max(
        1.0, abs(float(cpu_first)))

    def ds_step():
        loss = ds.loss(ds(ds_feats), ds_labels)
        loss.backward()
        ds_opt.step()
        ds_opt.clear_grad()
        return loss

    ds_losses, ds_walls, ds_prof = count(
        lambda: _profiled_steps(ds_step, 1, dev))
    say("speech_deepspeech2_training", params=sum(
        p.size for p in ds.parameters()), batch=8,
        frames=ds_feats.shape[1], losses=ds_losses, wall_ms=ds_walls,
        **ds_prof, batch2_loss=float(first), batch2_cpu_loss=float(cpu_first),
        batch2_loss_rel_err=ds_err, tolerance=SPEECH_F32_TOL, nvidia_smi=smi)
    if not ds_err <= SPEECH_F32_TOL or not all(np.isfinite(ds_losses)):
        raise RuntimeError(f"DeepSpeech2: losses {ds_losses}, batch-2 loss "
                           f"{float(first)} vs CPU {float(cpu_first)}")
    del ds, cpu_ds, ds_opt
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------- the vision zoo --
ZOO = [("vgg16", 224), ("mobilenet_v2", 224), ("densenet121", 224),
       ("squeezenet1_1", 224), ("shufflenet_v2_x1_0", 224),
       ("inception_v3", 299)]
ZOO_BATCH = 8
# the card's f32 (cuDNN, TF32 off) against the CPU port on one set of
# weights, relative to the largest logit: sums over up to 4608 terms, 16
# to 121 layers deep
ZOO_F32_TOL = 1e-3


@contextlib.contextmanager
def _no_dropout(*models):
    """Every ``nn.Dropout`` of ``models`` at p = 0 inside the block."""
    layers = [m for model in models for m in model.sublayers()
              if type(m).__name__ == "Dropout"]
    saved = [m.p for m in layers]
    for m in layers:
        m.p = 0.0
    try:
        yield
    finally:
        for m, p in zip(layers, saved):
            m.p = p


def vision_zoo_phase(dev, smi):
    """Each of the six default constructors built on the card in f32
    (vgg16, mobilenet_v2, densenet121, squeezenet1_1, shufflenet_v2_x1_0,
    inception_v3; 1000 classes): an eval forward at batch 8 over 224²
    (299² for Inception) images, timed; the logits of two of those
    images in train mode with dropout off (batch statistics: at random
    initialisation the eval-mode logits of the deep models are ~1e-14)
    held against the CPU port on the same weights and images at
    ``ZOO_F32_TOL``; then ``Momentum(0.1, 0.9)`` steps on cross entropy
    (dropout on), with device ms a step from torch.profiler and peak
    memory.  No kernel of the port runs here: the convolutions are
    cuDNN's, as they are XLA's in the JAX package."""
    import torch

    import paddle_tpu_torch as paddle

    for name, hw in ZOO:
        paddle.set_device(f"gpu:{dev.index or 0}")
        torch.cuda.reset_peak_memory_stats(dev)
        paddle.seed(0)
        ctor = getattr(paddle.vision.models, name)
        model = ctor()
        x = paddle.to_tensor(np.random.RandomState(11).rand(
            ZOO_BATCH, 3, hw, hw).astype(np.float32))
        y = paddle.to_tensor(np.random.RandomState(12).randint(
            0, 1000, (ZOO_BATCH,)))
        model.eval()
        with paddle.no_grad():
            t0 = time.perf_counter()
            logits = model(x)
            torch.cuda.synchronize(dev)
            eval_ms = (time.perf_counter() - t0) * 1e3
        cpu = _on_cpu_like(paddle, ctor, model, dev)
        model.train()
        with _no_dropout(model, cpu), paddle.no_grad():
            got = model(x[:2])
            paddle.set_device("cpu")
            want = cpu(paddle.to_tensor(x.numpy()[:2]))
            paddle.set_device(f"gpu:{dev.index or 0}")
        # relative to the logits' own scale (0.03 for VGG, 2e-4 for
        # SqueezeNet at this initialisation, O(1) under BatchNorm)
        scale = float(want._data.abs().max())
        err = _parity(got._data.cpu() / scale, want._data / scale,
                      ZOO_F32_TOL)
        opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                        parameters=model.parameters())

        def step():
            loss = paddle.nn.functional.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        losses, walls, prof = _profiled_steps(step, 2, dev)
        say("vision_zoo", model=name, input=[ZOO_BATCH, 3, hw, hw],
            params=sum(p.size for p in model.parameters()),
            eval_ms=eval_ms, eval_logits_max_abs=float(
                logits._data.abs().max()),
            batch2_train_logits_max_abs=float(want._data.abs().max()),
            batch2_logits_rel_err=err[0],
            err_over_limit=err[2], tolerance=ZOO_F32_TOL, losses=losses,
            step_wall_ms=walls, **prof,
            peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
            nvidia_smi=smi)
        if not err[3] or not all(np.isfinite(losses)):
            raise RuntimeError(f"{name}: logits against the CPU {err}, "
                               f"losses {losses}")
        del model, cpu, opt
        torch.cuda.empty_cache()


# ------------------------------------------------------------- gpt_6_7b --
def gpt_6_7b_phase(dev, smi, batch=2, seq=2048):
    """``gpt_6_7b`` (hidden 4096, 32 layers of 32 heads, vocab 50304)
    built in bf16 on the card from a seed (~13.4 GB of weights), then an
    eval forward over ``batch`` x ``seq`` tokens: B4a at 4096 x 4096 on
    every LayerNorm (2 a layer and the final), B2 causal at D 128 once a
    layer.  The logits must be finite; device ms of the forward by CUDA
    events, peak memory.  Counted alone; returns its launches."""
    import torch

    from paddle_tpu_torch.models.gpt import gpt_6_7b
    from paddle_tpu_torch.ops.cuda import registry

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = gpt_6_7b(device=dev, seed=0, dtype=torch.bfloat16).eval()
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    ids = torch.as_tensor(np.random.RandomState(13).randint(
        0, model.config.vocab_size, (batch, seq)), device=dev)
    with torch.no_grad():
        model(ids)                                 # first call: warm-up
        registry.reset_counts()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits = model(ids)
        b.record()
        b.synchronize()
    counts = _counts(registry)
    layers = model.config.num_layers
    want = {"layernorm_fwd": 2 * layers + 1, "layernorm_bwd": 0,
            "flash_attention_fwd": layers, "flash_attention_bwd": 0}
    finite = bool(torch.isfinite(logits).all())
    say("gpt_6_7b_forward", tokens=[batch, seq], weights_bytes=weights,
        build_s=build_s, forward_device_ms=a.elapsed_time(b),
        launches=counts, logits=list(logits.shape), finite=finite,
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
        nvidia_smi=smi)
    if counts != want or not finite:
        raise RuntimeError(f"gpt_6_7b forward: launches {counts} != {want} "
                           f"or logits not finite ({finite})")
    del model, logits
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------ training features --
# GPT-124M at bench.py's training width (12 layers, hidden 768, 12 heads,
# 8 x 1024 tokens).  Dropout stays on in the residual paths (0.1, drawn
# from the model's generator, which remat must restore); attention
# dropout is 0, as bench.py sets it, so attention takes the flash
# kernels (any dropout sends it to the plain composition).
FEATURE_STEPS = 5
FP16_STEPS = 10
FEATURE_DROPOUT = 0.1
FEATURE_RTOL = 1e-5        # remat against no remat, losses and parameters
FP16_LOSS_RTOL = 1e-2      # the first fp16 step's loss against f32's
# At initialisation GPT's loss is ~ln(50304) whatever the blocks compute,
# so the first fp16 step is held by its unscaled gradients too: each
# within FP16_GRAD_RTOL of the f32 gradient's norm plus FP16_GRAD_FLOOR
# of the largest one's (the bf16 steps' bounds; float16 keeps three more
# mantissa bits than bf16)
FP16_GRAD_RTOL = BF16_GRAD_RTOL
FP16_GRAD_FLOOR = VISION_GRAD_FLOOR
PROFILED_STEPS = 3
SPARSE_GRID = (41, 1600, 1408)   # SECOND / Paddle3D KITTI voxelisation
SPARSE_BATCH = 2
SPARSE_VOXELS = (16000, 20000)   # active voxels a sample
SPARSE_SEED = 0
SPARSE_TOL = 1e-4


def _feature_model(dev, dtype):
    """GPT-124M (seed 0) with residual dropout on, under
    ``amp.decorate(level="O2", dtype=dtype)`` unless ``dtype`` is
    None (f32)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import gpt_124m

    model = gpt_124m(device=dev, seed=0, hidden_dropout_prob=FEATURE_DROPOUT,
                     attention_probs_dropout_prob=0.0)
    if dtype is not None:
        model = amp.decorate(model, level="O2", dtype=dtype)
    return model


def _feature_batches(vocab, n, dev, batch=8, seq=1024, seed=2025):
    import torch

    rng = np.random.RandomState(seed)
    return [tuple(torch.as_tensor(rng.randint(0, vocab, (batch, seq)),
                                  device=dev) for _ in range(2))
            for _ in range(n)]


def _feature_step(model, remat=False, scaler=None):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep

    opt = optimizer.AdamW(learning_rate=TRAIN_LR,
                          parameters=model.parameters(),
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0))
    return TrainStep(model, lambda logits, labels: model.loss(logits, labels),
                     opt, remat=remat, scaler=scaler)


def _timed_steps(step, batches, dev, each=None):
    """Run ``step`` over ``batches`` but the last with the kernel counts
    at 0 just before and read just after, then the last under
    torch.profiler (the card's activity alone) -> (losses, stream ms a
    step between CUDA events around the run, wall ms a step, kernel
    launches a step, the counts of the run, ``_device_profile`` of the
    profiled step: device ms and busy share); ``each(i)``, if given,
    runs after timed step i."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops.cuda import registry

    *batches, last = batches

    torch.cuda.synchronize(dev)
    registry.reset_counts()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    a.record()
    losses = []
    for i, (ids, labels) in enumerate(batches):
        losses.append(step(ids, labels))
        if each is not None:
            each(i)
    b.record()
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) / len(batches) * 1e3
    counts = {k: registry.counts()[k] for k in _TRAIN_KERNELS}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(*last)
        torch.cuda.synchronize(dev)
    return ([x.item() for x in losses], a.elapsed_time(b) / len(batches),
            wall, {k: v / len(batches) for k, v in counts.items()}, counts,
            _device_profile(prof, 1, wall))


def _profiled_feature_steps(step, batches, dev, layers):
    """``PROFILED_STEPS`` steps under ``profiler.Profiler(targets=[CPU,
    GPU])``: its summary's operator calls (one kernel launch each) must
    equal the launch plan and its CUDA kernel records may not exceed it;
    the records missing are printed (ROADMAP C12: CUPTI can miss the
    kernels of a window's first milliseconds).  The chrome trace goes to
    chiprun_out/."""
    import torch

    from paddle_tpu_torch import profiler

    with profiler.Profiler(targets=[profiler.ProfilerTarget.CPU,
                                    profiler.ProfilerTarget.GPU]) as prof:
        for ids, labels in batches[:PROFILED_STEPS]:
            step(ids, labels)
        torch.cuda.synchronize(dev)
    stats = prof.op_stats()
    n, lns = PROFILED_STEPS, 2 * layers + 1

    def calls(part):
        return sum(c for k, (c, _, _) in stats.items() if part in k)

    want = {"paddle_tpu_torch::flash_attention_fwd": layers * n,
            "paddle_tpu_torch::flash_attention_bwd": layers * n,
            "paddle_tpu_torch::layernorm_fwd": lns * n,
            "paddle_tpu_torch::layernorm_bwd": lns * n,
            "flash_fwd_tc": layers * n, "flash_dq_tc": layers * n,
            "flash_dkv_tc": layers * n, "ln_fwd_kernel": lns * n,
            "ln_bwd_kernel": lns * n, "ln_reduce_kernel": lns * n}
    got = {k: (stats[k][0] if "::" in k and k in stats else calls(k))
           for k in want}
    ops = {k: v for k, v in got.items() if "::" in k}
    missing = {k: want[k] - v for k, v in got.items() if "::" not in k}
    table = prof.summary(time_unit="ms")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    trace = prof.export(os.path.join(ROOT, "chiprun_out",
                                     "train_features_trace.json"))
    say("profiler", steps=n, calls=got, expected=want,
        kernel_records_missing=missing, summary_lines=len(table.splitlines()),
        trace_bytes=os.path.getsize(trace),
        kernel_device_ms_per_step=sum(
            d for k, (_, _, d) in stats.items()
            if any(part in k for part in want if "::" not in part)) / n)
    if (ops != {k: v for k, v in want.items() if "::" in k}
            or min(missing.values()) < 0):
        raise RuntimeError(f"profiler calls {got} != the launch plan {want}")


def remat_phase(dev, smi):
    """GPT-124M in O2 bf16 with residual dropout: a warm-up step, then
    FEATURE_STEPS TrainSteps with ``remat=False``, then the same with
    ``remat=True`` from the same weights, generator seed and batches.  Losses and updated parameters
    must agree within FEATURE_RTOL (printed: whether bitwise); under remat
    B2 and B4a launch twice a step.  Three more steps of the first model
    run under the port's profiler.  Returns the launches of both runs."""
    import torch

    from paddle_tpu_torch.framework import memory

    runs, total = {}, {k: 0 for k in _TRAIN_KERNELS}
    layers = 12
    for remat in (False, True):
        model = _feature_model(dev, "bfloat16")
        step = _feature_step(model, remat=remat)
        batches = _feature_batches(model.config.vocab_size,
                                   2 + FEATURE_STEPS + PROFILED_STEPS, dev)
        step(*batches.pop(0))        # warm-up, in both runs alike
        memory.reset_peak_memory_stats(dev.index)
        losses, stream_ms, wall_ms, per_step, counts, device = _timed_steps(
            step, batches[:FEATURE_STEPS + 1], dev)
        peak = memory.max_memory_allocated(dev.index)
        if peak != torch.cuda.max_memory_allocated(dev):
            raise RuntimeError("framework.memory's peak differs from "
                               "torch.cuda.max_memory_allocated")
        want = _expected_train_launches(layers, 1)
        if remat:
            want["flash_attention_fwd"] *= 2
            want["layernorm_fwd"] *= 2
        say("remat", remat=remat, model="gpt_124m", dtype="bfloat16 (O2)",
            dropout=f"residual {FEATURE_DROPOUT}, attention 0", batch=8,
            seq=1024, steps=FEATURE_STEPS, losses=losses,
            stream_ms_per_step=stream_ms, wall_ms_per_step=wall_ms,
            profiled_step=device, max_memory_allocated=peak,
            launches_per_step=per_step, expected_per_step=want,
            nvidia_smi=smi)
        if per_step != want:
            raise RuntimeError(f"remat={remat}: launches a step {per_step} "
                               f"!= {want}")
        for k in total:
            total[k] += counts[k]
        runs[remat] = (losses, {n: p.detach().clone()
                                for n, p in model.named_parameters()})
        if not remat:
            _profiled_feature_steps(step, batches[FEATURE_STEPS + 1:], dev,
                                    layers)
        del model, step
        torch.cuda.empty_cache()
    (la, pa), (lb, pb) = runs[False], runs[True]
    loss_rel = max(abs(x - y) / abs(x) for x, y in zip(la, lb))
    param_rel = max(float((pb[n].float() - p.float()).norm()
                          / max(float(p.float().norm()), 1e-30))
                    for n, p in pa.items())
    bitwise = la == lb and all(torch.equal(p, pb[n]) for n, p in pa.items())
    say("remat_against_no_remat", max_loss_rel_err=loss_rel,
        max_param_rel_l2_err=param_rel, rtol=FEATURE_RTOL, bitwise=bitwise)
    if not (loss_rel <= FEATURE_RTOL and param_rel <= FEATURE_RTOL
            and np.isfinite(la).all()):
        raise RuntimeError("remat's training diverged from remat=False")
    return total


def _scaler_replay(flags, scale=65536.0, incr=2.0, decr=0.5,
                   incr_every=2000, decr_every=1):
    """The JAX package's dynamic-scale rule replayed on the host from the
    found_inf flags -> the state after each step."""
    good = bad = 0
    out = []
    for found in flags:
        if found:
            bad, good = bad + 1, 0
            if bad >= decr_every:
                scale, bad = max(scale * decr, 1.0), 0
        else:
            good, bad = good + 1, 0
            if good >= incr_every:
                scale, good = scale * incr, 0
        out.append({"scale": scale, "good_steps": good, "bad_steps": bad})
    return out


def _inject_inf(model):
    """A forward hook that puts an inf into the embeddings' output (the
    blocks' input) -> its handle."""
    def hook(module, args, out):
        out = out.clone()
        out[0, 0, 0] = float("inf")
        return out
    return model.gpt.embeddings.register_forward_hook(hook)


def fp16_phase(dev, smi):
    """GPT-124M under ``decorate(level="O2", dtype="float16")`` with
    ``GradScaler()`` at its defaults: a first TrainStep whose loss and
    unscaled gradients (the scaler's f32 copies) are held to the f32
    model's on the same weights, draws and batch, the loss within
    FP16_LOSS_RTOL and each gradient by FP16_GRAD_RTOL and
    FP16_GRAD_FLOOR; then FP16_STEPS timed TrainSteps, with the scale
    and found_inf of every step kept on the card during the run, read
    after it and held to a host replay of the JAX rule from those flags;
    then a step on an input holding inf, which must keep the parameters
    and the optimizer state bitwise and halve the scale; then
    ``amp.debugging``'s tensor checker on a step with the same inf, which
    must name the op.  Returns the timed steps' launches."""
    import torch

    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.amp import debugging

    batches = _feature_batches(50304, FP16_STEPS + 2, dev, seed=2026)
    ref = _feature_model(dev, None)
    f32_loss = ref.loss(ref(batches[0][0]), batches[0][1])
    f32_loss.backward()
    f32_loss = f32_loss.item()
    f32_grads = {n: p.grad for n, p in ref.named_parameters()}
    del ref
    torch.cuda.empty_cache()
    model = _feature_model(dev, "float16")
    if {p.dtype for p in model.parameters()} != {torch.float16}:
        raise RuntimeError("O2 float16 left a parameter in another dtype")
    scaler = amp.GradScaler()
    step = _feature_step(model, scaler=scaler)

    # the first step, untimed: its unscaled gradients as scaler_apply
    # returns them (cloned: the clip and the update follow)
    first = []
    apply = amp.scaler_apply

    def keep_grads(*args):
        out = apply(*args)
        first.extend(g.clone() for g in out[0])
        return out

    amp.scaler_apply = keep_grads
    try:
        first_loss = step(*batches[0]).item()
    finally:
        amp.scaler_apply = apply
    name_of = {id(p): n for n, p in model.named_parameters()}
    grads = {name_of[id(p)]: g
             for p, g in zip(step.optimizer._grads()[1], first)}
    top = max(float(g.norm()) for g in f32_grads.values())
    over = {n: float((grads[n] - g).norm())
            / (FP16_GRAD_RTOL * float(g.norm()) + FP16_GRAD_FLOOR * top)
            for n, g in f32_grads.items()}
    worst = max(over, key=lambda n: over[n] if np.isfinite(over[n])
                else np.inf)
    first_rel = abs(first_loss - f32_loss) / abs(f32_loss)
    first_flag = bool(step.found_inf)
    say("fp16_first_step", f32_loss=f32_loss, fp16_loss=first_loss,
        loss_rel_err=first_rel, loss_rtol=FP16_LOSS_RTOL,
        found_inf=first_flag, grads_compared=len(grads),
        grad_rtol=FP16_GRAD_RTOL, grad_floor=FP16_GRAD_FLOOR,
        worst_grad=worst, worst_grad_over_limit=over[worst],
        worst_grad_rel_l2_err=float((grads[worst] - f32_grads[worst]).norm()
                                    / f32_grads[worst].norm()))
    if first_flag or set(grads) != set(f32_grads) or not over[worst] <= 1.0:
        raise RuntimeError(f"fp16 first-step gradients (found_inf "
                           f"{first_flag}): {worst} at {over[worst]} of "
                           f"the limit")
    if first_rel > FP16_LOSS_RTOL:
        raise RuntimeError(f"fp16 first loss {first_loss} vs f32 {f32_loss}")
    del f32_grads, grads, first
    # the scaler epilogue's host time: the fused unscale + check launches,
    # the one flag read (the host waits for the backward there), and the
    # optimizer's launches after it
    parts = {"epilogue_ms": 0.0}
    inner = jit.scaler_guarded_update

    def timed(*args):
        t0 = time.perf_counter()
        try:
            return inner(*args)
        finally:
            parts["epilogue_ms"] += (time.perf_counter() - t0) * 1e3

    # each step's flag and state stay on the card until the run is over:
    # reading them between steps would add host syncs the bf16 runs lack
    on_card = [(step.found_inf, scaler._compiled_state)]

    def keep(i):
        on_card.append((step.found_inf, scaler._compiled_state))

    jit.scaler_guarded_update = timed
    try:
        losses, stream_ms, wall_ms, per_step, counts, device = _timed_steps(
            step, batches[1:], dev, each=keep)
    finally:
        jit.scaler_guarded_update = inner
    flags = [bool(f) for f, _ in on_card]
    states = [{"scale": float(st["scale"]), "good_steps": int(st["good"]),
               "bad_steps": int(st["bad"])} for _, st in on_card]
    replay = _scaler_replay(flags)
    want = _expected_train_launches(12, 1)
    say("fp16", model="gpt_124m", dtype="float16 (O2)",
        scaler="GradScaler() defaults", steps=FP16_STEPS,
        first_loss=first_loss, losses=losses, found_inf=flags,
        scale=[st["scale"] for st in states],
        states_match_replay=states == replay, stream_ms_per_step=stream_ms,
        wall_ms_per_step=wall_ms, profiled_step=device,
        epilogue_host_ms_per_step=parts["epilogue_ms"] / (FP16_STEPS + 1),
        launches_per_step=per_step, expected_per_step=want,
        layernorm_dtype="float16 (the raw path applies no AMP list)",
        nvidia_smi=smi)
    if states != replay:
        raise RuntimeError(f"scale trajectory {states} != replay {replay}")
    if per_step != want:
        raise RuntimeError(f"fp16 launches a step {per_step} != {want}")
    # the inf step: nothing moves but the scale
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = step.optimizer
    state = {i: {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                 for k, v in st.items()}
             for i, st in opt._accumulators.items()}
    scale0 = scaler.get_scale()
    handle = _inject_inf(model)
    try:
        step(*batches[0])
    finally:
        handle.remove()
    kept = (all(torch.equal(p, before[n])
                for n, p in model.named_parameters())
            and all(torch.equal(v, opt._accumulators[i][k])
                    if isinstance(v, torch.Tensor)
                    else v == opt._accumulators[i][k]
                    for i, st in state.items() for k, v in st.items()))
    say("fp16_inf_step", found_inf=bool(step.found_inf),
        params_and_state_bitwise=kept, scale_before=scale0,
        scale_after=scaler.get_scale())
    if not (bool(step.found_inf) and kept
            and scaler.get_scale() == max(scale0 * 0.5, 1.0)):
        raise RuntimeError("the inf step was not skipped as the rule says")
    # amp.debugging: the checker names the op the inf first reaches
    handle = _inject_inf(model)
    debugging.enable_tensor_checker(debugging.TensorCheckerConfig(
        enable=True))
    caught = None
    try:
        step(*batches[0])
    except FloatingPointError as e:
        caught = str(e)
    finally:
        debugging.disable_tensor_checker()
        handle.remove()
    say("debugging", checker_message=caught)
    if not caught or "op '" not in caught:
        raise RuntimeError("the tensor checker missed the injected inf")
    del model, step, before, state
    torch.cuda.empty_cache()
    return counts


def _kitti_voxels(seed):
    """Active voxels of ``batch`` point-cloud samples at KITTI's grid:
    random-walk surfaces (60-step walks of unit moves from uniform
    starts, so voxels have neighbours as a LiDAR scan's do), 16,000 to
    20,000 distinct voxels a sample -> [N, 4] (batch, z, y, x), sorted."""
    rng = np.random.RandomState(seed)
    hi = np.asarray(SPARSE_GRID) - 1
    out = []
    for b in range(SPARSE_BATCH):
        want = rng.randint(SPARSE_VOXELS[0], SPARSE_VOXELS[1] + 1)
        cells = np.zeros((0, 3), np.int64)
        while len(cells) < want:
            starts = rng.randint(0, hi + 1, (want // 30, 3))
            walk = starts[:, None] + np.cumsum(rng.randint(-1, 2, (
                len(starts), 60, 3)), 1)
            cells = np.unique(np.concatenate(
                [cells, np.clip(walk.reshape(-1, 3), 0, hi)]), axis=0)
        keep = np.sort(rng.choice(len(cells), want, replace=False))
        out.append(np.concatenate([np.full((want, 1), b), cells[keep]], 1))
    return np.concatenate(out)


def _sparse_stage(paddle, coords, feats, weights):
    """SubmConv3D(4->16, 3) -> SubmConv3D(16->16, 3) -> Conv3D(16->32, 3,
    stride 2) -> MaxPool3D(2), ReLU between, forward and backward of the
    pooled values' sum of squares -> (output coords, values, the
    gradients of the input values and of every weight and bias, the
    layers)."""
    from paddle_tpu_torch import sparse

    layers = [sparse.nn.SubmConv3D(4, 16, 3, padding=1),
              sparse.nn.SubmConv3D(16, 16, 3, padding=1),
              sparse.nn.Conv3D(16, 32, 3, stride=2, padding=1)]
    for layer, sd in zip(layers, weights):
        layer.set_state_dict(sd)
    vals = paddle.to_tensor(feats, stop_gradient=False)
    x = sparse.sparse_coo_tensor(coords.T, vals,
                                 (SPARSE_BATCH, *SPARSE_GRID, 4))
    for layer in layers:
        x = sparse.relu(layer(x))
    out = sparse.nn.MaxPool3D(2)(x)
    (out.values() ** 2).sum().backward()
    grads = {"input": vals.grad._data}
    for i, layer in enumerate(layers):
        grads[f"l{i}.weight"] = layer.weight.grad._data
        grads[f"l{i}.bias"] = layer.bias.grad._data
    return out._idx, out.values()._data, grads


def sparse_phase(dev, smi):
    """A SECOND-style sparse middle stage at KITTI's voxel grid (41 x 1600
    x 1408, batch 2, 16,000-20,000 active voxels a sample, 4 channels,
    from SPARSE_SEED) on the card in f32, forward and backward, against
    the port's CPU path on the same coordinates and weights (SPARSE_TOL,
    ``_parity``'s f32 rule).  The rulebooks are built on the host (numpy)
    and timed apart from the device work (torch.profiler's kernel time,
    one profiled run after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.sparse import conv as pconv

    coords = _kitti_voxels(SPARSE_SEED)
    rng = np.random.RandomState(SPARSE_SEED + 1)
    feats = rng.randn(len(coords), 4).astype(np.float32)
    weights = [{"weight": (rng.randn(27, cin, cout)
                           * np.sqrt(2.0 / (27 * cin))).astype(np.float32),
                "bias": (0.1 * rng.randn(cout)).astype(np.float32)}
               for cin, cout in ((4, 16), (16, 16), (16, 32))]
    host = {"s": 0.0}
    wrapped = {}
    for name in ("_rulebook", "_pool_rulebook"):
        fn = getattr(pconv, name)

        def timed(*a, _fn=fn):
            t0 = time.perf_counter()
            try:
                return _fn(*a)
            finally:
                host["s"] += time.perf_counter() - t0
        wrapped[name] = fn
        setattr(pconv, name, timed)
    try:
        paddle.set_device("gpu")
        _sparse_stage(paddle, coords, feats, weights)     # warm-up
        torch.cuda.synchronize(dev)
        host["s"] = 0.0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            got = _sparse_stage(paddle, coords, feats, weights)
            torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
        host_ms = host["s"] * 1e3
        paddle.set_device("cpu")
        t0 = time.perf_counter()
        want = _sparse_stage(paddle, coords, feats, weights)
        cpu_s = time.perf_counter() - t0
    finally:
        paddle.set_device("gpu")
        for name, fn in wrapped.items():
            setattr(pconv, name, fn)
    same_coords = np.array_equal(got[0], want[0])
    report = {"values": _parity(got[1], want[1].to(dev), SPARSE_TOL)}
    report.update({k: _parity(g, want[2][k].to(dev), SPARSE_TOL)
                   for k, g in got[2].items()})
    per_sample = np.bincount(coords[:, 0]).tolist()
    say("sparse", grid=list(SPARSE_GRID), batch=SPARSE_BATCH,
        voxels_per_sample=per_sample, out_sites=int(len(got[0])),
        stage="SubmConv3D(4,16,3) SubmConv3D(16,16,3) Conv3D(16,32,3,s2) "
              "MaxPool3D(2), f32, forward+backward",
        host_rulebook_ms=host_ms, host_share=host_ms / wall_ms,
        cpu_port_s=cpu_s, **_device_profile(prof, 1, wall_ms),
        coords_equal_cpu=same_coords,
        max_abs_err={k: r[0] for k, r in report.items()},
        err_over_limit={k: r[2] for k, r in report.items()},
        nvidia_smi=smi)
    if not (same_coords and all(r[3] for r in report.values())):
        raise RuntimeError(f"sparse stage differs from the CPU port: "
                           f"{report}")


def train_features_phases(dev, smi):
    """The training features: remat (with the profiler), fp16 (with the
    tensor checker), the sparse stage -> the kernels' launches of the
    GPT runs, each counted alone."""
    import torch

    launches = remat_phase(dev, smi)
    torch.cuda.empty_cache()
    for k, n in fp16_phase(dev, smi).items():
        launches[k] += n
    torch.cuda.empty_cache()
    sparse_phase(dev, smi)
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- deploy --
DEPLOY_SEED = 19
DEPLOY_PROMPT, DEPLOY_NEW, DEPLOY_REQUESTS = 128, 32, 8
DEPLOY_C_CLIENT = 3          # the request the native C client sends
FP16_ENGINE = dict(block_size=16, max_batch=8, token_budget=256)
# the ir_passes step against the same composition without passes, both
# bf16 on the card: the passes compute attention in the flash kernels'
# f32 and LayerNorm statistics in f32 where the plain composition rounds
# every intermediate to bf16 (2^-9).  Read on an H100: the rewritten
# step 0.0184 off in loss and 0.0288 in its worst gradient, the
# unmasked control 0.252 and 0.936; each limit lies between the two
IR_LOSS_RTOL = 6e-2
IR_GRAD_RTOL = 1e-1
IR_LAYERS, IR_HIDDEN, IR_HEADS, IR_BATCH, IR_SEQ = 12, 768, 12, 8, 1024
IR_STEPS = 3
PREDICTOR_BATCH, PREDICTOR_RUNS = 64, 3
# the f16 predictor's largest |error| over max |f32 forward|: read on
# an H100 0.0010, the tail-dropped control 0.128
PREDICTOR_RTOL = 4e-3
C12_CALLS = 16
C12_CONTROL_AGE_S = 536      # the full run's age at its C12 windows


def fp16_kernel_phase(dev):
    """The float16 instances of B1, B5 and B6 (C11) at their PERF.md §6
    shapes against the plain versions in f32 on the same values, under
    the strict rule (``_parity``), padding / empty rows exact zeros,
    bitwise repeatable; each timed against its bound, B6 also against
    ``F.scaled_dot_product_attention``."""
    import torch

    from paddle_tpu_torch.ops.cuda import registry

    f16 = torch.float16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def row(entry, label, args, plain_args, zero, lib=None):
        got = entry.kernel(*args)
        again = entry.kernel(*args)
        torch.cuda.synchronize()
        report = {"out": _parity(got, entry.plain(*plain_args), 1e-4)}
        zero_ok = bool((got[zero] == 0).all())
        repeat = torch.equal(got, again)
        _say_parity(entry.name, label, got.dtype, report,
                    zero_rows_exact_zero=zero_ok, bitwise_repeatable=repeat)
        if not (report["out"][3] and zero_ok and repeat):
            raise RuntimeError(f"{entry.name} {label} f16: {report}, zero "
                               f"{zero_ok}, repeatable {repeat}")
        ms = time_ms(lambda: entry.kernel(*args), flush)
        plain_ms = time_ms(lambda: entry.plain(*args), flush)
        bound_ms, bound_by = _bound(entry, *args)
        lib_ms = time_ms(lib, flush) if lib is not None else None
        say("kernel_time", kernel=entry.name, shape=f"{label} f16",
            kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms)

    b1 = registry.KERNELS["paged_ragged_attention"]
    b5 = registry.KERNELS["paged_ragged_attention_quant"]
    b6 = registry.KERNELS["decode_attention"]
    pos = np.random.RandomState(3).randint(600, 1000, size=8)
    shapes = {
        "gpt124m_mixed_T256": (256, _full_width_tables(1),
                               [0, 1, 201, 205, 205, 205, 205, 205],
                               [1, 200, 4, 0, 0, 0, 0, 0],
                               [900, 37, 500, 0, 0, 0, 0, 0], 2),
        "gpt124m_decode_T8": (8, _full_width_tables(4), list(range(8)),
                              [1] * 8, pos, 5)}
    for label, (t, bt, rs, rq, rp, seed) in shapes.items():
        args = _ragged_case(dev, f16, 512, 16, 12, 12, 64, t, bt, rs, rq,
                            rp, seed=seed)
        q, kp, vp = args[:3]
        pad = ~_live_tokens(t, args[4], args[5], dev)
        row(b1, label, args, (q.float(), kp.float(), vp.float(), *args[3:]),
            pad)
        base = _ragged_case(dev, torch.float32, 512, 16, 12, 12, 64, t, bt,
                            rs, rq, rp, seed=seed)
        qargs = _quantized(base, f16)
        row(b5, label + " int8 pools", qargs,
            (qargs[0].float(), *qargs[1:]), pad)
    for label, (b, nq, nkv, d, s), lens, seed in (
            ("gpt124m_fmt", (8, 12, 12, 64, 1024),
             _full_lengths(20, 8, 1024), 20),
            ("fmt_main_path", (8, 12, 12, 64, 192),
             np.random.RandomState(25).randint(128, 193, 8), 25)):
        args = q, k, v, lens_t = _decode_case(dev, f16, b, nq, nkv, d, s,
                                             lens, seed)
        mask = (torch.arange(s, device=dev)[None, :]
                < lens_t[:, None])[:, None, None, :]

        def sdpa(q=q, k=k, v=v, mask=mask):
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        row(b6, label, args, (q.float(), k.float(), v.float(), lens_t),
            lens_t <= 0, lib=sdpa)


def _native_client():
    import ctypes

    from paddle_tpu_torch.core import native

    lib = native.load()
    if lib is None:
        raise RuntimeError("the native C client did not build")
    lib.pd_infer_connect.restype = ctypes.c_void_p
    lib.pd_infer_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int]
    lib.pd_infer_close.argtypes = [ctypes.c_void_p]
    lib.pd_infer_add_input.restype = ctypes.c_int
    lib.pd_infer_add_input.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_void_p]
    lib.pd_infer_run.restype = ctypes.c_int
    lib.pd_infer_run.argtypes = [ctypes.c_void_p]
    lib.pd_infer_output_dims.restype = ctypes.c_int
    lib.pd_infer_output_dims.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64)]
    lib.pd_infer_output_data.restype = ctypes.c_int
    lib.pd_infer_output_data.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
    return lib


def _c_generate(lib, port, ids, new):
    """One generative request through the native C client (pd_infer_*):
    the token ids as int64 [T] and max_new_tokens as an int64 scalar."""
    import ctypes

    h = lib.pd_infer_connect(b"127.0.0.1", port, 120000)
    if not h:
        raise RuntimeError("pd_infer_connect failed")
    try:
        ids = np.ascontiguousarray(ids, np.int64)
        n = np.asarray(new, np.int64)
        if lib.pd_infer_add_input(h, 3, (ctypes.c_int64 * 1)(ids.size), 1,
                                  ids.ctypes.data_as(ctypes.c_void_p)) or \
                lib.pd_infer_add_input(h, 3, (ctypes.c_int64 * 1)(), 0,
                                       n.ctypes.data_as(ctypes.c_void_p)):
            raise RuntimeError("pd_infer_add_input failed")
        if lib.pd_infer_run(h) != 0:
            raise RuntimeError("pd_infer_run failed")
        dtype, dims = ctypes.c_int(), (ctypes.c_int64 * 8)()
        nd = lib.pd_infer_output_dims(h, 0, ctypes.byref(dtype), dims)
        out = np.empty(tuple(dims[:nd]), np.int64)
        if dtype.value != 3 or lib.pd_infer_output_data(
                h, 0, out.ctypes.data_as(ctypes.c_void_p), out.nbytes):
            raise RuntimeError("pd_infer_output_data failed")
        return out
    finally:
        lib.pd_infer_close(h)


def _py_generate(port, ids, new):
    import socket
    import struct

    from paddle_tpu_torch.inference.serving import (_recv_exact,
                                                    _recv_tensor,
                                                    _send_tensor)

    s = socket.create_connection(("127.0.0.1", port), timeout=300)
    try:
        s.sendall(struct.pack("<I", 2))
        _send_tensor(s, np.asarray(ids, np.int64))
        _send_tensor(s, np.asarray(new, np.int64))
        status, n_out = struct.unpack("<BI", _recv_exact(s, 5))
        if status != 0:
            raise RuntimeError(f"server status {status}")
        return [_recv_tensor(s) for _ in range(n_out)][0]
    finally:
        s.close()


def _served_in_order(eng, srv, prompts, new):
    """The requests through ``srv`` from a thread each, request
    ``DEPLOY_C_CLIENT`` through the native C client, the rest through
    Python wire clients.  Client i submits once i requests are queued and
    the engine's first step waits for all of them, so the server runs
    the schedule ``generate`` runs on the same engine (submission order
    is arrival order); the connections are all open at once and answer
    concurrently."""
    import threading

    lib = _native_client()
    added, cond = [0], threading.Condition()
    add, step = eng.add_request, eng.step

    def counted_add(*a, **k):
        rid = add(*a, **k)
        with cond:
            added[0] += 1
            cond.notify_all()
        return rid

    def gated_step():
        with cond:
            cond.wait_for(lambda: added[0] >= len(prompts), timeout=120)
        return step()

    eng.add_request, eng.step = counted_add, gated_step
    outs, errs = [None] * len(prompts), []

    def client(i):
        try:
            with cond:
                cond.wait_for(lambda: added[0] >= i, timeout=120)
            call = (lambda p, ids, n: _c_generate(lib, p, ids, n)) \
                if i == DEPLOY_C_CLIENT else _py_generate
            outs[i] = call(srv.port, prompts[i], new)
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        del eng.add_request, eng.step
    if errs or any(o is None for o in outs):
        raise RuntimeError(f"served requests failed: {errs}")
    return outs


def fp16_serving_phase(dev, smi):
    """GPT-124M, ``LLMEngine(dtype="float16")`` behind ``PredictorServer``
    on 127.0.0.1: 8 greedy requests (prompt 128, 32 new, from
    ``DEPLOY_SEED``), 7 from Python wire clients in threads and one from
    the native C client; the tokens must equal the same engine's direct
    ``generate`` and B1 must launch on every layer of every engine
    launch (the main path: counts at 0 just before, read just after).
    The f16 engine's teacher-forced logits against the f32 engine's on
    the same weights (largest and rms |error|).  Then 4 requests through
    the f16 engine with the int8 KV pool (B5 with f16 q).  Returns
    {kernel: launches}."""
    import torch

    from paddle_tpu_torch.inference import PredictorServer
    from paddle_tpu_torch.inference.llm import LLMEngine, quality
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.ops.cuda import registry

    model = gpt_124m(device=dev, seed=0).eval()
    rng = np.random.RandomState(DEPLOY_SEED)
    prompts = [rng.randint(0, 50257, DEPLOY_PROMPT)
               for _ in range(DEPLOY_REQUESTS)]
    eng = LLMEngine(model, dtype="float16", device=dev, **FP16_ENGINE)
    eng.warmup()
    direct = eng.generate(prompts, max_new_tokens=DEPLOY_NEW)
    srv = PredictorServer(engine=eng, host="127.0.0.1")
    try:
        registry.reset_counts()
        steps0 = eng.stats["launches"]
        t0 = time.perf_counter()
        served = _served_in_order(eng, srv, prompts, DEPLOY_NEW)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        b1 = registry.counts()["paged_ragged_attention"]
        plan = eng.num_layers * (eng.stats["launches"] - steps0)
    finally:
        srv.stop()
    equal = [bool(np.array_equal(np.asarray(s).reshape(-1),
                                 np.asarray(d))) for s, d in zip(served,
                                                                 direct)]
    # teacher-forced logits of request 0's prompt and completion
    eng32 = LLMEngine(model, dtype="float32", device=dev, **FP16_ENGINE)
    seq = np.asarray(direct[0])
    l16 = quality.engine_logits(eng, seq)
    l32 = quality.engine_logits(eng32, seq)
    err = np.abs(l16.astype(np.float64) - l32)
    del eng32
    say("fp16_serving", model="gpt_124m", dtype="float16", nvidia_smi=smi,
        requests=len(prompts), prompt_tokens=DEPLOY_PROMPT,
        new_tokens=DEPLOY_NEW, c_client_request=DEPLOY_C_CLIENT,
        tokens_equal_generate=equal, wall_s=wall,
        tokens_per_s=len(prompts) * DEPLOY_NEW / wall,
        kernel_launches=b1, expected_launches=plan,
        fp16_vs_fp32_logits_max_abs_err=float(err.max()),
        fp16_vs_fp32_logits_rms_err=float(np.sqrt((err ** 2).mean())),
        fp32_logits_max_abs=float(np.abs(l32).max()))
    if not all(equal):
        raise RuntimeError(f"served tokens differ from generate: {equal}")
    if b1 != plan:
        raise RuntimeError(f"f16 B1 launches {b1} != the plan {plan}")
    del eng
    torch.cuda.empty_cache()

    eng8 = LLMEngine(model, dtype="float16", device=dev,
                     quantize={"weights": False, "kv_cache": True},
                     **FP16_ENGINE)
    eng8.warmup()
    registry.reset_counts()
    steps0 = eng8.stats["launches"]
    outs = eng8.generate(prompts[:4], max_new_tokens=DEPLOY_NEW)
    torch.cuda.synchronize(dev)
    b5 = registry.counts()["paged_ragged_attention_quant"]
    plan8 = eng8.num_layers * (eng8.stats["launches"] - steps0)
    ok = all(len(o) == DEPLOY_PROMPT + DEPLOY_NEW and (
        (np.asarray(o) >= 0) & (np.asarray(o) < 50257)).all() for o in outs)
    say("fp16_serving_int8_kv", requests=4, kernel_launches=b5,
        expected_launches=plan8, outputs_in_range=ok)
    if b5 != plan8 or not ok:
        raise RuntimeError(f"f16 B5 launches {b5} != {plan8} or bad "
                           f"outputs")
    return {"paged_ragged_attention": b1,
            "paged_ragged_attention_quant": b5}


def fmt_fp16_phase(dev, batch=8, prompt=128, new=64):
    """``inference.get_fused_multi_transformer(gpt_124m, dtype=
    "float16")``: batch 8, prompt 128, 64 new greedy tokens, replayed as
    ``fmt_decode_phase`` does; B6 f16 on every layer of every decode
    step (the main path, counts at 0 just before).  Returns the B6
    count."""
    import torch

    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.ops.cuda import registry

    model = gpt_124m(device=dev, seed=0).eval()
    fmt = inference.get_fused_multi_transformer(
        model, max_length=prompt + new, dtype="float16", device=dev)
    del model
    ids = np.random.RandomState(78).randint(0, 50257, (batch, prompt))
    fmt.generate(ids[:, :8], max_new_tokens=4)          # warm-up
    registry.reset_counts()
    steps0 = fmt.decode_steps
    replays = fmt._graphs.replays
    t0 = time.perf_counter()
    out = fmt.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = registry.counts()["decode_attention"]
    steps = fmt.decode_steps - steps0
    want = fmt.num_layers * steps
    say("fmt_fp16", model="gpt_124m", dtype="float16", batch=batch,
        prompt_tokens=prompt, new_tokens=new, wall_s=wall,
        decode_steps=steps, tokens_per_s=batch * new / wall,
        kernel_launches=launches, expected_launches=want,
        graph_replays=fmt._graphs.replays - replays)
    if out.shape != (batch, prompt + new) or launches != want or \
            fmt._graphs.replays - replays != steps:
        raise RuntimeError(f"fmt_fp16: shape {out.shape}, launches "
                           f"{launches} != {want}, replays")
    return launches


def _ln_composition(x, w, b):
    """LayerNorm over the last dim, written out (what
    ``fuse_layernorm`` matches)."""
    import torch

    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * w + b


def _naive_gpt(dev, dtype, causal=True):
    """A GPT stack written as plain composition (the shape of the
    reference's ``test_causal_gpt_block_composes_with_zoo``, with the
    GPT MLP): hand-written LayerNorms and causal masked attention over
    ``torch.einsum`` / ``torch.softmax`` / ``torch.where``, as a Layer
    of ``IR_LAYERS`` blocks at GPT-124M width.  ``causal=False`` drops
    the mask (a wrong program, the ``ir_passes`` check's control)."""
    import math

    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.tensor import _wrap
    from paddle_tpu_torch.nn.layer_base import Parameter

    d, nh = IR_HIDDEN, IR_HEADS
    hd = d // nh
    rng = np.random.RandomState(DEPLOY_SEED)

    def param(*shape, scale=0.02, base=0.0):
        return Parameter(torch.as_tensor(
            base + scale * rng.randn(*shape).astype(np.float32),
            device=dev).to(dtype))

    class NaiveGPT(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            for i in range(IR_LAYERS):
                for n, shape, scale, base in (
                        ("g1", (d,), 0.1, 1.0), ("b1", (d,), 0.1, 0.0),
                        ("wq", (d, d), 0.02, 0.0), ("wk", (d, d), 0.02, 0.0),
                        ("wv", (d, d), 0.02, 0.0), ("wo", (d, d), 0.02, 0.0),
                        ("g2", (d,), 0.1, 1.0), ("b2", (d,), 0.1, 0.0),
                        ("w1", (d, 4 * d), 0.02, 0.0),
                        ("w2", (4 * d, d), 0.02, 0.0)):
                    setattr(self, f"{n}_{i}", param(*shape, scale=scale,
                                                    base=base))
            self.gf = param(d, scale=0.1, base=1.0)
            self.bf = param(d, scale=0.1)

        def forward(self, x):
            h = x._data
            bsz, t, _ = h.shape
            for i in range(IR_LAYERS):
                p = {n: getattr(self, f"{n}_{i}")._data for n in (
                    "g1", "b1", "wq", "wk", "wv", "wo", "g2", "b2", "w1",
                    "w2")}
                a = _ln_composition(h, p["g1"], p["b1"])

                def heads(w):
                    return (a @ w).reshape(bsz, t, nh, hd).transpose(1, 2)

                q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
                s = torch.einsum("bntd,bnsd->bnts", q, k) / math.sqrt(hd)
                if causal:
                    mask = torch.ones((t, t), dtype=torch.bool,
                                      device=h.device).tril()
                    s = torch.where(mask, s, torch.tensor(
                        -1e9, dtype=s.dtype, device=h.device))
                att = torch.einsum("bnts,bnsd->bntd", torch.softmax(s, -1),
                                   v)
                h = h + att.transpose(1, 2).reshape(bsz, t, d) @ p["wo"]
                m = _ln_composition(h, p["g2"], p["b2"])
                h = h + torch.nn.functional.gelu(m @ p["w1"]) @ p["w2"]
            return _wrap(_ln_composition(h, self.gf._data, self.bf._data))

    return NaiveGPT()


def ir_passes_phase(dev, smi):
    """The IR passes on the card.  (1) ``_naive_gpt`` in bf16 at 8 x
    1024 tokens under ``to_static(ir_passes=True)``: 3 forward and
    backward steps (the main path: counts at 0 just before) with the
    rewrites of each pass and B2/B3/B4a/B4b against the plan; the loss
    (the output's projection on a seeded random tensor, so it moves with
    every output value) and the first step's gradients against the same
    composition traced without passes (``IR_LOSS_RTOL``, ``IR_GRAD_RTOL``
    relative L2 per leaf), beside the same readings of a control, the
    composition without its causal mask, which must exceed both.  (2) the FMT-style masked decode composition (B 8, S_max
    1024, 12 heads, D 64, f16) over 12 layers through ``ir.optimize(...,
    ["decode_attention"])``: B6 f16 once a layer, its output held to the
    composition in f32 under the f16 rule.  Returns {kernel:
    launches}."""
    import math

    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import ir
    from paddle_tpu_torch.jit import to_static
    from paddle_tpu_torch.ops.cuda import registry

    bf16 = torch.bfloat16
    rng = np.random.RandomState(DEPLOY_SEED + 1)
    x = torch.as_tensor(rng.randn(IR_BATCH, IR_SEQ, IR_HIDDEN)
                        .astype(np.float32), device=dev).to(bf16)
    proj = torch.as_tensor(rng.randn(IR_BATCH, IR_SEQ, IR_HIDDEN)
                           .astype(np.float32), device=dev)

    def run(model, steps):
        losses, grads = [], None
        for _ in range(steps):
            for p in model.parameters():
                p.clear_gradient()
            out = model(paddle.to_tensor(x))._data.float()
            loss = (out * proj).sum(-1).mean()
            loss.backward()
            losses.append(float(loss.detach()))
            if grads is None:
                grads = [p.grad._data.float().clone()
                         for p in model.parameters()]
        return losses, grads

    plain = to_static(_naive_gpt(dev, bf16))
    ref_losses, ref_grads = run(plain, 1)
    del plain

    def off_ref(losses, grads):
        return (abs(losses[0] - ref_losses[0]) / abs(ref_losses[0]),
                [float((g - r).norm() / r.norm().clamp(min=1e-30))
                 for g, r in zip(grads, ref_grads)])

    control_loss, control_grads = off_ref(*run(
        to_static(_naive_gpt(dev, bf16, causal=False)), 1))
    torch.cuda.empty_cache()
    fused = to_static(_naive_gpt(dev, bf16), ir_passes=True)
    t0 = time.perf_counter()
    fused(paddle.to_tensor(x))                    # trace and rewrite
    trace_s = time.perf_counter() - t0
    gm = fused.forward.program(paddle.to_tensor(x))
    torch.cuda.synchronize(dev)
    registry.reset_counts()
    t0 = time.perf_counter()
    losses, grads = run(fused, IR_STEPS)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = registry.counts()
    lns = 2 * IR_LAYERS + 1
    want = {"flash_attention_fwd": IR_LAYERS * IR_STEPS,
            "flash_attention_bwd": IR_LAYERS * IR_STEPS,
            "layernorm_fwd": lns * IR_STEPS, "layernorm_bwd": lns * IR_STEPS}
    got = {k: counts[k] for k in want}
    loss_rel, grad_rel = off_ref(losses, grads)
    say("ir_passes", model="naive_gpt", layers=IR_LAYERS, hidden=IR_HIDDEN,
        heads=IR_HEADS, tokens=IR_BATCH * IR_SEQ, dtype="bfloat16",
        nvidia_smi=smi, rewrites_by_pass=gm.meta["rewrites_by_pass"],
        trace_and_rewrite_s=trace_s, steps=IR_STEPS,
        ms_per_step=wall / IR_STEPS * 1e3, losses=losses,
        plain_loss=ref_losses[0], loss_rel_err=loss_rel,
        loss_rtol=IR_LOSS_RTOL, grad_rel_l2_max=max(grad_rel),
        grad_rtol=IR_GRAD_RTOL, control_no_mask_loss_rel_err=control_loss,
        control_no_mask_grad_rel_l2_max=max(control_grads),
        control_no_mask_grad_rel_l2_min=min(control_grads),
        kernel_launches=got, expected=want)
    if gm.meta["rewrites_by_pass"]["fuse_attention"] != IR_LAYERS or \
            gm.meta["rewrites_by_pass"]["fuse_layernorm"] != lns:
        raise RuntimeError(f"ir rewrites {gm.meta['rewrites_by_pass']}")
    if got != want:
        raise RuntimeError(f"ir_passes launches {got} != {want}")
    if loss_rel > IR_LOSS_RTOL or max(grad_rel) > IR_GRAD_RTOL:
        raise RuntimeError(f"ir_passes loss {loss_rel} / grads "
                           f"{max(grad_rel)} off the plain composition")
    if control_loss <= IR_LOSS_RTOL or max(control_grads) <= IR_GRAD_RTOL:
        raise RuntimeError(f"ir_passes limits pass the unmasked control: "
                           f"loss {control_loss}, grads "
                           f"{max(control_grads)}")
    del fused, ref_grads, grads
    torch.cuda.empty_cache()

    # (2) masked decode through the decode_attention pass
    b, s_max, nh, hd, offset = 8, 1024, 12, 64, 700

    def masked_decode(q, ks, vs):
        outs = []
        for l in range(IR_LAYERS):
            logits = torch.einsum("bqnd,bknd->bnqk", q[l], ks[l]) * (
                1.0 / math.sqrt(hd))
            q_pos = offset + torch.arange(1, device=q.device)[:, None]
            k_pos = torch.arange(s_max, device=q.device)[None, :]
            mask = (k_pos <= q_pos)[None, None]
            logits = torch.where(mask, logits, torch.tensor(
                -1e30, dtype=logits.dtype, device=q.device))
            att = torch.softmax(logits.float(), -1).to(q.dtype)
            outs.append(torch.einsum("bnqk,bknd->bqnd", att, vs[l]))
        return torch.stack(outs)

    rng = np.random.RandomState(DEPLOY_SEED + 2)
    q, ks, vs = (torch.as_tensor(rng.randn(*shape).astype(np.float32),
                                 device=dev).half()
                 for shape in ((IR_LAYERS, b, 1, nh, hd),
                               (IR_LAYERS, b, s_max, nh, hd),
                               (IR_LAYERS, b, s_max, nh, hd)))
    opt = ir.optimize(masked_decode, passes=["decode_attention"])
    opt(q, ks, vs)                                  # trace and rewrite
    torch.cuda.synchronize(dev)
    registry.reset_counts()
    got = opt(q, ks, vs)
    torch.cuda.synchronize(dev)
    b6 = registry.counts()["decode_attention"]
    ref = masked_decode(q.float(), ks.float(), vs.float())
    report = _parity(got, ref, 1e-4)
    naive = _parity(masked_decode(q, ks, vs), ref, 1e-4)
    say("ir_decode_pass", batch=b, s_max=s_max, heads=nh, head_dim=hd,
        dtype="float16", layers=IR_LAYERS, rewrites=opt.last_rewrite_count,
        kernel_launches=b6, expected=IR_LAYERS, max_abs_err=report[0],
        err_over_limit=report[2], naive_f16_err_over_limit=naive[2])
    if opt.last_rewrite_count != IR_LAYERS or b6 != IR_LAYERS or \
            not report[3]:
        raise RuntimeError(f"decode pass: rewrites "
                           f"{opt.last_rewrite_count}, B6 {b6}, {report}")
    return {**{k: counts[k] for k in want}, "decode_attention": b6}


def predictor_phase(dev, smi):
    """ViT-B/16 through the deployment path: ``PTQ(QuantConfig(
    activation=AbsmaxObserver))`` calibrated on 4 batches made from
    ``DEPLOY_SEED``, ``convert``, ``jit.save`` under chiprun_out/,
    ``Config(prefix).enable_mixed_precision("float16")``,
    ``create_predictor``, 3 handle-style runs at batch 64 (the main
    path, counts at 0 just before): device ms a run, B2 f16 12 a run and
    B4a f16 25 a run, the largest relative error (held to
    ``PREDICTOR_RTOL``) and the top-1 agreement against the converted
    model's eager f32 forward, beside the same error of a control that
    drops each attention's tail tile (it must exceed the limit).
    Returns {kernel: launches}."""
    import torch

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import inference
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.ops.cuda import registry
    from paddle_tpu_torch.vision.models import vit_base_patch16_224

    paddle.seed(DEPLOY_SEED)
    model = vit_base_patch16_224()
    model.eval()
    rng = np.random.RandomState(DEPLOY_SEED + 3)
    ptq = Q.PTQ(Q.QuantConfig(activation=Q.AbsmaxObserver))
    qmodel = ptq.quantize(model)
    with torch.no_grad():
        for _ in range(4):
            qmodel(paddle.to_tensor(rng.randn(16, 3, 224, 224)
                                    .astype(np.float32)))
    deployed = ptq.convert(qmodel)
    prefix = os.path.join(ROOT, "chiprun_out", "predictor", "vit_b16")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    t0 = time.perf_counter()
    paddle.jit.save(deployed, prefix)
    save_s = time.perf_counter() - t0
    cfg = inference.Config(prefix)
    cfg.enable_mixed_precision("float16")
    t0 = time.perf_counter()
    pred = inference.create_predictor(cfg)
    x = rng.randn(PREDICTOR_BATCH, 3, 224, 224).astype(np.float32)
    handle = pred.get_input_handle(pred.get_input_names()[0])
    handle.copy_from_cpu(x)
    pred.run()                                       # trace
    first_s = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    registry.reset_counts()
    ms = []
    for _ in range(PREDICTOR_RUNS):
        handle.copy_from_cpu(x)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        pred.run()
        end.record()
        torch.cuda.synchronize(dev)
        ms.append(start.elapsed_time(end))
    counts = registry.counts()
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    with torch.no_grad():
        ref = deployed(paddle.to_tensor(x)).numpy()
        # the control: the same f32 forward with every attention blind to
        # the last 5 of its 197 keys (the tail of the last 64-key tile),
        # what a kernel that drops the tail tile would compute
        real = F._dispatch_attention

        def tail_dropped(q, k, v, **kw):
            return real(q, k[:, :192], v[:, :192], **kw)

        F._dispatch_attention = tail_dropped
        try:
            control = deployed(paddle.to_tensor(x)).numpy()
        finally:
            F._dispatch_attention = real
    for ext in (".pdmodel", ".pdiparams"):
        os.remove(prefix + ext)     # hundreds of MB: not brought back

    def rel_err(a):
        return float(np.abs(a.astype(np.float32) - ref).max()
                     / np.abs(ref).max())

    rel, control_rel = rel_err(out), rel_err(control)
    top1 = float((out.astype(np.float32).argmax(-1) == ref.argmax(-1))
                 .mean())
    want = {"flash_attention_fwd": 12 * PREDICTOR_RUNS,
            "layernorm_fwd": 25 * PREDICTOR_RUNS}
    got = {k: counts[k] for k in want}
    say("predictor", model="vit_base_patch16_224", batch=PREDICTOR_BATCH,
        dtype="float16", nvidia_smi=smi, save_s=save_s,
        first_run_s=first_s, run_ms=ms, output_dtype=str(out.dtype),
        max_rel_err_vs_f32=rel, rtol=PREDICTOR_RTOL,
        control_tail_dropped_max_rel_err=control_rel, top1_agreement=top1,
        kernel_launches=got, expected=want)
    if got != want or out.dtype != np.float16 or \
            not np.isfinite(out).all():
        raise RuntimeError(f"predictor launches {got} != {want} or "
                           f"output {out.dtype}")
    if not rel <= PREDICTOR_RTOL < control_rel:
        raise RuntimeError(f"predictor output {rel} off the f32 forward "
                           f"(limit {PREDICTOR_RTOL}, tail-dropped "
                           f"control {control_rel})")
    return got


def c12_windows_phase(dev, tag, port_from=0):
    """ROADMAP C12's experiment: one workload (``C12_CALLS`` flash
    forwards and LayerNorm forwards, bf16) under profiler windows at
    this age of the process, after 0, 1 and 5 earlier windows of this
    experiment and after 100 CUDA-graph replays of the workload.  From
    window ``port_from`` on, the windows go alternately through the
    port's ``profiler.Profiler(targets=[GPU])`` and through
    ``torch.profiler.profile`` directly; before it, through
    ``torch.profiler`` alone.  Prints, for each window, the kernel
    records it missed against the launches the wrappers counted in it
    (the launch plan)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.ops.cuda import registry

    work = _c12_workload(dev)
    work()
    torch.cuda.synchronize(dev)
    names = {"flash_fwd_tc": "flash_attention_fwd",
             "ln_fwd_kernel": "layernorm_fwd"}

    def records(events):
        return {n: sum(e.count for e in events if n in e.key)
                for n in names}

    def window(i, label):
        port = i >= port_from and (i - port_from) % 2 == 0
        t = time.perf_counter() - _T0
        before = registry.counts()
        if port:
            with profiler.Profiler(targets=[profiler.ProfilerTarget.GPU]) \
                    as prof:
                work()
                torch.cuda.synchronize(dev)
            events = prof._last.key_averages()
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                work()
                torch.cuda.synchronize(dev)
            events = prof.key_averages()
        after = registry.counts()
        launched = {n: after[k] - before[k] for n, k in names.items()}
        got = records(events)
        missing = {n: launched[n] - got[n] for n in names}
        say("c12_window", run=tag, window=label, process_age_s=t,
            earlier_windows=i,
            through="paddle_tpu_torch.profiler" if port else
            "torch.profiler", kernel_records=got, launches=launched,
            expected=C12_CALLS, missing=missing)
        return missing

    out = [window(0, "first"), window(1, "second")]
    for i in range(2, 6):
        window(i, f"filler_{i}")
    out.append(window(6, "after_5"))
    graph = _graph(work)
    for _ in range(100):
        graph.replay()
    torch.cuda.synchronize(dev)
    out.append(window(7, "after_100_replays"))
    return out


def _c12_workload(dev):
    """C12's workload: ``C12_CALLS`` causal flash forwards (2 x 512 x 12
    x 64) and LayerNorms (4096 x 768), bf16, through the port's
    dispatch."""
    import torch

    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops.attention import flash_attention

    bf16 = torch.bfloat16
    rng = np.random.RandomState(DEPLOY_SEED + 4)
    q = torch.as_tensor(rng.randn(2, 512, 12, 64).astype(np.float32),
                        device=dev).to(bf16)
    x = torch.as_tensor(rng.randn(4096, 768).astype(np.float32),
                        device=dev).to(bf16)
    w, b = torch.ones(768, device=dev, dtype=bf16), \
        torch.zeros(768, device=dev, dtype=bf16)

    def work():
        for _ in range(C12_CALLS):
            flash_attention(q, q, q, is_causal=True)
            F.layer_norm(x, [768], w, b)

    return work


_PROFILER_STARTS = []


def count_profiler_starts():
    """Count every start of a ``torch.profiler.profile`` from now on
    (the port's ``Profiler`` starts one too); returns the one-element
    list that holds the count."""
    import torch

    if not _PROFILER_STARTS:
        _PROFILER_STARTS.append(0)
        start = torch.profiler.profile.start

        def counted_start(self):
            _PROFILER_STARTS[0] += 1
            return start(self)

        torch.profiler.profile.start = counted_start
    return _PROFILER_STARTS


def c12_control_phase(dev, mode="control", sessions=0, port_after=0):
    """ROADMAP C12's control and its two modes (``python3 chip_smoke.py
    c12_control [sessions N | port N K]``): the experiment's windows at
    the full run's process age (``C12_CONTROL_AGE_S``).  The process runs
    the exactness phases, which open no profiler, then the workload
    eagerly and by CUDA-graph replays until that age; every start of a
    ``torch.profiler.profile`` is counted from the process's start.

    - ``control``: no profiler before the windows; the first four
      windows go through ``torch.profiler`` directly, the port's
      ``Profiler`` only after them.
    - ``sessions N`` (mode A): N short ``torch.profiler`` sessions, each
      over one run of the workload, spread evenly over the ageing, and
      no port ``Profiler`` before the windows (the first four windows
      again through ``torch.profiler`` alone).
    - ``port N K`` (mode B): the same N sessions, and the port's
      ``Profiler(targets=[CPU, GPU])`` over three runs of the workload
      after the K-th of them, where the full run opens it (its
      ``profiler`` phase); the windows then alternate from the first,
      as the full run's do."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import profiler

    starts = count_profiler_starts()
    exactness_phase(dev)
    int8_exactness_phase(dev)
    fmt_exactness_phase(dev)
    graphs_phase(dev)
    torch.cuda.empty_cache()
    work = _c12_workload(dev)
    graph = _graph(work)
    calls, opened, port_opened = 0, 0, False
    t_start = time.perf_counter() - _T0
    span = max(C12_CONTROL_AGE_S - t_start, 1.0)
    while time.perf_counter() - _T0 < C12_CONTROL_AGE_S:
        work()
        for _ in range(10):
            graph.replay()
        torch.cuda.synchronize(dev)
        calls += 11
        age = time.perf_counter() - _T0
        while opened < sessions and \
                age >= t_start + span * (opened + 1) / (sessions + 1):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                work()
                torch.cuda.synchronize(dev)
            opened += 1
            calls += 1
        if mode == "port" and not port_opened and opened >= port_after:
            with profiler.Profiler(targets=[profiler.ProfilerTarget.CPU,
                                            profiler.ProfilerTarget.GPU]):
                for _ in range(3):
                    work()
                torch.cuda.synchronize(dev)
            port_opened = True
            calls += 3
    del graph
    say("c12_control", mode=mode, sessions=opened,
        port_profiler_after=port_after if mode == "port" else None,
        profiler_starts_before_windows=starts[0], workload_runs=calls,
        process_age_s=time.perf_counter() - _T0)
    want = sessions + (1 if mode == "port" else 0)
    if starts[0] != want or opened != sessions:
        raise RuntimeError(f"c12_control {mode}: {starts[0]} profiler "
                           f"starts before the windows, {want} planned")
    return c12_windows_phase(dev, f"c12_{mode}",
                             port_from=0 if mode == "port" else 4)


def deploy_phases(dev, smi):
    """The deployment slice (``python3 chip_smoke.py deploy``): the
    float16 kernel rows, float16 serving behind ``PredictorServer``, the
    float16 FusedMultiTransformer, the IR passes, the ViT predictor and
    C12's profiler windows.  Returns {kernel: main-path launches}."""
    fp16_kernel_phase(dev)
    launches = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    import torch

    add(fp16_serving_phase(dev, smi))
    torch.cuda.empty_cache()
    add({"decode_attention": fmt_fp16_phase(dev)})
    torch.cuda.empty_cache()
    add(ir_passes_phase(dev, smi))
    torch.cuda.empty_cache()
    add(predictor_phase(dev, smi))
    torch.cuda.empty_cache()
    c12_windows_phase(dev, "deploy")
    say("deploy_launches", launches=launches)
    return launches


PROGRAM_SEED = 20
RN50_RTOL = 1e-4        # imported ResNet-50 against the eager model, of
                        # max|eager| (both f32 with TF32 off)
GPT_IMPORT_ATOL = 1e-4  # imported GPT-124M logits against the eager
                        # kernels' (compositions vs B2/B4a, f32): 17x
                        # the sound reading 5.84e-6, 154x below the
                        # blind-head control's 0.0154 (PERF.md, PR 20)
GPT_BATCH, GPT_SEQ = 8, 1024
# the imported program's sequence is the export's (its position lookup
# folds to a 1024-row constant, as the JAX exporter folds its iota)
FINETUNE_BATCH, FINETUNE_SEQ = 4, GPT_SEQ
PROGRAM_RUNS = 3


def _op_counts(prefix, kinds):
    from paddle_tpu_torch.static.program_import import parse_program

    with open(prefix + ".pdmodel", "rb") as f:
        ops, _ = parse_program(f.read())
    types = [o.type for o in ops]
    return {k: types.count(k) for k in kinds}


def _rel_top1(out, ref):
    """(max |out - ref| / max |ref|, top-1 agreement over the last axis)
    of two device tensors."""
    err = float((out - ref).abs().max() / ref.abs().max())
    top1 = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
    return err, top1


def export_resnet50_phase(dev, smi, tmp):
    """ResNet-50 (eval, f32) exported on the card through
    ``save_inference_model`` with a dynamic batch, loaded back on the
    card and run at batch 1 and 64 against the eager model; a control
    with one BatchNorm's epsilon changed must exceed ``RN50_RTOL``."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.vision.models import resnet50

    paddle.seed(PROGRAM_SEED)
    model = resnet50()
    model.eval()
    prefix = os.path.join(tmp, "resnet50")
    t0 = time.perf_counter()
    paddle.static.save_inference_model(
        prefix, [InputSpec([None, 3, 224, 224], "float32", "x")], model)
    export_s = time.perf_counter() - t0
    counts = _op_counts(prefix, ("conv2d", "batch_norm", "pool2d",
                                 "matmul_v2", "fill_constant", "rsqrt"))
    t0 = time.perf_counter()
    prog, feeds, fetches = paddle.static.load_inference_model(prefix)
    load_s = time.perf_counter() - t0
    rng = np.random.RandomState(PROGRAM_SEED)
    rows = {}
    with torch.no_grad():
        for batch in (1, 64):
            x = torch.as_tensor(rng.randn(batch, 3, 224, 224)
                                .astype(np.float32), device=dev)
            out = prog(x)[0]._data
            ref = model(paddle.to_tensor(x))._data
            rel, top1 = _rel_top1(out, ref)
            rows[batch] = dict(
                max_rel_err=rel, top1_agreement=top1,
                imported_ms=_events_ms(lambda: prog(x)),
                eager_ms=_events_ms(lambda: model(paddle.to_tensor(x))))
        # the control: the first BatchNorm's epsilon 1e-5 -> 1e-1
        bad, _, _ = paddle.static.load_inference_model(prefix)
        bn = next(op for op in bad.body if op.type == "batch_norm")
        bn.attrs["epsilon"] = 0.1
        control, _ = _rel_top1(bad(x)[0]._data, ref)
    say("export_resnet50", nvidia_smi=smi, export_s=export_s, load_s=load_s,
        op_counts=counts, feeds=feeds, fetches=fetches, runs=rows,
        rtol=RN50_RTOL, control_bn_epsilon_max_rel_err=control,
        pdiparams_mb=os.path.getsize(prefix + ".pdiparams") / 1e6)
    want = {"conv2d": 53, "batch_norm": 53, "pool2d": 2, "matmul_v2": 1,
            "fill_constant": 0, "rsqrt": 0}
    if counts != want:
        raise RuntimeError(f"resnet50 export ops {counts} != {want}")
    if not all(r["max_rel_err"] <= RN50_RTOL and r["top1_agreement"] == 1.0
               for r in rows.values()) or not control > RN50_RTOL:
        raise RuntimeError(f"imported resnet50 {rows} (limit {RN50_RTOL}, "
                           f"control {control})")
    for ext in (".pdmodel", ".pdiparams"):
        os.remove(prefix + ext)


def export_refuses_kernels_phase(dev, tmp):
    """GPT-124M on the card: the export's trace holds the kernel ops,
    and the exporter refuses by the kernel's name, nothing falling back
    to the plain path."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.static.program_export import \
        export_reference_inference_model

    paddle.seed(PROGRAM_SEED)
    model = gpt_124m(device=dev)
    model.eval()
    try:
        export_reference_inference_model(
            os.path.join(tmp, "refused"),
            [InputSpec([None, GPT_SEQ], "int32")], model)
    except NotImplementedError as exc:
        msg = str(exc)
    else:
        raise RuntimeError("GPT-124M on the card exported: its kernels "
                           "were not in the trace")
    named = [k for k in ("paddle_tpu_torch::layernorm_fwd",
                         "paddle_tpu_torch::flash_attention_fwd")
             if k in msg]
    say("export_refuses_kernels", model="gpt_124m", refused_by=named,
        message=msg[:200])
    if not named:
        raise RuntimeError(f"export refusal does not name a kernel: {msg}")


def _gpt_cpu_copy():
    from paddle_tpu_torch.models.gpt import gpt_124m

    model = gpt_124m(device="cpu", seed=PROGRAM_SEED,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    model.eval()
    return model


def _blind_head(translators, keys=64):
    """The importer's softmax with the first call's head 0 blind to its
    last ``keys`` keys (the control of ``import_gpt124m``)."""
    import torch

    real = translators["softmax"]
    seen = [0]

    def softmax(ins, attrs):
        x = ins["X"]
        if seen[0] == 0 and x.dim() == 4:
            blind = torch.zeros_like(x, dtype=torch.bool)
            blind[:, 0, :, -keys:] = True
            blind[:, 0, :, 0] = False
            x = torch.where(blind, torch.finfo(x.dtype).min, x)
        seen[0] += 1
        return real({"X": x}, attrs)

    return softmax


def import_gpt124m_phase(dev, smi, tmp):
    """GPT-124M (eval, dropout 0) exported from a CPU copy with a dynamic
    batch, served by ``inference.Config(prefix)`` / ``create_predictor``
    on the card with handle-style runs at 8 x 1024 and held to the same
    weights' eager GPT-124M on the card (B2, B4a); a control with one
    head of the first layer blind to its last 64 keys must exceed the
    limit.  Returns (prefix, {kernel: launches}) of the eager runs."""
    import torch

    from paddle_tpu_torch import inference
    from paddle_tpu_torch.ops.cuda import registry
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.static import program_import as pimp
    from paddle_tpu_torch.static.program_export import \
        export_reference_inference_model

    cpu = _gpt_cpu_copy()
    prefix = os.path.join(tmp, "gpt124m")
    t0 = time.perf_counter()
    ops = export_reference_inference_model(
        prefix, [InputSpec([None, GPT_SEQ], "int32", "ids")], cpu)
    export_s = time.perf_counter() - t0
    model = cpu.to(dev)
    rng = np.random.RandomState(PROGRAM_SEED + 1)
    ids = rng.randint(0, 50304, (GPT_BATCH, GPT_SEQ)).astype(np.int32)
    t0 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(prefix))
    handle = pred.get_input_handle(pred.get_input_names()[0])
    handle.copy_from_cpu(ids)
    pred.run()                                     # trace
    first_s = time.perf_counter() - t0
    handle_ms = []
    for _ in range(PROGRAM_RUNS):
        t0 = time.perf_counter()
        handle.copy_from_cpu(ids)
        pred.run()
        out_host = pred.get_output_handle(
            pred.get_output_names()[0]).copy_to_cpu()
        handle_ms.append((time.perf_counter() - t0) * 1e3)
    ids_t = torch.as_tensor(ids, device=dev)
    imported_ms = _events_ms(lambda: pred._run_tensors([ids_t]))
    with torch.no_grad():
        torch.cuda.synchronize(dev)
        registry.reset_counts()
        ref = model(ids_t)
        torch.cuda.synchronize(dev)
        counts = registry.counts()
        eager_ms = _events_ms(lambda: model(ids_t))
    out = torch.as_tensor(out_host, device=dev)
    err = (out - ref).abs()
    max_abs, rms = float(err.max()), float(err.pow(2).mean().sqrt())
    top1 = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
    del out, err
    saved = pimp._TRANSLATORS["softmax"]
    pimp._TRANSLATORS["softmax"] = _blind_head(pimp._TRANSLATORS)
    try:
        bad, _, _ = pimp.load_reference_inference_model(prefix)
        with torch.no_grad():
            control = float((bad(ids_t)[0]._data - ref).abs().max())
    finally:
        pimp._TRANSLATORS["softmax"] = saved
    del bad, ref
    layers = 12
    want = {"flash_attention_fwd": layers, "layernorm_fwd": 2 * layers + 1}
    got = {k: counts[k] for k in want}
    say("import_gpt124m", nvidia_smi=smi, batch=GPT_BATCH, seq=GPT_SEQ,
        export_s=export_s, ops=len(ops),
        fused={k: ops.count(k) for k in ("softmax", "layer_norm", "gelu",
                                         "matmul_v2", "lookup_table_v2")},
        first_run_s=first_s, handle_run_ms=handle_ms,
        imported_device_ms=imported_ms, eager_device_ms=eager_ms,
        max_abs_err=max_abs, rms_err=rms, top1_agreement=top1,
        atol=GPT_IMPORT_ATOL, control_blind_head_max_abs_err=control,
        eager_launches=got, expected=want)
    if got != want:
        raise RuntimeError(f"eager GPT-124M launches {got} != {want}")
    if not (max_abs <= GPT_IMPORT_ATOL < control and top1 >= 0.999):
        raise RuntimeError(f"imported GPT-124M {max_abs} (limit "
                           f"{GPT_IMPORT_ATOL}, control {control}, top-1 "
                           f"{top1})")
    del pred, model
    torch.cuda.empty_cache()
    return prefix, got


def imported_finetune_phase(dev, prefix):
    """``to_layer()`` of the imported GPT-124M program: 3 SGD steps at
    4 x 1024 on the card (the loss falls), ``sync_to_program()``, the
    trained layer exported again (its trace holds compositions only) and
    reloaded: equal to the trained layer within 1e-5."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.static import program_import as pimp
    from paddle_tpu_torch.static.program_export import \
        export_reference_inference_model

    prog, _, _ = pimp.load_reference_inference_model(prefix)
    layer = prog.to_layer()
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=layer.parameters())
    rng = np.random.RandomState(PROGRAM_SEED + 2)
    ids = rng.randint(0, 50304, (FINETUNE_BATCH, FINETUNE_SEQ + 1)) \
        .astype(np.int32)
    x = paddle.to_tensor(ids[:, :-1])
    y = paddle.to_tensor(ids[:, 1:].astype(np.int64))
    losses, ms = [], []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        logits = layer(x)
        loss = paddle.nn.functional.cross_entropy(
            logits.reshape([-1, 50304]), y.reshape([-1]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(loss))
    layer.sync_to_program()
    again = prefix + "_tuned"
    ops = export_reference_inference_model(
        again, [InputSpec([None, FINETUNE_SEQ], "int32", "ids")], layer)
    tuned, _, _ = pimp.load_reference_inference_model(again)
    with torch.no_grad():
        probe = paddle.to_tensor(ids[:2, :-1])
        got = tuned(probe)[0]._data
        want = layer(probe)._data
    err = float((got - want).abs().max() / want.abs().max())
    say("imported_finetune", batch=FINETUNE_BATCH, seq=FINETUNE_SEQ,
        losses=losses, step_ms=ms, reexported_ops=len(ops),
        reloaded_max_rel_err=err)
    for ext in (".pdmodel", ".pdiparams"):
        os.remove(again + ext)
    if not losses[-1] < losses[0] or not np.isfinite(losses).all():
        raise RuntimeError(f"imported GPT-124M fine-tune losses {losses}")
    if not err <= 1e-5:
        raise RuntimeError(f"re-exported layer off the trained one: {err}")


def onnx_phase(dev, tmp):
    """ResNet-50 (batch 1) ONNX-exported on the card; the numpy runtime
    on the host against the eager output (1e-4 of max|eager|)."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.onnx import runtime
    from paddle_tpu_torch.vision.models import resnet50

    paddle.seed(PROGRAM_SEED)
    model = resnet50()
    model.eval()
    x = np.random.RandomState(PROGRAM_SEED + 3).randn(1, 3, 224, 224) \
        .astype(np.float32)
    t0 = time.perf_counter()
    path = paddle.onnx.export(model, os.path.join(tmp, "rn50"),
                              input_spec=[paddle.to_tensor(x)])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = runtime.run(path, [x])[0]
    run_s = time.perf_counter() - t0
    with torch.no_grad():
        ref = model(paddle.to_tensor(x)).numpy()
    rel = float(np.abs(out - ref).max() / np.abs(ref).max())
    say("onnx", model="resnet50", batch=1, export_s=export_s,
        onnx_mb=os.path.getsize(path) / 1e6, numpy_runtime_s=run_s,
        max_rel_err=rel)
    os.remove(path)
    if not rel <= 1e-4:
        raise RuntimeError(f"ONNX runtime off the eager ResNet-50: {rel}")


def custom_ops_phase(dev):
    """B4a's launcher registered through ``utils.register_pallas_op``
    with B4b as its backward, on 8192 x 768 bf16: the forward against
    the plain version by the strict rule and bitwise repeatable, one
    backward against the plain backward; a host C extension called on a
    CUDA tensor.  Returns {kernel: launches}."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.cuda import registry
    from paddle_tpu_torch.ops.cuda.layernorm_kernel import (
        layernorm_bwd_cuda, layernorm_bwd_plain, layernorm_fwd_cuda,
        layernorm_fwd_plain)
    from paddle_tpu_torch.ops.registry import OPS
    from paddle_tpu_torch.utils import cpp_extension, register_pallas_op

    def fwd(x, g, b):
        return layernorm_fwd_cuda(x, g, b, 1e-5)[0]

    def bwd(dy, x, g, b):
        _, mu, rstd = layernorm_fwd_cuda(x, g, b, 1e-5)
        dx, dg, db = layernorm_bwd_cuda(x, g, mu, rstd, dy.contiguous())
        return dx, dg.to(g.dtype), db.to(b.dtype)

    op = register_pallas_op("smoke_layernorm_b4", fwd, backward=bwd)
    rng = np.random.RandomState(PROGRAM_SEED + 4)
    bf16 = torch.bfloat16
    xs = [torch.as_tensor(v, device=dev) for v in (
        rng.randn(8192, 768).astype(np.float32),
        rng.rand(768).astype(np.float32) + 0.5,
        rng.randn(768).astype(np.float32) * 0.1)]
    x, g, b = (v.to(bf16) for v in xs)
    dy = torch.as_tensor(rng.randn(8192, 768).astype(np.float32),
                         device=dev).to(bf16)
    torch.cuda.synchronize(dev)
    registry.reset_counts()
    ts = [paddle.to_tensor(v, stop_gradient=False) for v in (x, g, b)]
    y1 = op(*ts)
    (y1 * paddle.to_tensor(dy)).sum().backward()
    y2 = op(*[paddle.to_tensor(v) for v in (x, g, b)])
    torch.cuda.synchronize(dev)
    counts = registry.counts()
    want_y, _, _ = layernorm_fwd_plain(x.float(), g.float(), b.float(), 1e-5)
    dx_w, dg_w, db_w = layernorm_bwd_plain(x.float(), g.float(), None, None,
                                           dy.float())
    fwd_rep = _parity(y1._data.detach(), want_y, 1e-5)
    # what the bf16 output's own rounding reads by the same rule
    rounding = _parity(want_y.to(bf16), want_y, 1e-5)[2]
    bwd_rep = {"dx": _parity(ts[0].grad._data, dx_w, 1e-5)}
    bitwise = bool(torch.equal(y1._data, y2._data))
    launches = {k: counts[k] for k in ("layernorm_fwd", "layernorm_bwd")}
    ms = _events_ms(lambda: op(*[paddle.to_tensor(v) for v in (x, g, b)]))
    src = ('extern "C" void scale3(const float* x, float* out, long long n)'
           ' { for (long long i = 0; i < n; ++i) out[i] = 3.0f * x[i]; }')
    mod = cpp_extension.load("smoke_scale3", [src], functions={
        "scale3": ("void", ["float*", "float*", "int64"])})
    import ctypes

    def host_fn(a):
        a = np.ascontiguousarray(a, np.float32)
        out = np.empty_like(a)
        fp = ctypes.POINTER(ctypes.c_float)
        mod.scale3(a.ctypes.data_as(fp), out.ctypes.data_as(fp), a.size)
        return out

    host = cpp_extension.host_op_from_extension(
        "smoke_host_scale3", host_fn, out_shape_fn=lambda a: a)
    hx = torch.as_tensor(rng.randn(4, 5).astype(np.float32), device=dev)
    hy = host(paddle.to_tensor(hx))._data
    say("custom_ops", op="smoke_layernorm_b4",
        tags=list(OPS["smoke_layernorm_b4"].tags), shape=[8192, 768],
        dtype="bf16",
        fwd_err_over_limit=fwd_rep[2], dx_err_over_limit=bwd_rep["dx"][2],
        plain_rounded_to_bf16_err_over_limit=rounding,
        bitwise_repeatable=bitwise, launches=launches, fwd_ms=ms,
        host_op_device=str(hy.device),
        host_op_max_abs_err=float((hy - 3 * hx).abs().max()))
    if not (fwd_rep[3] and bwd_rep["dx"][3] and bitwise) or \
            hy.device != hx.device or not torch.equal(hy, 3 * hx):
        raise RuntimeError("register_pallas_op B4a/B4b or the host op "
                           "failed its check")
    # the op's two forwards, the recompute in its backward; B4b once
    if launches != {"layernorm_fwd": 3, "layernorm_bwd": 1}:
        raise RuntimeError(f"custom op launches {launches}")
    return launches


def cost_model_phase(dev):
    """``CostModel`` on the card over the port's ops (CUDA events), and
    its host-event profile of an eager function."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.cost_model import CostModel

    cm = CostModel()
    shapes = {"matmul": ((4096, 4096), (4096, 4096)),
              "add": ((8192, 4096), (8192, 4096)),
              "exp": ((8192, 4096),), "softmax": ((8192, 4096),),
              "gelu": ((8192, 4096),),
              "conv2d": ((32, 64, 56, 56), (64, 64, 3, 3))}
    ms = {n: cm.get_static_op_time(n, shapes=s)["op_time"]
          for n, s in shapes.items()}
    x = paddle.to_tensor(np.random.RandomState(5).rand(1024, 1024)
                         .astype(np.float32))
    prof = cm.profile_measure(lambda: paddle.matmul(x, x) + x)
    say("cost_model", device_ms=ms, shapes={k: list(v) for k, v in
                                             shapes.items()},
        profile={k: v for k, v in prof.items()
                 if k in ("matmul", "add")})
    if not all(v > 0 for v in ms.values()):
        raise RuntimeError(f"cost model times {ms}")


def program_lint_phase(prefix):
    """The analysis CLI's ``program`` subcommand over the GPT-124M
    artifact (no G001), then over the same program with a dead op added
    to block 0 (one G001)."""
    import io

    from paddle_tpu_torch.framework import analysis
    from paddle_tpu_torch.static.program_export import _enc_op, _fbytes
    from paddle_tpu_torch.static.program_import import (_Reader,
                                                        parse_program)

    def lint(p):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = analysis.main(["program", p, "--json"])
        return rc, json.loads(buf.getvalue())

    rc, clean = lint(prefix)
    raw = open(prefix + ".pdmodel", "rb").read()
    ops, _ = parse_program(raw)
    fetched = next(o.inputs["X"][0] for o in ops if o.type == "fetch")
    r = _Reader(raw)
    r.varint()
    n = r.varint()
    block = raw[r.pos:r.pos + n] + _fbytes(4, _enc_op(
        "relu", {"X": [fetched]}, {"Out": ["orphan"]}, []))
    dead = prefix + "_dead"
    with open(dead + ".pdmodel", "wb") as f:
        f.write(_fbytes(1, block) + raw[r.pos + n:])
    rc2, found = lint(dead)       # the lint reads no .pdiparams
    g001 = [f for f in found["findings"] if f["rule"] == "G001"]
    say("program_lint", clean_rc=rc, clean_findings=len(clean["findings"]),
        dead_rc=rc2, dead_g001=len(g001),
        dead_message=g001[0]["message"] if g001 else None)
    if rc or clean["findings"] or len(g001) != 1 or \
            "orphan" not in g001[0]["message"]:
        raise RuntimeError("program lint: a finding on the clean program "
                           "or not exactly one G001 on the dead op")


def program_phases(dev, smi):
    """The program tooling (``python3 chip_smoke.py program``): the
    reference-format export and import on the card, ONNX, custom ops,
    the cost model and the program lint.  Returns {kernel: main-path
    launches}."""
    import tempfile

    import torch

    launches = {}
    # the artifacts (hundreds of MB) go with the directory, on failure too
    with tempfile.TemporaryDirectory(prefix="chip_smoke_program_") as tmp:
        export_resnet50_phase(dev, smi, tmp)
        torch.cuda.empty_cache()
        export_refuses_kernels_phase(dev, tmp)
        torch.cuda.empty_cache()
        prefix, got = import_gpt124m_phase(dev, smi, tmp)
        launches.update(got)
        imported_finetune_phase(dev, prefix)
        torch.cuda.empty_cache()
        onnx_phase(dev, tmp)
        for k, n in custom_ops_phase(dev).items():
            launches[k] = launches.get(k, 0) + n
        cost_model_phase(dev)
        program_lint_phase(prefix)
    torch.cuda.empty_cache()
    say("program_launches", launches=launches)
    return launches


def main():
    if not os.path.isdir(os.path.join(ROOT, "paddle_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout that holds "
                         "paddle_tpu_torch/")
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["distributed_rank"] and len(sys.argv) == 3:
        # one rank of the distributed phase, started by the launcher
        distributed_rank(sys.argv[2])
        return
    if sys.argv[1:2] == ["hybrid_rank"] and len(sys.argv) == 3:
        # one rank of the hybrid phase, started by the launcher
        hybrid_rank(sys.argv[2])
        return
    if sys.argv[1:2] == ["parallel_rank"] and len(sys.argv) == 3:
        # one rank of the parallel phase, started by the launcher
        parallel_rank(sys.argv[2])
        return
    import torch

    name, smi = device_phase()
    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["ln_bwd_designs"]:
        ln_bwd_designs_phase(dev)
        return
    if sys.argv[1:] == ["kernels"]:
        build_phase()
        from paddle_tpu_torch.ops.cuda import registry

        for names, phase in PARITY_PHASES.items():
            phase({k: registry.KERNELS[k] for k in names}, dev)
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
    if sys.argv[1:] == ["speech"]:
        build_phase()
        speech_phase(dev, smi)
        vision_zoo_phase(dev, smi)
        gpt_6_7b_phase(dev, smi)
        return
    if sys.argv[1:] == ["train_features"]:
        build_phase()
        train_features_phases(dev, smi)
        return
    if sys.argv[1:] == ["deploy"]:
        build_phase()
        deploy_phases(dev, smi)
        return
    if sys.argv[1:2] == ["c12_control"]:
        args = sys.argv[2:]
        build_phase()
        if not args:
            c12_control_phase(dev)
        elif args[0] == "sessions" and len(args) == 2:
            c12_control_phase(dev, "sessions", int(args[1]))
        elif args[0] == "port" and len(args) == 3:
            c12_control_phase(dev, "port", int(args[1]), int(args[2]))
        else:
            raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}")
        return
    if sys.argv[1:] == ["program"]:
        build_phase()
        program_phases(dev, smi)
        return
    if sys.argv[1:] == ["distributed"]:
        build_phase()
        t0 = time.perf_counter()
        distributed_phases(dev, smi)
        say("lap", after="distributed", seconds=time.perf_counter() - t0)
        return
    if sys.argv[1:] == ["hybrid"]:
        build_phase()
        t0 = time.perf_counter()
        hybrid_phases(dev, smi)
        say("lap", after="hybrid", seconds=time.perf_counter() - t0)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if sys.argv[1:] == ["parallel"]:
        build_phase()
        t0 = time.perf_counter()
        parallel_phases(dev, smi)
        say("lap", after="parallel", seconds=time.perf_counter() - t0)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if sys.argv[1:] == ["ops"]:
        build_phase()
        ops_phase(dev, smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}")
    # ROADMAP C12: the torch.profiler sessions the run starts before its
    # profiler windows (printed before the training features' profiler
    # phase and before the deployment slice's windows)
    starts = count_profiler_starts()
    laps = [time.perf_counter()]

    def lap(name):
        """Seconds since the previous lap, for the smoke's time budget."""
        laps.append(time.perf_counter())
        say("lap", after=name, seconds=laps[-1] - laps[-2],
            total_seconds=laps[-1] - laps[0])

    build_phase()
    lap("build")
    from paddle_tpu_torch.ops.cuda import registry

    covered = [k for names in PARITY_PHASES for k in names]
    missing = sorted(set(registry.KERNELS) - set(covered))
    if missing:
        raise RuntimeError(f"kernels {missing} have no parity phase")
    records = []
    for names, phase in PARITY_PHASES.items():
        records += phase({k: registry.KERNELS[k] for k in names}, dev)
    lap("kernels")
    timing_harness_phase(dev)
    exactness_phase(dev)
    int8_exactness_phase(dev)
    fmt_exactness_phase(dev)
    spec_launches = spec_exactness_phase(dev)
    train_exactness_phase(dev)
    train_exactness_bf16_phase(dev)
    graphs_phase(dev)
    lap("exactness, train_exactness, graphs")
    torch.cuda.empty_cache()
    launches, eng = serving_phase(dev)
    decode_profile_phase(eng, dev)
    lap("serving")
    del eng
    torch.cuda.empty_cache()
    # B1's main path is the serving burst and the front end's server
    # run, each driven with the counts at 0; the line sums them
    launches["paged_ragged_attention"] += front_end_phase(dev, smi)
    lap("front_end")
    torch.cuda.empty_cache()
    # and the speculation phases: spec_exactness's runs, the speculative
    # bursts and the speculative engine behind the server
    launches["paged_ragged_attention"] += (spec_launches
                                           + speculative_phase(dev, smi))
    lap("speculative")
    torch.cuda.empty_cache()
    launches.update(int8_serving_phase(dev))
    lap("int8_serving")
    torch.cuda.empty_cache()
    # and the multi-LoRA and KV-tier phases' runs, B1's and B5's
    b1, b5 = lora_tier_phases(dev, smi)
    lap("lora_tier")
    launches["paged_ragged_attention"] += b1
    launches["paged_ragged_attention_quant"] += b5
    torch.cuda.empty_cache()
    # and the fleet and simulator phases' runs, B1's and B5's
    b1, b5 = fleet_phases(dev, smi)
    lap("fleet")
    launches["paged_ragged_attention"] += b1
    launches["paged_ragged_attention_quant"] += b5
    torch.cuda.empty_cache()
    # and the tensor-parallel phases' runs, summed over the ranks
    b1, b5 = tp_phases(dev, smi)
    lap("tp")
    launches["paged_ragged_attention"] += b1
    launches["paged_ragged_attention_quant"] += b5
    torch.cuda.empty_cache()
    # B6's main path is both dense-cache decoders: each is driven with
    # the counts at 0 and read just after; the line sums them
    launches["decode_attention"] = (fmt_decode_phase(dev)
                                    + llama_decode_phase(dev))
    lap("decode")
    torch.cuda.empty_cache()
    launches.update(training_phase(dev))
    lap("training")
    torch.cuda.empty_cache()
    # and the distributed slice: GPT-124M under DataParallel at world
    # size 1 (NCCL) and the two gloo ranks' DataParallel and p_g_os runs
    # through the launcher (B2, B3, B4a, B4b), each counted alone
    for kernel, n in distributed_phases(dev, smi).items():
        launches[kernel] += n
    lap("distributed")
    torch.cuda.empty_cache()
    # and the hybrid slice: GPT-124M through fleet at world size 1 (NCCL)
    # and both ranks' mp = 2 steps with and without sequence parallelism
    # through the launcher (B2, B3, B4a, B4b), each counted alone
    for kernel, n in hybrid_phases(dev, smi).items():
        launches[kernel] += n
    lap("hybrid")
    torch.cuda.empty_cache()
    # and the parallel slice: both ranks' GPT-124M steps through
    # SpmdTrainStep over pp = 2, plain and interleaved (B2, B3, B4a, B4b),
    # each counted alone
    for kernel, n in parallel_phases(dev, smi).items():
        launches[kernel] += n
    lap("parallel")
    torch.cuda.empty_cache()
    # and the eager Paddle API's BERT-base paths: the timed training steps
    # (B4a, B4b) and the eval forward (B2, B4a), each counted alone
    for kernel, n in eager_api_phase(dev, smi).items():
        launches[kernel] += n
    lap("eager_api")
    torch.cuda.empty_cache()
    # and the vision path's ViT-B/16 fit (B2, B3, B4a, B4b), counted alone
    for kernel, n in vision_phase(dev, smi).items():
        launches[kernel] += n
    lap("vision")
    torch.cuda.empty_cache()
    # and the op surface's attention entry points (B2, B3), counted alone
    for kernel, n in ops_phase(dev, smi).items():
        launches[kernel] += n
    lap("ops")
    torch.cuda.empty_cache()
    # and the speech path's Conformer and DeepSpeech2 runs (B2, B3, B4a,
    # B4b), the zoo (no kernel) and gpt_6_7b's forward (B2, B4a at 4096),
    # each counted alone
    for kernel, n in speech_phase(dev, smi).items():
        launches[kernel] += n
    lap("speech")
    vision_zoo_phase(dev, smi)
    lap("vision_zoo")
    for kernel, n in gpt_6_7b_phase(dev, smi).items():
        launches[kernel] += n
    lap("gpt_6_7b")
    torch.cuda.empty_cache()
    say("c12_sessions", before="train_features", profiler_starts=starts[0])
    # and the training features' GPT-124M runs: remat=False and True
    # (bf16), the fp16 steps, each counted alone
    for kernel, n in train_features_phases(dev, smi).items():
        launches[kernel] += n
    lap("train_features")
    torch.cuda.empty_cache()
    # and the deployment slice: f16 serving (B1, B5), the f16 FMT and the
    # decode pass (B6), the IR passes' step (B2, B3, B4a, B4b) and the
    # predictor (B2, B4a), each counted alone
    say("c12_sessions", before="deploy", profiler_starts=starts[0])
    for kernel, n in deploy_phases(dev, smi).items():
        launches[kernel] += n
    lap("deploy")
    # and the program tooling: the eager GPT-124M the imported program is
    # held to (B2, B4a) and the kernel registered through
    # register_pallas_op (B4a, B4b), each counted alone
    for kernel, n in program_phases(dev, smi).items():
        launches[kernel] += n
    lap("program")
    tooling_phase(dev, smi)
    lap("tooling")
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
