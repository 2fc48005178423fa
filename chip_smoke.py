#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and the
CUDA toolkit.  Phases, each printing its own lines; any failure raises
and the script exits non-zero:

1. device   — the card's name and power limit (nvidia-smi), TF32 off;
2. build    — every ``paddle_tpu_torch/csrc/*.cu`` with nvcc, all at
              once, with each kernel's register / shared-memory report;
3. kernels  — every kernel of ``ops/cuda/registry.py`` against its
              plain PyTorch version on the card (f32 and bf16, the CPU
              test cases and full-width shapes; padding must be exact
              zeros), then timed with CUDA events against that plain
              version and against its bound (bytes at 3.35 TB/s or
              operations at the dense peak, whichever is larger);
4. exactness — a gpt_tiny-width 2-layer model in f32: the paged engine's
              greedy output must equal greedy decoding with the dense
              forward token for token, with the kernel launched on every
              layer of every step;
5. serving  — GPT-124M (random weights from a seed, bf16) behind the
              engine at block_size 16, max_batch 8, token_budget 256,
              prefix caching on: warmup, then 16 requests (8 sharing a
              256-token prefix, 64 new tokens each, 2 of them sampled);
              every request must finish by length with 64 tokens and
              the kernel's launch count must equal num_layers x the
              engine's launches;
6. profile  — a window of batch-8 decode steps on the same engine,
              wall time per step against device time under
              torch.profiler.

The second-to-last line is the ``kernels`` JSON record; the last line
is ``{"ok": true, "device": {...}}``.  The script imports only torch,
numpy and the port.
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
def time_ms(fn, flush, reps=30):
    """Median device ms of one call of ``fn``: the call is captured in a
    CUDA graph, and each replay is timed alone with CUDA events after
    the L2 cache was flushed (a layer's pool is cold when the engine
    reaches it again).  The graph takes the host's launch overhead out
    of the reading; :func:`call_ms` keeps it in."""
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
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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


def _ragged_bound(args):
    """Least time for this call: each input byte read once (q of live
    tokens, the K/V pages the rows' contexts cover, tables and
    descriptors), the output written once, against the FLOPs of
    QK^T and PV over each live token's context."""
    q, kp, _vp, bt, rs, rq, rp = args
    t, nq, d = q.shape
    _, bs, nkv, _ = kp.shape
    isz = q.element_size()
    rs, rq, rp = (x.cpu().numpy() for x in (rs, rq, rp))
    btn = bt.cpu().numpy()
    pages, flops, live = set(), 0.0, 0
    for r in range(len(rs)):
        if rq[r] == 0:
            continue
        live += int(rq[r])
        npg = -(-int(rp[r] + rq[r]) // bs)
        pages.update(int(p) for p in btn[r, :npg])
        ctx = rp[r] + np.arange(1, rq[r] + 1)
        flops += 4.0 * d * nq * float(ctx.sum())
    nbytes = (live * nq * d * isz                       # q
              + 2 * len(pages) * bs * nkv * d * isz     # K and V pages
              + 4 * (bt.numel() + 3 * len(rs))          # tables, descriptors
              + t * nq * d * isz)                       # output
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def ragged_attention_phase(entry, dev):
    """Kernel vs plain on the card; returns the ``kernels`` record."""
    import torch

    def check(label, args, atol):
        got = entry.kernel(*args)
        torch.cuda.synchronize()
        want = entry.plain(*args)
        err = float((got.float() - want.float()).abs().max())
        live = torch.zeros(args[0].shape[0], dtype=torch.bool, device=dev)
        for s, n in zip(args[4].tolist(), args[5].tolist()):
            live[s:s + n] = True
        pad_zero = bool((got[~live] == 0).all())
        say("kernel_parity", kernel=entry.name, case=label,
            dtype=str(got.dtype), max_abs_err=err, atol=atol,
            padding_exact_zero=pad_zero)
        if not (err <= atol and pad_zero and torch.isfinite(got).all()):
            raise RuntimeError(f"{entry.name} {label}: max_abs_err {err} "
                               f"(atol {atol}), padding zero {pad_zero}")
        return err

    # (a) the five CPU-test cases, f32
    for i, (nb, bs, nq, nkv, d, t, seed, bt, rs, rq, rp) in \
            enumerate(_CPU_CASES):
        check(f"cpu_case_{i}", _ragged_case(
            dev, torch.float32, nb, bs, nq, nkv, d, t, bt, rs, rq, rp,
            seed, uniform=True), atol=1e-4)
    # (b) GPT-124M geometry, bf16: a decode row at position 900, a
    # 200-token chunk straddling pages, a 4-token verify-like row, dead
    # rows and 51 padding tokens
    bt = _full_width_tables(1)
    mixed = _ragged_case(dev, torch.bfloat16, 512, 16, 12, 12, 64, 256, bt,
                         [0, 1, 201, 205, 205, 205, 205, 205],
                         [1, 200, 4, 0, 0, 0, 0, 0],
                         [900, 37, 500, 0, 0, 0, 0, 0], seed=2)
    err_mixed = check("gpt124m_mixed_T256", mixed, atol=2e-2)
    # decode-heavy: eight one-token rows deep in their contexts (T = 8)
    pos = np.random.RandomState(3).randint(600, 1000, size=8)
    decode = _ragged_case(dev, torch.bfloat16, 512, 16, 12, 12, 64, 8,
                          _full_width_tables(4), list(range(8)), [1] * 8,
                          pos, seed=5)
    err_decode = check("gpt124m_decode_T8", decode, atol=2e-2)
    # (c) GQA 4: 32 query heads on 8 kv heads, head_dim 128
    gqa = _ragged_case(dev, torch.bfloat16, 512, 16, 32, 8, 128, 64,
                       _full_width_tables(6)[:4],
                       [0, 1, 41, 41], [1, 40, 7, 0], [700, 90, 15, 0],
                       seed=7)
    check("gqa4_d128", gqa, atol=2e-2)
    # a page size and token count off every power of two, f32
    odd = _ragged_case(dev, torch.float32, 512, 5, 12, 12, 64, 13,
                       _full_width_tables(8, pages=64)[:2],
                       [0, 1], [1, 12], [222, 3], seed=9)
    check("bs5_T13_f32", odd, atol=1e-4)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timings = {}
    for label, args in (("decode_T8", decode), ("mixed_T256", mixed)):
        ms = time_ms(lambda: entry.kernel(*args), flush)
        plain_ms = time_ms(lambda: entry.plain(*args), flush)
        bound_ms, bound_by = _ragged_bound(args)
        timings[label] = (ms, plain_ms, bound_ms, bound_by)
        say("kernel_time", kernel=entry.name, shape=label, kernel_ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None,
            call_ms=call_ms(lambda: entry.kernel(*args)),
            plain_call_ms=call_ms(lambda: entry.plain(*args)))
    ms, plain_ms, bound_ms, bound_by = timings["mixed_T256"]
    return {"name": entry.name, "route": "cuda", "source": entry.source,
            "replaces": entry.replaces, "launches": None,
            "max_abs_err": max(err_mixed, err_decode), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call computes ragged paged attention
            "library_ms": None}


PARITY_PHASES = {"paged_ragged_attention": ragged_attention_phase}


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
    return name


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
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.ops.cuda import registry

    model = gpt_tiny(device=dev, num_layers=2, seed=0,
                     initializer_range=0.1)
    rng = np.random.RandomState(11)
    shared = list(rng.randint(0, 128, 16))
    prompts = [list(rng.randint(0, 128, 5)),
               list(rng.randint(0, 128, 23)),      # chunked: > budget
               shared + [7, 9, 2], shared + [4, 4]]
    eng = LLMEngine(model, device=dev, block_size=8, max_batch=4,
                    token_budget=16)
    registry.reset_counts()
    outs = eng.generate(prompts, max_new_tokens=8)
    launches = registry.counts()["paged_ragged_attention"]
    for p, out in zip(prompts, outs):
        ref = model.greedy_decode(p, 8)
        if not np.array_equal(out, ref):
            raise RuntimeError(f"engine {out.tolist()} != dense greedy "
                               f"{ref.tolist()}")
    want = eng.num_layers * eng.stats["launches"]
    say("exactness", prompts=len(prompts), steps=eng.stats["steps"],
        mixed_steps=eng.stats["mixed_steps"],
        prefix_hit_tokens=eng.prefix_cache_stats()["prefix_hit_tokens"],
        kernel_launches=launches, expected_launches=want)
    if launches != want or eng.stats["mixed_steps"] < 1:
        raise RuntimeError("exactness run did not go through the kernel "
                           "on every layer of every step, or mixed no "
                           "phases")


def serving_phase(dev):
    import torch

    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.models.gpt import gpt_124m
    from paddle_tpu_torch.ops.cuda import registry

    t0 = time.perf_counter()
    model = gpt_124m(device=dev, seed=0, dtype=torch.bfloat16)
    eng = LLMEngine(model, device=dev, dtype="bfloat16", block_size=16,
                    max_batch=8, token_budget=256,
                    enable_prefix_caching=True)
    setup_s = time.perf_counter() - t0
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
    sampled = {3: 101, 10: 202}          # request index -> seed
    new = 64

    registry.reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    warm = eng.warmup()
    t_start = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=new,
                            temperature=0.8 if i in sampled else 0.0,
                            seed=sampled.get(i))
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
    if launches["paged_ragged_attention"] != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")
    if eng.stats["mixed_steps"] < 1:
        raise RuntimeError("no step mixed prefill chunks with decodes")
    # the engine's first token of each greedy request is among the dense
    # bf16 forward's top 3 at the prompt's last position
    for i, r in enumerate(rids):
        if i in sampled:
            continue
        ids = torch.as_tensor(prompts[i], device=dev)[None]
        logits = model(ids)[0, -1].float()
        if not torch.isfinite(logits).all():
            raise RuntimeError("dense forward produced non-finite logits")
        top = logits.topk(3).indices.tolist()
        if int(outs[r].output_ids[0]) not in top:
            raise RuntimeError(f"request {i}: first token "
                               f"{int(outs[r].output_ids[0])} not in the "
                               f"dense top 3 {top}")

    ttft = [o.metrics["first_token"] - o.metrics["arrival"]
            for o in outs.values()]
    tpot = [(o.metrics["finished"] - o.metrics["first_token"]) / (new - 1)
            for o in outs.values()]
    generated = eng.stats["tokens_generated"]
    say("serving", model="gpt_124m", dtype="bfloat16", requests=len(rids),
        prompt_tokens=int(sum(len(p) for p in prompts)),
        prefix_hit_tokens=eng.prefix_cache_stats()["prefix_hit_tokens"],
        generated_tokens=generated, wall_s=wall,
        tokens_per_s=generated / wall,
        ttft_p50_ms=float(np.median(ttft)) * 1e3,
        tpot_p50_ms=float(np.median(tpot)) * 1e3,
        steps=eng.stats["steps"], mixed_steps=eng.stats["mixed_steps"],
        engine_launches=eng.stats["launches"], kernel_launches=launches,
        warmup_ms=warm, setup_s=setup_s,
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev))
    return launches, eng


def decode_profile_phase(eng, dev, window=16):
    """Where a decode step's time goes at GPT-124M width: 8 requests
    with 128-token prompts are prefilled, then ``window`` decode steps
    run on the host clock and ``window`` more under torch.profiler.
    Reports wall ms per step, device-busy ms per step (sum of device
    time in the profiled window) and the kernels that take the most
    device time.  Outside the main path: its launches are not counted
    in the ``kernels`` line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(99)
    for _ in range(eng.max_batch):
        eng.add_request(list(rng.randint(0, 50257, 128)),
                        max_new_tokens=4 * window)
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
    # device-side entries only (kernels, memcpy, memset): an operator's
    # own row would count its kernels a second time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    say("decode_profile", batch=eng.max_batch, steps=window,
        wall_ms_per_step=wall_ms,
        device_ms_per_step=(device_us / 1e3 / window if device_us
                            else None),
        device_busy_share=(device_us / 1e3 / window / wall_ms
                           if device_us else None),
        top_device_us_per_step={e.key[:60]: e.self_device_time_total
                                / window for e in top})
    while eng.has_unfinished():
        eng.step()


def main():
    if not os.path.isdir(os.path.join(ROOT, "paddle_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout that holds "
                         "paddle_tpu_torch/")
    sys.path.insert(0, ROOT)
    import torch

    name = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    from paddle_tpu_torch.ops.cuda import registry

    records = []
    for kname, entry in registry.KERNELS.items():
        if kname not in PARITY_PHASES:
            raise RuntimeError(f"kernel {kname} has no parity phase")
        records.append(PARITY_PHASES[kname](entry, dev))
    exactness_phase(dev)
    launches, eng = serving_phase(dev)
    decode_profile_phase(eng, dev)
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
