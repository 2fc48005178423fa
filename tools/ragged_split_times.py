#!/usr/bin/env python3
"""Time the ragged paged-attention split kernels (B1, and B5 over int8
pools) at head dims 64 and 128 in f32, bf16 and f16, on one CUDA GPU.

    python3 tools/ragged_split_times.py
    PYTHONPATH=<another checkout> python3 tools/ragged_split_times.py

The second form times another checkout's ``paddle_tpu_torch`` (its
kernels build under that checkout), so two versions of
``csrc/ragged_attention.cu`` can be compared in one session on one
card.  Prints one JSON line per case (kernel ms, CUDA-graph replays
after an L2 flush as ``chip_smoke.py`` times them; the largest error
over the strict limit against the plain version), then one line with
the split kernels' registers and spills from the build's ptxas report.
Exits non-zero if a kernel disagrees with its plain version.
"""

import json
import os
import re
import sys

import numpy as np

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (the timing and case helpers)


def cases(dev, dtype, d):
    """(label, B1 args) at GPT-124M's geometry for D 64 (12/12 heads)
    and a GQA-4 one for D 128 (32/8 heads): decode T=8 at depths
    600-1000 and a mixed T=256 step."""
    nq, nkv = (12, 12) if d == 64 else (32, 8)
    pos = np.random.RandomState(3).randint(600, 1000, size=8)
    yield "decode_T8", cs._ragged_case(
        dev, dtype, 512, 16, nq, nkv, d, 8, cs._full_width_tables(4),
        list(range(8)), [1] * 8, pos, seed=5)
    yield "mixed_T256", cs._ragged_case(
        dev, dtype, 512, 16, nq, nkv, d, 256, cs._full_width_tables(1),
        [0, 1, 201, 205, 205, 205, 205, 205], [1, 200, 4, 0, 0, 0, 0, 0],
        [900, 37, 500, 0, 0, 0, 0, 0], seed=2)


def split_report(log):
    """{mangled split kernel: (registers, spill stores, spill loads)}."""
    out, fn, spill = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1) if "ragged_split_kernel" in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = (int(m.group(1)), *spill)
            fn = None
    return out


def main():
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.ops.cuda import _build, registry

    if not torch.cuda.is_available():
        raise SystemExit("ragged_split_times: no CUDA device")
    dev = torch.device("cuda", 0)
    tree = os.path.dirname(os.path.dirname(paddle_tpu_torch.__file__))
    log = _build.build(["ragged_attention"])["ragged_attention"][1]
    b1 = registry.KERNELS["paged_ragged_attention"]
    b5 = registry.KERNELS["paged_ragged_attention_quant"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bad = []
    for d in (64, 128):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for label, args in cases(dev, dtype, d):
                q, kp, vp = args[:3]
                f32_args = (q.float(), kp.float(), vp.float(), *args[3:])
                qargs = cs._quantized(f32_args, dtype)
                for entry, a, plain_a, pool in (
                        (b1, args, f32_args, "same"),
                        (b5, qargs, (qargs[0].float(), *qargs[1:]),
                         "int8")):
                    got = entry.kernel(*a)
                    rep = cs._parity(got, entry.plain(*plain_a), 1e-4)
                    if not rep[3]:
                        bad.append((entry.name, d, str(dtype), label, rep))
                    print(json.dumps({
                        "tree": tree, "kernel": entry.name, "head_dim": d,
                        "dtype": str(dtype)[6:], "pool": pool,
                        "case": label, "kernel_ms": cs.time_ms(
                            lambda: entry.kernel(*a), flush),
                        "err_over_limit": rep[2]}), flush=True)
    print(json.dumps({"tree": tree, "split_kernels": split_report(log)}),
          flush=True)
    if bad:
        raise SystemExit(f"ragged_split_times: kernels disagree: {bad}")


if __name__ == "__main__":
    main()
