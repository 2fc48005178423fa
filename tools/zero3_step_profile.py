"""Time and profile the host side of a ZeRO-3 (``p_g_os``) step at world
size 2: two gloo ranks on one device, GPT-124M in f32 with one sequence
of 1024 tokens a rank, AdamW with the global-norm clip, as
``chip_smoke.py distributed``'s ``distributed_world2`` leg runs it.

    python tools/zero3_step_profile.py [--root DIR] [--device cuda:0]
        [--steps 4] [--profile-steps 2] [--out FILE]

The script starts both ranks through ``paddle_tpu_torch.distributed
.launch``.  Each rank takes one step to warm up and then times
``--steps`` steps (synchronised, on the host clock).  Rank 0 then runs
``--profile-steps`` more under ``cProfile``.  The script prints each
rank's ms a step and rank 0's 25 functions of most own time.
``--root`` names the tree whose ``paddle_tpu_torch`` runs, so that one
copy of this script can measure two trees in one session.  ``--device
cpu --tiny`` runs a two-layer model on the host, for a quick check.
"""

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--profile-steps", type=int, default=2)
    ap.add_argument("--level", default="p_g_os")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank-out", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _rank(a):
    sys.path.insert(0, os.path.abspath(a.root))
    import numpy as np
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import gpt_124m, gpt_tiny

    dev = torch.device(a.device)
    env = dist.init_parallel_env(device=a.device, timeout=600)
    rank = env.rank
    build = gpt_tiny if a.tiny else gpt_124m
    model = build(device=dev, seed=0, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0))
    target, opt, _ = group_sharded_parallel(model, opt, level=a.level)
    step = TrainStep(target, lambda lg, lb: model.loss(lg, lb), opt)
    vocab = 128 if a.tiny else 50304
    seq = 16 if a.tiny else 1024
    rng = np.random.RandomState(77)
    ids = torch.as_tensor(rng.randint(0, vocab, (2, seq)), device=dev)
    labels = torch.as_tensor(rng.randint(0, vocab, (2, seq)), device=dev)
    mine = slice(rank, rank + 1)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one():
        return step(ids[mine], labels[mine]).item()

    one()
    ms = []
    for _ in range(a.steps):
        sync()
        t0 = time.perf_counter()
        one()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    rec = {"rank": rank, "ms_per_step": ms}
    prof = cProfile.Profile()
    sync()
    t0 = time.perf_counter()
    if rank == 0:
        prof.enable()
    for _ in range(a.profile_steps):
        one()
    sync()
    if rank == 0:
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(25)
        rec["profile"] = buf.getvalue()
    rec["profiled_ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                   / max(a.profile_steps, 1))
    with open(a.rank_out.replace("RANK", str(rank)), "w") as f:
        json.dump(rec, f)


def main(argv=None):
    a = _args(argv)
    if a.rank_out:
        return _rank(a)
    import tempfile

    tmp = tempfile.mkdtemp(prefix="zero3_profile_")
    rank_out = os.path.join(tmp, "rankRANK.json")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(a.root))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--log_dir", os.path.join(tmp, "logs"),
           os.path.abspath(__file__), "--root", a.root, "--device",
           a.device, "--steps", str(a.steps), "--profile-steps",
           str(a.profile_steps), "--level", a.level, "--rank-out", rank_out]
    if a.tiny:
        cmd.append("--tiny")
    proc = subprocess.run(cmd, cwd=os.path.abspath(a.root), env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        for r in range(2):
            log = os.path.join(tmp, "logs", f"workerlog.{r}")
            if os.path.exists(log):
                print(f"--- rank {r} ---\n" + open(log).read()[-4000:])
        print(proc.stderr[-3000:])
        return proc.returncode
    ranks = []
    for r in range(2):
        with open(rank_out.replace("RANK", str(r))) as f:
            ranks.append(json.load(f))
    summary = {"root": a.root, "level": a.level, "device": a.device,
               "model": "gpt_tiny" if a.tiny else "gpt_124m",
               "ms_per_step": [r["ms_per_step"] for r in ranks],
               "profiled_ms_per_step": [r["profiled_ms_per_step"]
                                        for r in ranks]}
    text = json.dumps(summary) + "\n" + ranks[0]["profile"]
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text)
    print(json.dumps(summary))
    print("\n".join(ranks[0]["profile"].splitlines()[:45]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
