"""python -m paddle_tpu.distributed.launch — multi-process job launcher.

Reference: python/paddle/distributed/launch/main.py:18 (controllers build
per-rank env, master KV rendezvous, log dirs per rank).  TPU redesign: on a
TPU pod each *host* runs ONE process (single-controller per host, jax
multi-host runtime); the launcher's job is rank env + rendezvous via the
native TCPStore (rank 0 hosts) + log aggregation.  ``--nproc_per_node`` > 1
is supported for CPU testing (the reference's multi-process-per-box test
pattern, SURVEY §4.2).
"""

import argparse
import os
import signal
import subprocess
import sys
import time


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu.distributed.launch",
        description="Launch a distributed training job")
    p.add_argument("--master", default=None,
                   help="rendezvous endpoint host:port (default: self-host)")
    p.add_argument("--nnodes", type=int,
                   default=int(os.environ.get("PADDLE_NNODES", "1")))
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", "0")))
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--log_dir", default="log")
    p.add_argument("--job_id", default="default")
    p.add_argument("--max_restarts", type=int,
                   default=int(os.environ.get("PADDLE_MAX_RESTARTS", "0")),
                   help="elastic: relaunch the local ranks up to N times "
                        "after a failure (reference elastic/manager.py "
                        "watch->rescale->restart loop)")
    p.add_argument("--devices", default=None,
                   help="visible device ids, comma separated")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _coordinator_address(master):
    from ..parallel import coordinator_address
    return coordinator_address(master)


def _rank_env(args, local_rank, world_size, master):
    env = dict(os.environ)
    rank = args.node_rank * args.nproc_per_node + local_rank
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_TRAINERS_NUM": str(world_size),
        "PADDLE_NNODES": str(args.nnodes),
        "PADDLE_MASTER": master,
        "PADDLE_JOB_ID": args.job_id,
        # jax's coordination service needs its OWN port — the TCPStore
        # already owns the master port (convention: master port + 1)
        "JAX_COORDINATOR_ADDRESS": _coordinator_address(master),
    })
    if args.devices is not None:
        env["CUDA_VISIBLE_DEVICES"] = args.devices
        env["TPU_VISIBLE_DEVICES"] = args.devices
    return env


def launch(argv=None):
    args = _parse_args(argv)
    world_size = args.nnodes * args.nproc_per_node

    store = None
    if args.master is None:
        if args.nnodes > 1:
            # A self-hosted 127.0.0.1 endpoint is unreachable from other
            # nodes — the job would hang at bootstrap instead of failing
            # fast.  Multi-node requires an explicit routable master.
            raise SystemExit(
                "--master is required when --nnodes > 1 (the self-hosted "
                "rendezvous binds 127.0.0.1, which remote nodes cannot "
                "reach). Pass --master <node0_ip>:<port>.")
        # self-host the rendezvous KV on a free port (node 0 semantics)
        from ..store import TCPStore
        store = TCPStore("127.0.0.1", 0, is_master=True,
                         world_size=world_size)
        master = f"127.0.0.1:{store.port}"
    else:
        master = args.master

    os.makedirs(args.log_dir, exist_ok=True)

    procs = []

    def _spawn(restart_idx):
        """(Re)launch all local ranks; rank env is rebuilt each attempt
        (reference ElasticManager rewrites rank env before relaunch)."""
        local_procs, local_logs, files = [], [], []
        for local_rank in range(args.nproc_per_node):
            rank = args.node_rank * args.nproc_per_node + local_rank
            suffix = f".restart{restart_idx}" if restart_idx else ""
            log_path = os.path.join(args.log_dir,
                                    f"workerlog.{rank}{suffix}")
            logf = open(log_path, "w")
            files.append(logf)
            env = _rank_env(args, local_rank, world_size, master)
            env["PADDLE_RESTART_COUNT"] = str(restart_idx)
            cmd = [sys.executable, args.training_script] + \
                args.training_script_args
            local_procs.append(subprocess.Popen(
                cmd, env=env, stdout=logf, stderr=subprocess.STDOUT))
            local_logs.append(log_path)
        return local_procs, local_logs, files

    shutting_down = []  # non-empty once the operator asked us to stop

    def _teardown():
        """Kill remaining local ranks without marking operator shutdown —
        the elastic restart decision must stay based on WHY we tore down."""
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + 10
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    p.kill()

    def _terminate(*_):
        shutting_down.append(True)
        _teardown()

    signal.signal(signal.SIGTERM, _terminate)
    rc = 0
    restarts = 0
    logs, log_files = [], []
    try:
        while True:
            procs, logs, log_files = _spawn(restarts)
            rc = 0
            while any(p.poll() is None for p in procs):
                for p in procs:
                    code = p.poll()
                    if code is not None and code != 0 and rc == 0:
                        # one rank failed: tear down the rest (reference
                        # controller restart/abort policy) — but do NOT mark
                        # operator shutdown, or --max_restarts never fires.
                        # Keep the FIRST failing rank's code; the ranks
                        # _teardown kills exit -SIGTERM and must not mask it.
                        rc = code
                        _teardown()
                time.sleep(0.2)
            for p in procs:
                rc = rc or (p.returncode or 0)
            for f in log_files:
                try:
                    f.close()
                except OSError:
                    pass
            # an operator-initiated SIGTERM is a shutdown, not a rank
            # failure — never elastic-restart against the supervisor
            if rc == 0 or restarts >= args.max_restarts or shutting_down:
                break
            restarts += 1
            sys.stderr.write(
                f"[launch] job failed (exit {rc}); elastic restart "
                f"{restarts}/{args.max_restarts}\n")
            time.sleep(1)
    except KeyboardInterrupt:
        _terminate()
        rc = 130
    if rc != 0:
        sys.stderr.write(
            f"[launch] job failed (exit {rc}); logs: {', '.join(logs)}\n")
        tail = logs[0]
        try:
            with open(tail) as f:
                sys.stderr.write("".join(f.readlines()[-20:]))
        except OSError:
            pass
    return rc


if __name__ == "__main__":
    sys.exit(launch())
