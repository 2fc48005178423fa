"""paddle.distributed.spawn parity (reference
python/paddle/distributed/spawn.py): run ``func`` in nprocs subprocesses
with per-rank env, joined at the end."""

import multiprocessing as mp
import os


def _worker(func, rank, nprocs, master_port, args):
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    os.environ["PADDLE_MASTER"] = f"127.0.0.1:{master_port}"
    func(*args)


def spawn(func, args=(), nprocs=1, join=True, daemon=False, **options):
    ctx = mp.get_context("spawn")
    from .store import TCPStore

    store = TCPStore("127.0.0.1", 0, is_master=True, world_size=nprocs)
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(func, rank, nprocs, store.port, args),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        failed = [p.exitcode for p in procs if p.exitcode]
        if failed:
            raise RuntimeError(f"spawned processes failed: {failed}")
    return procs
