"""Elastic training manager (reference
python/paddle/distributed/fleet/elastic/manager.py:124).

The reference registers nodes in etcd and watches liveness; here the
registry is the native TCPStore (rank-0-hosted KV over DCN) — same
register/heartbeat/watch/scale semantics without an etcd dependency.
"""

import threading
import time


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    def __init__(self, store, node_id=None, np=1, heartbeat_interval=2.0,
                 timeout=10.0):
        """store: TCPStore client; np: expected node count."""
        self._store = store
        self.node_id = node_id if node_id is not None else "node0"
        self.np = np
        self.interval = heartbeat_interval
        self.timeout = timeout
        self._stop = threading.Event()
        self._thread = None
        self.need_restart = False

    # ---------------------------------------------------------- registry --
    def register(self):
        self._beat()
        self._store.add("/elastic/nodes/count", 1)

    def _beat(self):
        import struct
        self._store.set(f"/elastic/beat/{self.node_id}",
                        struct.pack("<d", time.time()))

    def start(self):
        self.register()

        def loop():
            while not self._stop.is_set():
                self._beat()
                self._stop.wait(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # ------------------------------------------------------------- watch --
    def dead_nodes(self, node_ids):
        """Nodes whose heartbeat is older than timeout (reference watch:605)."""
        import struct
        now = time.time()
        dead = []
        for nid in node_ids:
            raw = self._store.get_nowait(f"/elastic/beat/{nid}")
            if raw is None or len(raw) != 8:
                dead.append(nid)
                continue
            (ts,) = struct.unpack("<d", raw)
            if now - ts > self.timeout:
                dead.append(nid)
        return dead

    def rescale(self, node_ids):
        """New rank assignment over the surviving nodes (reference
        manager rewrites PADDLE_TRAINER_* env before relaunch).

        Returns ({node_id: new_rank}, dead_nodes)."""
        dead = set(self.dead_nodes(node_ids))
        alive = sorted(n for n in node_ids if n not in dead)
        return {nid: i for i, nid in enumerate(alive)}, sorted(dead)

    def watch(self, node_ids, on_change=None, poll=None):
        """Blocks until membership changes; returns (status, dead_nodes)."""
        poll = poll or self.interval
        while not self._stop.is_set():
            dead = self.dead_nodes(node_ids)
            if dead:
                self.need_restart = True
                if on_change is not None:
                    on_change(dead)
                return ElasticStatus.RESTART, dead
            time.sleep(poll)
        return ElasticStatus.EXIT, []
