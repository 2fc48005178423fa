"""paddle.distributed.rpc parity — worker-to-worker function calls.

Reference: python/paddle/distributed/rpc/rpc.py over the brpc C++ data
plane (paddle/fluid/distributed/rpc/).  API kept: init_rpc / rpc_sync /
rpc_async / get_worker_info / shutdown.

TPU redesign: RPC is host-side control-plane (the tensor data plane is
XLA collectives), so the transport is a plain length-prefixed TCP socket
per call with discovery through the TCPStore rendezvous — the same
plumbing the PS service and launcher already use.  Payloads are pickled
callables, so this is for trusted-cluster coordination exactly like the
reference (whose brpc endpoints execute registered python functions).
"""

import pickle
import socket
import struct
import threading
from concurrent.futures import Future

try:  # lambdas/closures serialize too (the reference's plain pickle can't)
    import cloudpickle as _serializer
except ImportError:  # pragma: no cover
    _serializer = pickle

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown",
           "get_worker_info", "get_all_worker_infos", "WorkerInfo"]


class WorkerInfo:
    def __init__(self, name, rank, ip, port):
        self.name = name
        self.rank = rank
        self.ip = ip
        self.port = port

    def __repr__(self):
        return (f"WorkerInfo(name={self.name}, rank={self.rank}, "
                f"ip={self.ip}, port={self.port})")


class _RpcState:
    def __init__(self):
        self.server = None
        self.workers = {}
        self.me = None
        self.store = None


_state = _RpcState()


def _recv_exact(conn, n):
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("rpc peer closed")
        buf += chunk
    return buf


def _send_msg(conn, obj):
    payload = _serializer.dumps(obj)
    conn.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv_msg(conn):
    (n,) = struct.unpack("<Q", _recv_exact(conn, 8))
    return _serializer.loads(_recv_exact(conn, n))


class _Server:
    def __init__(self, bind_ip="127.0.0.1"):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self.sock.bind((bind_ip, 0))
        except OSError as e:
            raise OSError(
                f"rpc server could not bind {bind_ip!r} ({e}); if this "
                "host cannot bind its advertised POD_IP (NAT/VIP), set "
                "PADDLE_RPC_BIND_IP to a local interface address "
                "(0.0.0.0 restores the old bind-all behavior)") from e
        self.sock.listen(64)
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self):
        self.sock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._serve_one, args=(conn,),
                             daemon=True).start()

    def _serve_one(self, conn):
        try:
            with conn:
                fn, args, kwargs = _recv_msg(conn)
                try:
                    result = fn(*args, **(kwargs or {}))
                    _send_msg(conn, ("ok", result))
                except BaseException as e:  # ship the remote error back
                    _send_msg(conn, ("err", e))
        except (ConnectionError, OSError):
            pass

    def stop(self):
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass


def init_rpc(name, rank=None, world_size=None, master_endpoint=None,
             store=None):
    """Start this worker's RPC server and rendezvous with the others.

    ``master_endpoint`` ("host:port" of the TCPStore) or an existing
    ``store`` client; reference signature parity (rpc.py init_rpc).
    """
    import os

    from ..store import TCPStore

    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0)) if rank is None \
        else rank
    world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", 1)) \
        if world_size is None else world_size
    if store is None:
        if master_endpoint is None:
            master_endpoint = os.environ.get("PADDLE_MASTER")
        if master_endpoint is None and world_size == 1:
            store = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
        elif master_endpoint is None:
            raise ValueError(
                "init_rpc: master_endpoint is required when world_size > 1 "
                "(or set PADDLE_MASTER / run under the launcher)")
        else:
            host, port = master_endpoint.rsplit(":", 1)
            store = TCPStore(host, int(port), is_master=False,
                             world_size=world_size)

    # Trust boundary: the server executes pickled callables, so it must
    # only be reachable inside the cluster.  Default: loopback for a
    # single-worker job; the worker's own POD_IP (not 0.0.0.0) otherwise.
    # PADDLE_RPC_BIND_IP overrides for multi-homed hosts.
    my_ip = os.environ.get("POD_IP", "127.0.0.1")
    bind_ip = os.environ.get("PADDLE_RPC_BIND_IP") or \
        ("127.0.0.1" if world_size == 1 else my_ip)
    _state.server = _Server(bind_ip=bind_ip)
    _state.store = store
    store.set(f"rpc/worker/{rank}",
              pickle.dumps((name, rank, my_ip, _state.server.port)))
    for r in range(world_size):
        info = WorkerInfo(*pickle.loads(store.get(f"rpc/worker/{r}",
                                                  timeout=60)))
        _state.workers[info.name] = info
        _state.workers[info.rank] = info
    _state.me = _state.workers[rank]
    return _state.me


def get_worker_info(name=None):
    if name is None:
        return _state.me
    return _state.workers[name]


def get_all_worker_infos():
    return sorted({id(w): w for w in _state.workers.values()}.values(),
                  key=lambda w: w.rank)


def _call(to, fn, args, kwargs, timeout):
    info = _state.workers[to]
    with socket.create_connection((info.ip, info.port),
                                  timeout=timeout) as conn:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _send_msg(conn, (fn, args, kwargs))
        conn.settimeout(timeout)
        status, payload = _recv_msg(conn)
    if status == "err":
        raise payload
    return payload


def rpc_sync(to, fn, args=(), kwargs=None, timeout=30.0):
    """Run ``fn(*args, **kwargs)`` on worker ``to`` (name or rank); block
    for the result.  Remote exceptions re-raise here (reference parity)."""
    if _state.server is None:
        raise RuntimeError("call init_rpc first")
    return _call(to, fn, tuple(args), kwargs, timeout)


def rpc_async(to, fn, args=(), kwargs=None, timeout=30.0):
    """Like rpc_sync but returns a Future (reference FutureWrapper)."""
    if _state.server is None:
        raise RuntimeError("call init_rpc first")
    fut = Future()

    def run():
        try:
            fut.set_result(_call(to, fn, tuple(args), kwargs, timeout))
        except BaseException as e:
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True).start()
    return fut


def shutdown():
    """Barrier with the other workers, then stop the server."""
    if _state.server is None:
        return
    try:
        if _state.store is not None:
            _state.store.barrier(tag="rpc_shutdown")
    except Exception:
        pass
    _state.server.stop()
    _state.server = None
    _state.workers.clear()
    _state.me = None
