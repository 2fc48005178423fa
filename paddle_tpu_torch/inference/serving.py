"""Predictor serving — the process boundary behind the C API.

Reference: the inference C/Go APIs (paddle/fluid/inference/capi_exp/,
goapi/) wrap an in-process C++ predictor.  Here the predictor's compute
lives in the Python/XLA runtime, so out-of-language callers get a
PROCESS boundary instead: ``PredictorServer`` serves a compiled
Predictor over a length-prefixed TCP protocol, and the native C client
(native/infer_client.cc, header paddle_native.h pd_infer_*) gives
C/C++/Go programs the familiar create/run/fetch surface.

Wire format (little-endian), shared with the C client:
  request : u32 n_inputs | per input: u8 dtype | u8 ndim | u64 dims[ndim]
            | raw bytes
  response: u8 status (0 ok) | u32 n_outputs | same tensor encoding
            (status 1: u32 len | utf-8 error message)
dtype codes: 0=f32 1=f64 2=i32 3=i64 4=u8 5=bool
"""

import socket
import struct
import threading

import numpy as np

_DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_]
_CODES = {np.dtype(d): i for i, d in enumerate(_DTYPES)}

# Wire-safety caps: a malformed/hostile request must not be able to make
# the server allocate unbounded memory before the predictor ever runs.
# max_bytes is a CUMULATIVE per-request budget across all input tensors.
_MAX_NDIM = 16
_MAX_INPUTS = 256
_MAX_TENSOR_BYTES = 1 << 31  # 2 GiB per request; override per-server below


def _send_tensor(conn, arr):
    arr = np.ascontiguousarray(arr)
    code = _CODES.get(arr.dtype)
    if code is None:
        arr = arr.astype(np.float32)
        code = 0
    conn.sendall(struct.pack("<BB", code, arr.ndim))
    conn.sendall(struct.pack(f"<{arr.ndim}Q", *arr.shape)
                 if arr.ndim else b"")
    conn.sendall(arr.tobytes())


def _recv_exact(conn, n):
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_tensor(conn, max_bytes=_MAX_TENSOR_BYTES):
    code, ndim = struct.unpack("<BB", _recv_exact(conn, 2))
    if code >= len(_DTYPES):
        raise ValueError(f"invalid wire dtype code {code}")
    if ndim > _MAX_NDIM:
        raise ValueError(f"tensor ndim {ndim} exceeds limit {_MAX_NDIM}")
    dims = struct.unpack(f"<{ndim}Q", _recv_exact(conn, 8 * ndim)) \
        if ndim else ()
    dtype = np.dtype(_DTYPES[code])
    n_elems = 1
    for d in dims:
        n_elems *= d
    # python ints can't overflow, so one post-product check suffices —
    # and it also covers scalars (ndim==0) against an exhausted budget
    if n_elems * dtype.itemsize > max_bytes:
        raise ValueError(f"tensor payload exceeds {max_bytes} byte limit")
    n_bytes = n_elems * dtype.itemsize
    raw = _recv_exact(conn, n_bytes)
    return np.frombuffer(raw, dtype=dtype).reshape(dims).copy()


class _GenerativeAdapter:
    """Predictor-shaped front of an LLM engine.

    Wire contract (same tensor encoding as Predictor): input 0 is the
    prompt token ids (int32/int64, [T] or [1, T]); optional scalar
    inputs: 1 = max_new_tokens (default 16), 2 = temperature (float,
    default 0.0 = greedy), 3 = seed (int; pins the request's sampling
    stream so a sampled completion is reproducible per request, not per
    server arrival order).  The response is one [1, T+new] int64
    tensor.  Each socket connection runs in its own thread, so
    concurrent clients batch inside the engine's continuous-batching
    decode step — the socket path gains multi-tenant batching without a
    protocol change.
    """

    _DEFAULT_MAX_NEW = 16

    def __init__(self, engine):
        from .llm import AsyncLLMEngine, LLMEngine
        from .llm.fleet import Fleet

        # a Fleet mirrors the engine surface AsyncLLMEngine drives, so
        # replicated serving needs no adapter of its own
        self._async = (AsyncLLMEngine(engine)
                       if isinstance(engine, (LLMEngine, Fleet))
                       else engine)

    @staticmethod
    def _scalar(inputs, i, cast, default):
        if len(inputs) <= i:
            return default
        return cast(np.asarray(inputs[i]).reshape(-1)[0])

    def run(self, inputs):
        if not inputs:
            raise ValueError("generative request needs a token-id tensor")
        ids = np.asarray(inputs[0])
        if not np.issubdtype(ids.dtype, np.integer):
            raise ValueError("generative input 0 must be integer token ids")
        max_new = self._scalar(inputs, 1, int, self._DEFAULT_MAX_NEW)
        temperature = self._scalar(inputs, 2, float, 0.0)
        seed = self._scalar(inputs, 3, int, None)
        deadline_ms = self._scalar(inputs, 4, float, None)
        # validate BEFORE submitting: a bad knob must come back as a
        # clear wire error, not an odd empty generation (the engine
        # re-checks, but by then the request would be half-queued)
        if max_new < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new}")
        if temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {temperature}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {deadline_ms}")
        out = self._async.generate(ids.reshape(-1),
                                   max_new_tokens=max_new,
                                   temperature=temperature, seed=seed,
                                   deadline_ms=deadline_ms)
        if not out.ok:
            # a shed/deadline/quarantined request must surface as a wire
            # ERROR, not as a truncated completion the client can't tell
            # from a short generation
            detail = f": {out.error}" if out.error else ""
            raise RuntimeError(
                f"request finished with reason "
                f"{out.finish_reason!r}{detail}")
        return [out.all_ids.astype(np.int64)[None]]

    def stop(self):
        self._async.close()


class PredictorServer:
    """Serve a Predictor to out-of-process (C/C++/Go) callers.

    >>> cfg = Config(); cfg.set_model_obj(model)
    >>> srv = PredictorServer(create_predictor(cfg))     # port=0: free port
    >>> # C side: pd_infer_connect("127.0.0.1", srv.port) ... pd_infer_run

    Generative models serve through the same socket protocol by passing
    ``engine=LLMEngine(model)`` instead of a predictor: requests carry
    token ids (+ optional max_new_tokens scalar) and concurrent
    connections batch inside the engine (see _GenerativeAdapter).
    ``fleet=Fleet(model, replicas=N)`` serves N health-checked replicas
    behind the same socket — affinity routing, failover and drains all
    happen below the wire protocol, invisible to clients.

    Trust boundary: the protocol is unauthenticated (reference C API is an
    in-process library), so the listener defaults to loopback.  Pass
    ``host="0.0.0.0"`` explicitly to serve a trusted network; ``max_bytes``
    caps each request tensor's payload.
    """

    def __init__(self, predictor=None, host="127.0.0.1", port=0,
                 max_bytes=_MAX_TENSOR_BYTES, engine=None, faults=None,
                 fleet=None):
        backends = [b for b in (predictor, engine, fleet)
                    if b is not None]
        if len(backends) != 1:
            raise ValueError(
                "pass exactly one of predictor=, engine= or fleet=")
        self._predictor = (predictor if predictor is not None
                           else _GenerativeAdapter(engine if engine
                                                   is not None else fleet))
        self._max_bytes = max_bytes
        # fault injection at the socket layer: a FaultInjector whose
        # "socket"-site faults make the server drop or truncate a
        # response, so client-side robustness (reconnect, short-read
        # detection) is testable deterministically
        self._faults = faults
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        self._sock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                # transient accept errors (ECONNABORTED: the peer gave
                # up during the handshake) must not kill the server —
                # only a deliberate stop() (which closes the listener)
                # ends the loop
                if self._stop.is_set():
                    break
                continue
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            with conn:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                while True:
                    try:
                        (n_in,) = struct.unpack("<I", _recv_exact(conn, 4))
                    except ConnectionError:
                        return
                    try:
                        if n_in > _MAX_INPUTS:
                            raise ValueError(
                                f"n_inputs {n_in} exceeds limit "
                                f"{_MAX_INPUTS}")
                        budget = self._max_bytes
                        inputs = []
                        for _ in range(n_in):
                            t = _recv_tensor(conn, budget)
                            budget -= t.nbytes
                            inputs.append(t)
                    except (ValueError, struct.error, OverflowError) as e:
                        # malformed frame: report it explicitly, then
                        # drop the (desynced) connection — NEVER let a
                        # bad client frame propagate past this handler
                        msg = str(e).encode()[:4096]
                        conn.sendall(struct.pack("<BI", 1, len(msg)) + msg)
                        return
                    if self._inject_socket_fault(conn):
                        return      # this connection dies; server lives
                    try:
                        outs = self._predictor.run(inputs)
                        conn.sendall(struct.pack("<BI", 0, len(outs)))
                        for o in outs:
                            _send_tensor(conn, np.asarray(o))
                    except Exception as e:  # ship the error, keep serving
                        msg = str(e).encode()[:4096]
                        conn.sendall(struct.pack("<BI", 1, len(msg)) + msg)
        except (ConnectionError, OSError):
            # a dead peer (disconnect / short read mid-frame) fails only
            # THIS connection thread; the accept loop never sees it
            pass

    def _inject_socket_fault(self, conn):
        """Apply a scheduled socket-site fault to this response.
        Returns True when the connection was sacrificed."""
        if self._faults is None:
            return False
        kind = self._faults.socket_fault()
        if kind == "disconnect":
            conn.close()            # vanish before the response
            return True
        if kind == "partial":
            # half a response header, then gone: the client's framing
            # layer must detect the short read, not hang
            try:
                conn.sendall(struct.pack("<BI", 0, 1)[:3])
            except OSError:
                pass
            conn.close()
            return True
        return False

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if isinstance(self._predictor, _GenerativeAdapter):
            self._predictor.stop()
