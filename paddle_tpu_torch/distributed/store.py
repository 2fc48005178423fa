"""TCPStore — rendezvous KV for multi-host bootstrap and barriers.

API parity with ``paddle.distributed.TCPStore`` / ``core.TCPStore``
(reference: paddle/phi/core/distributed/store/tcp_store.h:120, used by
python/paddle/distributed/parallel.py:1076 for bootstrap).  Backed by the
native C++ server/client in ``native/tcp_store.cc``; a pure-Python fallback
speaks the *same* binary wire protocol, so native and fallback ranks can mix
within one cluster (op byte 1-6 | u32 klen | key | payload — see
tcp_store.cc).
"""

import ctypes
import socket
import socketserver
import struct
import threading
import time

from ..core import native as _native

_OP_SET, _OP_GET, _OP_ADD, _OP_WAIT, _OP_DEL, _OP_NUMKEYS = 1, 2, 3, 4, 5, 6
_OK, _NOT_FOUND = 0, 1


class _PyKV:
    """In-process store guts shared by the Python fallback server."""

    def __init__(self):
        self.lock = threading.Condition()
        self.kv = {}

    def set(self, key, value):
        with self.lock:
            self.kv[key] = bytes(value)
            self.lock.notify_all()

    def get(self, key):
        with self.lock:
            return self.kv.get(key)

    def add(self, key, delta):
        with self.lock:
            raw = self.kv.get(key, b"\0" * 8)
            # match the native server: non-8-byte values count as 0
            cur = (struct.unpack("<q", raw)[0] if len(raw) == 8 else 0) + delta
            self.kv[key] = struct.pack("<q", cur)
            self.lock.notify_all()
            return cur

    def wait(self, key):
        """Park until key exists (client enforces its own timeout)."""
        with self.lock:
            while key not in self.kv:
                self.lock.wait(1.0)


class TCPStore:
    """Distributed KV store. Rank ``is_master`` hosts; all ranks connect.

    >>> store = TCPStore("127.0.0.1", 0, is_master=True, world_size=2)
    >>> store.set("k", b"v"); store.get("k")
    b'v'
    """

    def __init__(self, host, port, is_master=False, world_size=1,
                 timeout=30.0):
        self.host = host
        self.is_master = is_master
        self.world_size = world_size
        self.timeout = timeout
        self._server = None
        self._py_server = None
        self._barrier_seq = {}
        self._lib = _native.load()
        if is_master:
            if self._lib is not None:
                self._server = self._lib.pd_store_server_start(int(port))
                if not self._server:
                    raise RuntimeError("TCPStore server failed: "
                                       + _native.last_error(self._lib))
                self.port = self._lib.pd_store_server_port(self._server)
            else:
                self._start_py_server(port)
        else:
            self.port = port
        # One connection PER THREAD: pd_store_* / _py_req are a full
        # request/response on one socket, so two threads sharing a
        # connection (e.g. an elastic heartbeat thread + the main thread's
        # watch loop) would interleave frames and poison the stream.
        self._tls = threading.local()
        self._all_conns = []          # every live conn, for close()
        self._conn_owners = {}        # thread ident -> conn (leak sweep)
        self._conns_lock = threading.Lock()
        self._require_client()        # eager: validates reachability

    # --------------------------------------------------------------- ops ---
    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        value = bytes(value)
        if self._lib is not None:
            rc = self._lib.pd_store_set(self._require_client(), key.encode(), value,
                                        len(value))
            if rc != 0:
                raise RuntimeError(f"TCPStore.set({key!r}) failed rc={rc}")
        else:
            self._py_req(_OP_SET, key,
                         struct.pack("<Q", len(value)) + value)

    def get(self, key, timeout=None):
        """Blocking get: waits until ``key`` exists, then returns its value.

        Matches reference TCPStore::get semantics (tcp_store.cc get() calls
        wait() first) so bootstrap code can rely on rank 0 publishing a key
        strictly before other ranks read it.  Raises TimeoutError if the key
        never appears.  Use :meth:`get_nowait` for a non-blocking probe.
        """
        self.wait([key], timeout=timeout)
        value = self.get_nowait(key)
        if value is None:
            # deleted between wait and get — treat like a missing key
            raise KeyError(f"TCPStore key {key!r} vanished after wait")
        return value

    def get_nowait(self, key):
        """Non-blocking probe: value bytes, or None if the key is absent."""
        if self._lib is not None:
            out = ctypes.c_void_p()
            length = ctypes.c_uint64()
            rc = self._lib.pd_store_get(self._require_client(), key.encode(),
                                        ctypes.byref(out), ctypes.byref(length))
            if rc == -2:
                return None
            if rc != 0:
                raise RuntimeError(f"TCPStore.get({key!r}) failed rc={rc}")
            try:
                return ctypes.string_at(out, length.value)
            finally:
                self._lib.pd_free(out)
        status, value = self._py_req(_OP_GET, key)
        return None if status == _NOT_FOUND else value

    def add(self, key, delta=1):
        if self._lib is not None:
            out = ctypes.c_int64()
            rc = self._lib.pd_store_add(self._require_client(), key.encode(), int(delta),
                                        ctypes.byref(out))
            if rc != 0:
                raise RuntimeError(f"TCPStore.add({key!r}) failed rc={rc}")
            return out.value
        _, value = self._py_req(_OP_ADD, key, struct.pack("<q", delta))
        return struct.unpack("<q", value)[0]

    def wait(self, keys, timeout=None):
        """Block until every key exists.

        A timed-out WAIT desynchronizes the request stream (the server may
        still send the reply later), so the connection is dropped — but a
        fresh one is transparently established before raising, keeping this
        store object usable for subsequent operations.
        """
        if isinstance(keys, str):
            keys = [keys]
        t = timeout if timeout is not None else self.timeout
        for key in keys:
            if self._lib is not None:
                rc = self._lib.pd_store_wait(self._require_client(), key.encode(),
                                             int(t * 1000))
                if rc != 0:
                    err = _native.last_error(self._lib)
                    self._reconnect()
                    if "timeout" in err:
                        raise TimeoutError(
                            f"TCPStore.wait({key!r}) timed out after {t}s")
                    raise RuntimeError(
                        f"TCPStore.wait({key!r}) failed: {err}")
            else:
                try:
                    self._py_req(_OP_WAIT, key, timeout_s=t)
                except (TimeoutError, OSError):
                    self._reconnect()
                    raise

    def _drop_conn(self, conn):
        with self._conns_lock:
            if conn in self._all_conns:
                self._all_conns.remove(conn)
            # unregister from the owner map too — otherwise the dead-thread
            # sweep would close the same native handle a second time
            # (double-free in the C library, not a catchable exception)
            for ident, c in list(self._conn_owners.items()):
                if c is conn:
                    del self._conn_owners[ident]
        try:
            if self._lib is not None:
                self._lib.pd_store_client_close(conn)
            else:
                conn.close()
        except Exception:
            pass

    def _reconnect(self):
        """Replace this thread's poisoned/closed connection with a fresh
        one.

        Bounded by a short timeout — this runs inside failure paths (a
        timed-out WAIT) where stalling the caller for the full store
        timeout would delay the original error by up to 30s.  On failure
        the thread's connection is marked failed; subsequent ops raise via
        :meth:`_require_client`.
        """
        short = min(self.timeout, 2.0)
        conn = getattr(self._tls, "client", None)
        if conn is not None:
            self._drop_conn(conn)
        self._tls.client = None
        if self._lib is not None:
            c = self._lib.pd_store_client_connect(
                self.host.encode(), self.port, int(short * 1000)) or None
        else:
            try:
                c = socket.create_connection((self.host, self.port),
                                             timeout=short)
                c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                c.settimeout(None)
            except OSError:
                c = None
        self._tls.client = c
        self._tls.failed = c is None
        if c is not None:
            with self._conns_lock:
                self._all_conns.append(c)
                if not isinstance(threading.current_thread(),
                                  threading._DummyThread):
                    self._conn_owners[threading.get_ident()] = c

    def _sweep_dead_threads(self):
        """Close connections whose owning thread has exited (runs when a
        NEW thread connects, so short-lived-thread patterns can't leak
        fds unboundedly).  Caller must not hold _conns_lock."""
        alive = {t.ident for t in threading.enumerate()}
        with self._conns_lock:
            dead = [(ident, c) for ident, c in self._conn_owners.items()
                    if ident not in alive]
            for ident, c in dead:
                del self._conn_owners[ident]
                if c in self._all_conns:
                    self._all_conns.remove(c)
        for _, c in dead:
            try:
                if self._lib is not None:
                    self._lib.pd_store_client_close(c)
                else:
                    c.close()
            except Exception:
                pass

    def _require_client(self):
        """This thread's connection handle, creating it on first use.

        Raises (rather than SIGSEGV-ing the C API with NULL) if this
        thread's last reconnect attempt failed."""
        c = getattr(self._tls, "client", None)
        if c is not None:
            return c
        if getattr(self._tls, "failed", False):
            raise RuntimeError(
                "store connection previously failed; reconnect required")
        self._sweep_dead_threads()
        if self._lib is not None:
            c = self._lib.pd_store_client_connect(
                self.host.encode(), self.port, int(self.timeout * 1000))
            if not c:
                self._tls.failed = True
                raise RuntimeError("TCPStore connect failed: "
                                   + _native.last_error(self._lib))
        else:
            c = self._connect_py()
        self._tls.client = c
        with self._conns_lock:
            self._all_conns.append(c)
            # foreign threads (no threading.Thread object) never appear in
            # threading.enumerate(), so the sweep could close their LIVE
            # conn; leave them out of the owner map (closed at store close)
            if not isinstance(threading.current_thread(),
                              threading._DummyThread):
                self._conn_owners[threading.get_ident()] = c
        return c

    def delete_key(self, key):
        if self._lib is not None:
            self._lib.pd_store_del(self._require_client(), key.encode())
        else:
            self._py_req(_OP_DEL, key)

    def num_keys(self):
        if self._lib is not None:
            out = ctypes.c_int64()
            self._lib.pd_store_num_keys(self._require_client(), ctypes.byref(out))
            return out.value
        _, value = self._py_req(_OP_NUMKEYS, "")
        return struct.unpack("<q", value)[0]

    def barrier(self, tag="default", timeout=None):
        """All world_size ranks arrive before any leaves.

        Re-entrant per tag: each instance tracks a per-tag epoch, so calling
        barrier() repeatedly in a loop synchronizes every round (as long as
        all ranks call it the same number of times).
        """
        seq = self._barrier_seq.get(tag, 0)
        self._barrier_seq[tag] = seq + 1
        prefix = f"/barrier/{tag}/{seq}"
        n = self.add(prefix + "/count", 1)
        if n == self.world_size:
            self.set(prefix + "/done", b"1")
        self.wait([prefix + "/done"], timeout=timeout)

    def __del__(self):
        try:
            for conn in list(getattr(self, "_all_conns", [])):
                try:
                    if self._lib is not None:
                        self._lib.pd_store_client_close(conn)
                    else:
                        conn.close()
                except Exception:
                    pass
            if self._lib is not None:
                if getattr(self, "_server", None):
                    self._lib.pd_store_server_stop(self._server)
            elif getattr(self, "_py_server", None) is not None:
                self._py_server.shutdown()
        except Exception:
            pass

    # -------------------------------------------------- python fallback ----
    def _start_py_server(self, port):
        kv = _PyKV()

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    hdr = self.rfile.read(5)
                    if len(hdr) < 5:
                        return
                    op = hdr[0]
                    klen = struct.unpack("<I", hdr[1:])[0]
                    key = self.rfile.read(klen).decode()
                    if op == _OP_SET:
                        vlen = struct.unpack("<Q", self.rfile.read(8))[0]
                        kv.set(key, self.rfile.read(vlen))
                        self._reply(_OK, b"")
                    elif op == _OP_GET:
                        v = kv.get(key)
                        self._reply(_NOT_FOUND if v is None else _OK, v or b"")
                    elif op == _OP_ADD:
                        d = struct.unpack("<q", self.rfile.read(8))[0]
                        self._reply(_OK, struct.pack("<q", kv.add(key, d)))
                    elif op == _OP_WAIT:
                        # park like the native server; the client times out
                        # on its side and poisons its connection
                        kv.wait(key)
                        self._reply(_OK, b"")
                    elif op == _OP_DEL:
                        with kv.lock:
                            kv.kv.pop(key, None)
                        self._reply(_OK, b"")
                    elif op == _OP_NUMKEYS:
                        with kv.lock:
                            n = len(kv.kv)
                        self._reply(_OK, struct.pack("<q", n))
                    else:
                        self._reply(_NOT_FOUND, b"")

            def _reply(self, status, payload):
                try:
                    self.wfile.write(bytes([status])
                                     + struct.pack("<Q", len(payload))
                                     + payload)
                except OSError:
                    pass  # client gone (e.g. timed out a WAIT)

        class Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._py_server = Srv(("0.0.0.0", port), Handler)
        self.port = self._py_server.server_address[1]
        threading.Thread(target=self._py_server.serve_forever,
                         daemon=True).start()

    def _connect_py(self):
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                s = socket.create_connection((self.host, self.port), timeout=5)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(None)  # per-request timeouts are set explicitly
                return s
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)

    def _py_req(self, op, key, payload=b"", timeout_s=None):
        """Send one request; returns (status, value).

        Any mid-request failure (notably a WAIT timeout) leaves the stream
        desynchronized, so the connection is closed and poisoned — mirroring
        the native client's behavior.
        """
        conn = self._require_client()
        key_b = key.encode()
        msg = bytes([op]) + struct.pack("<I", len(key_b)) + key_b + payload
        conn.settimeout(timeout_s if timeout_s is not None
                        else self.timeout)
        try:
            conn.sendall(msg)
            hdr = self._recv_n(conn, 9)
            status, vlen = hdr[0], struct.unpack("<Q", hdr[1:])[0]
            value = self._recv_n(conn, vlen)
        except socket.timeout:
            self._drop_conn(conn)
            self._tls.client = None
            self._tls.failed = True
            raise TimeoutError(
                f"TCPStore request op={op} key={key!r} timed out "
                "(connection closed; reconnect required)")
        except OSError:
            self._drop_conn(conn)
            self._tls.client = None
            self._tls.failed = True
            raise
        return status, value

    def _recv_n(self, conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("store connection closed")
            buf += chunk
        return buf
