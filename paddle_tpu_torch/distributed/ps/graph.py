"""Graph parameter server — server-side graph storage + neighbor sampling.

Reference: the GraphPS axis (paddle/fluid/distributed/ps/table/
common_graph_table.h — per-node adjacency with weighted
random_sample_neighbors — served by graph_brpc_server.cc).  TPU redesign:
the graph lives in the native C++ table (native/graph_table.cc) on host
CPUs; trainers sample neighbor sets over the existing PS TCP service and
only the resulting dense id/feature batches reach the device.  Multi-host
sharding routes nodes by ``node_id % num_servers`` — each server owns its
nodes' full adjacency (the reference's node-partitioned layout).
"""

import ctypes

import numpy as np

from ...core import native as _native
from . import _i64p
from .service import PsClient, PsServer, _lib_ps, register_ps_server


def _lib_graph():
    lib = _native.load()
    if lib is None:
        raise RuntimeError("native library unavailable; the graph table "
                           "requires the C++ runtime (g++)")
    if not hasattr(lib.pd_graph_create, "_bound"):
        lib.pd_graph_create.restype = ctypes.c_void_p
        lib.pd_graph_create.argtypes = [ctypes.c_uint64]
        lib.pd_graph_destroy.argtypes = [ctypes.c_void_p]
        lib.pd_graph_add_edges.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64]
        lib.pd_graph_num_nodes.restype = ctypes.c_int64
        lib.pd_graph_num_nodes.argtypes = [ctypes.c_void_p]
        lib.pd_graph_num_edges.restype = ctypes.c_int64
        lib.pd_graph_num_edges.argtypes = [ctypes.c_void_p]
        lib.pd_graph_degrees.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.pd_graph_sample_neighbors.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.pd_graph_save.restype = ctypes.c_int
        lib.pd_graph_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.pd_graph_load.restype = ctypes.c_int
        lib.pd_graph_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.pd_ps_graph_server_start.restype = ctypes.c_void_p
        lib.pd_ps_graph_server_start.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int]
        lib.pd_ps_client_graph_add_edges.restype = ctypes.c_int
        lib.pd_ps_client_graph_add_edges.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64]
        lib.pd_ps_client_graph_sample.restype = ctypes.c_int
        lib.pd_ps_client_graph_sample.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.pd_ps_client_graph_degrees.restype = ctypes.c_int
        lib.pd_ps_client_graph_degrees.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.pd_ps_client_graph_size.restype = ctypes.c_int
        lib.pd_ps_client_graph_size.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.pd_ps_client_graph_save.restype = ctypes.c_int
        lib.pd_ps_client_graph_save.argtypes = [ctypes.c_void_p,
                                                ctypes.c_char_p]
        lib.pd_ps_client_graph_load.restype = ctypes.c_int
        lib.pd_ps_client_graph_load.argtypes = [ctypes.c_void_p,
                                                ctypes.c_char_p]
        lib.pd_graph_create._bound = True
    return lib


def _f32p_or_null(arr):
    if arr is None:
        return None
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class GraphTable:
    """Host-side adjacency store with weighted neighbor sampling
    (common_graph_table parity, in-process)."""

    def __init__(self, seed=2026):
        self._lib = _lib_graph()
        self._h = self._lib.pd_graph_create(int(seed))

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.pd_graph_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def add_edges(self, src, dst, weights=None):
        src = np.ascontiguousarray(np.asarray(src).reshape(-1), np.int64)
        dst = np.ascontiguousarray(np.asarray(dst).reshape(-1), np.int64)
        assert len(src) == len(dst)
        w = None if weights is None else np.ascontiguousarray(
            np.asarray(weights, np.float32).reshape(-1))
        self._lib.pd_graph_add_edges(self._h, _i64p(src), _i64p(dst),
                                     _f32p_or_null(w), len(src))

    def num_nodes(self):
        return int(self._lib.pd_graph_num_nodes(self._h))

    def num_edges(self):
        return int(self._lib.pd_graph_num_edges(self._h))

    def degrees(self, nodes):
        nodes = np.ascontiguousarray(np.asarray(nodes).reshape(-1),
                                     np.int64)
        out = np.empty(len(nodes), np.int64)
        self._lib.pd_graph_degrees(self._h, _i64p(nodes), len(nodes),
                                   _i64p(out))
        return out

    def sample_neighbors(self, nodes, k):
        """(neighbors [n, k] padded -1, counts [n]); without replacement,
        weighted when edges carry weights."""
        nodes = np.ascontiguousarray(np.asarray(nodes).reshape(-1),
                                     np.int64)
        nbrs = np.empty((len(nodes), int(k)), np.int64)
        counts = np.empty(len(nodes), np.int64)
        self._lib.pd_graph_sample_neighbors(
            self._h, _i64p(nodes), len(nodes), int(k), _i64p(nbrs),
            _i64p(counts))
        return nbrs, counts

    def save(self, path):
        rc = self._lib.pd_graph_save(self._h, str(path).encode())
        if rc != 0:
            raise IOError(f"graph save failed rc={rc}")

    def load(self, path):
        rc = self._lib.pd_graph_load(self._h, str(path).encode())
        if rc != 0:
            raise IOError(f"graph load failed rc={rc}")


class GraphPsServer(PsServer):
    """Serves one graph shard over the PS TCP protocol (graph_brpc_server
    role)."""

    def __init__(self, graph, port=0):
        # PsServer.__init__ starts a TABLE server; replicate with the
        # graph entry point instead
        self._lib = _lib_ps()
        _lib_graph()  # ensure graph symbols are bound
        self.graph = graph  # keep alive: server borrows the handle
        self.table = None
        self._h = self._lib.pd_ps_graph_server_start(graph._h, int(port))
        if not self._h:
            raise RuntimeError("graph PS server failed to start")
        self.port = self._lib.pd_ps_server_port(self._h)


class GraphPsClient(PsClient):
    """Connection to one graph shard (graph ops over the PS protocol)."""

    def __init__(self, host, port, timeout=30.0):
        super().__init__(host, port, timeout=timeout)
        self._glib = _lib_graph()

    def add_edges(self, src, dst, weights=None):
        src = np.ascontiguousarray(np.asarray(src).reshape(-1), np.int64)
        dst = np.ascontiguousarray(np.asarray(dst).reshape(-1), np.int64)
        w = None if weights is None else np.ascontiguousarray(
            np.asarray(weights, np.float32).reshape(-1))
        rc = self._glib.pd_ps_client_graph_add_edges(
            self._h, _i64p(src), _i64p(dst), _f32p_or_null(w), len(src))
        if rc != 0:
            raise IOError(f"graph add_edges failed rc={rc}")

    def sample_neighbors(self, nodes, k):
        nodes = np.ascontiguousarray(np.asarray(nodes).reshape(-1),
                                     np.int64)
        nbrs = np.empty((len(nodes), int(k)), np.int64)
        counts = np.empty(len(nodes), np.int64)
        rc = self._glib.pd_ps_client_graph_sample(
            self._h, _i64p(nodes), len(nodes), int(k), _i64p(nbrs),
            _i64p(counts))
        if rc != 0:
            raise IOError(f"graph sample failed rc={rc}")
        return nbrs, counts

    def degrees(self, nodes):
        nodes = np.ascontiguousarray(np.asarray(nodes).reshape(-1),
                                     np.int64)
        out = np.empty(len(nodes), np.int64)
        rc = self._glib.pd_ps_client_graph_degrees(
            self._h, _i64p(nodes), len(nodes), _i64p(out))
        if rc != 0:
            raise IOError(f"graph degrees failed rc={rc}")
        return out

    def size(self):
        n = ctypes.c_int64()
        e = ctypes.c_int64()
        rc = self._glib.pd_ps_client_graph_size(self._h, ctypes.byref(n),
                                                ctypes.byref(e))
        if rc != 0:
            raise IOError("graph size failed")
        return int(n.value), int(e.value)

    def save(self, path):
        rc = self._glib.pd_ps_client_graph_save(self._h,
                                                str(path).encode())
        if rc != 0:
            raise IOError(f"graph save failed rc={rc}")

    def load(self, path):
        rc = self._glib.pd_ps_client_graph_load(self._h,
                                                str(path).encode())
        if rc != 0:
            raise IOError(f"graph load failed rc={rc}")


class DistributedGraphTable:
    """Node-sharded graph over multiple graph servers: node_id routes to
    server ``node % num_servers`` which owns its full adjacency
    (reference node-partitioned GraphPS layout)."""

    def __init__(self, endpoints, timeout=30.0):
        if not endpoints:
            raise ValueError("need at least one graph endpoint")
        self.clients = []
        for ep in endpoints:
            host, port = ep.rsplit(":", 1)
            self.clients.append(GraphPsClient(host, int(port),
                                              timeout=timeout))

    @property
    def num_servers(self):
        return len(self.clients)

    def _route(self, nodes):
        srv = (nodes.astype(np.uint64)
               % np.uint64(self.num_servers)).astype(np.int64)
        return [(np.nonzero(srv == i)[0], nodes[srv == i])
                for i in range(self.num_servers)]

    def add_edges(self, src, dst, weights=None):
        src = np.ascontiguousarray(np.asarray(src).reshape(-1), np.int64)
        dst = np.ascontiguousarray(np.asarray(dst).reshape(-1), np.int64)
        w = None if weights is None else \
            np.asarray(weights, np.float32).reshape(-1)
        for i, (pos, sub) in enumerate(self._route(src)):
            if len(sub):
                self.clients[i].add_edges(sub, dst[pos],
                                          None if w is None else w[pos])

    def sample_neighbors(self, nodes, k):
        nodes = np.ascontiguousarray(np.asarray(nodes).reshape(-1),
                                     np.int64)
        nbrs = np.full((len(nodes), int(k)), -1, np.int64)
        counts = np.zeros(len(nodes), np.int64)
        for i, (pos, sub) in enumerate(self._route(nodes)):
            if len(sub):
                nb, ct = self.clients[i].sample_neighbors(sub, k)
                nbrs[pos] = nb
                counts[pos] = ct
        return nbrs, counts

    def degrees(self, nodes):
        nodes = np.ascontiguousarray(np.asarray(nodes).reshape(-1),
                                     np.int64)
        out = np.zeros(len(nodes), np.int64)
        for i, (pos, sub) in enumerate(self._route(nodes)):
            if len(sub):
                out[pos] = self.clients[i].degrees(sub)
        return out

    def size(self):
        pairs = [c.size() for c in self.clients]
        return (sum(p[0] for p in pairs), sum(p[1] for p in pairs))

    def close(self):
        for c in self.clients:
            c.close()


def start_graph_server(index, store, port=0, seed=2026):
    """Create a graph shard + server and register it on the rendezvous
    store under ``ps/graph/{index}`` — a distinct namespace from the
    sparse-table servers' ``ps/server/{index}``, so hybrid jobs (tables +
    graph, the standard GraphPS deployment) never hand a trainer the
    wrong endpoint type."""
    graph = GraphTable(seed=seed + index)
    srv = GraphPsServer(graph, port=port)
    register_ps_server(store, index, srv.port, key_prefix="ps/graph")
    return srv


def wait_graph_endpoints(store, num_servers, timeout=60.0):
    from .service import wait_ps_endpoints

    return wait_ps_endpoints(store, num_servers, timeout=timeout,
                             key_prefix="ps/graph")
