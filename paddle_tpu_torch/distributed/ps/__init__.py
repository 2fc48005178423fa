"""The parameter-server stack (host-resident sparse tables, their
service, the graph tables and the hot-row cache) comes with ROADMAP
A23b-6c; each of its names raises ``NotImplementedError`` naming it.
"""

from .._later import A23B6C, later

__getattr__ = later(__name__, (
    "SparseTable", "DistributedEmbedding", "DistributedSparseTable",
    "GeoSGDWorker", "PsClient", "PsServer", "register_ps_server",
    "start_ps_server", "wait_ps_endpoints", "DistributedGraphTable",
    "GraphPsClient", "GraphPsServer", "GraphTable", "start_graph_server",
    "wait_graph_endpoints", "HotRowCache", "service", "graph", "heter"),
    A23B6C)
