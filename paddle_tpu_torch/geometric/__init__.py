"""paddle.geometric parity — graph message passing + sampling surface
(reference python/paddle/geometric/ over the graph ops in ops/graph_ops.py).
"""

from ..ops.graph_ops import (  # noqa: F401
    reindex_graph,
    segment_pool,
    send_u_recv,
    send_ue_recv,
    send_uv,
    weighted_sample_neighbors,
)
from ..ops.graph_ops import segment_pool as _segment_pool


def segment_sum(data, segment_ids):
    return _segment_pool(data, segment_ids, pooltype="SUM")


def segment_mean(data, segment_ids):
    return _segment_pool(data, segment_ids, pooltype="MEAN")


def segment_max(data, segment_ids):
    return _segment_pool(data, segment_ids, pooltype="MAX")


def segment_min(data, segment_ids):
    return _segment_pool(data, segment_ids, pooltype="MIN")
