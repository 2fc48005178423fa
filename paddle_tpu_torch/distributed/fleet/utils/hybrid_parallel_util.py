"""Hybrid-parallel helpers (reference
python/paddle/distributed/fleet/utils/hybrid_parallel_util.py:
fused_allreduce_gradients :227 — the manual data-parallel grad sync used
by custom training loops, broadcast helpers for mp/sharding params).

Port of ``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``.
Under JAX the AVG collective of one global array a gradient is XLA's to
fuse.  The port runs one process a rank: ``fused_allreduce_gradients``
flattens the gradients of one dtype and device into one buffer, averages
it over the data-parallel group with one all-reduce and writes the
averages back (the reference's fusion).  The broadcasts send the group's
first rank's values; a parameter split over ``mp`` holds a different
block on each rank of the mp group and is left out of the mp broadcast,
as the reference leaves its distributed parameters out.
"""

import torch

from ...parallel import _leaf

__all__ = ["fused_allreduce_gradients", "broadcast_mp_parameters",
           "broadcast_dp_parameters"]


def fused_allreduce_gradients(parameter_list, hcg=None):
    """Average gradients across the data-parallel group (the default
    group without ``hcg``).  No-op when dp == 1."""
    from ... import communication as dist
    from ...group import _ensure_default_group

    group = None
    if hcg is not None:
        if hcg.get_data_parallel_world_size() <= 1:
            return
        group = hcg.get_data_parallel_group()
    if (group or _ensure_default_group()).nranks <= 1:
        return
    buckets = {}
    for p in parameter_list:
        g = _leaf(p).grad
        if g is not None:
            buckets.setdefault((g.dtype, g.device), []).append(g)
    for grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=group)
        off = 0
        with torch.no_grad():
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()


def _broadcast_params(parameters, group, skip_split=False):
    from ... import communication as dist

    if group.process_group is None or not group.is_member():
        return
    for p in parameters:
        if skip_split and "mp" in (getattr(p, "mesh_axes", None) or ()):
            continue
        dist.broadcast(_leaf(p), src=group.ranks[0], group=group)


def broadcast_mp_parameters(model, hcg):
    """Sync replicated params inside the model-parallel group (reference
    broadcast_mp_parameters)."""
    if hcg.get_model_parallel_world_size() <= 1:
        return
    _broadcast_params(model.parameters(), hcg.get_model_parallel_group(),
                      skip_split=True)


def broadcast_dp_parameters(model, hcg):
    """Rank-0 weights win across the dp group (reference
    broadcast_dp_parameters)."""
    if hcg.get_data_parallel_world_size() <= 1:
        return
    _broadcast_params(model.parameters(), hcg.get_data_parallel_group())
