"""MoELayer — expert-parallel mixture of experts.

Port of ``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``
(reference MoELayer, python/paddle/incubate/distributed/models/moe/
moe_layer.py:261, dispatching through the global_scatter/global_gather
collective ops).  The experts' weights are stacked on a leading expert
dim (``mesh_axes`` ("ep", ...)), and dispatch and combine are the JAX
einsums against the gate's dense [S, E, C] tensors.  Where the JAX
package leaves the expert dim to GSPMD, the port runs one process a
rank: with an expert-parallel ``group`` of n ranks each rank holds
``E/n`` experts (its block of the dense layer's), routes its own tokens
with the gate, and the dispatched [E, C, H] buffer goes out to the
experts' ranks and back by ``all_to_all_single`` (the all-to-all GSPMD
derives from the dispatch einsum), inside an autograd function whose
backward is the reverse all-to-all.  Without a group it is the stacked
dense form.  ``global_scatter``/``global_gather`` exchange equal chunks
over a group with ``all_to_all_single`` and keep the JAX package's
uniform-count restriction.
"""

import numpy as np
import torch

from .....core.tensor import Tensor
from .....distributed.communication import alltoall
from .....nn.initializer import Constant, Normal
from .....nn.layer_base import Layer
from .....ops.registry import op
from .gate import GShardGate, NaiveGate, SwitchGate

_GATES = {"gshard": GShardGate, "switch": SwitchGate, "naive": NaiveGate}
# jax.nn.gelu's default is the tanh form
_ACT = {"gelu": lambda h: torch.nn.functional.gelu(h, approximate="tanh"),
        "relu": torch.relu, "silu": torch.nn.functional.silu}


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return alltoall(x, group=group)

    @staticmethod
    def backward(ctx, g):
        return alltoall(g, group=ctx.group), None


def _ep_size(group):
    return 1 if group is None else group.nranks


@op("moe_forward")
def _moe_forward(x2d, wg, w1, b1, w2, b2, *, gate, jitter_key=None,
                 activation="gelu", group=None):
    """x2d: [S, H]; wg: [H, E]; w1: [E/n, H, F]; w2: [E/n, F, H] (the
    rank's experts over an expert-parallel ``group`` of n ranks, all E
    without one).  Returns (out [S, H], aux_loss scalar)."""
    logits = x2d.float() @ wg.float()
    g = gate(logits, jitter_key=jitter_key)
    combine, dispatch = g["combine"], g["dispatch"]
    # dispatch: [S,E,C] x [S,H] -> [E,C,H]  (the global_scatter analog)
    xd = torch.einsum("sec,sh->ech", dispatch.to(x2d.dtype), x2d)
    n = _ep_size(group)
    e, c, hdim = xd.shape
    if n > 1:
        # [n dst, E/n, C, H] out; [n src, E/n, C, H] in
        xd = _AllToAll.apply(xd, group).reshape(n, e // n, c, hdim)
        h = torch.einsum("nech,ehf->necf", xd, w1) + b1[None, :, None, :]
        h = _ACT[activation](h)
        eo = torch.einsum("necf,efh->nech", h, w2) + b2[None, :, None, :]
        eo = _AllToAll.apply(eo.reshape(e, c, hdim), group)
    else:
        h = torch.einsum("ech,ehf->ecf", xd, w1) + b1[:, None, :]
        h = _ACT[activation](h)
        eo = torch.einsum("ecf,efh->ech", h, w2) + b2[:, None, :]
    # combine: [S,E,C] x [E,C,H] -> [S,H]  (the global_gather analog)
    out = torch.einsum("sec,ech->sh", combine.to(eo.dtype), eo)
    return out, g["aux_loss"]


class MoELayer(Layer):
    """Expert-parallel FFN block.

    >>> moe = MoELayer(d_model=64, d_hidden=256, num_experts=8, gate="gshard")
    >>> y = moe(x)           # x: [B, T, d_model]
    >>> loss = task_loss + 0.01 * moe.l_aux

    With ``group`` (an expert-parallel group of n ranks) the layer keeps
    the rank's ``num_experts // n`` experts of the weights it drew (every
    rank draws the whole stack from the same seed), and each rank routes
    its own tokens (module docstring).
    """

    def __init__(self, d_model, d_hidden, num_experts, gate="gshard",
                 top_k=None, capacity_factor=None, activation="gelu",
                 group=None, recompute_interval=0, name=None):
        super().__init__()
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.activation = activation
        self.group = group if _ep_size(group) > 1 else None
        if isinstance(gate, str):
            cls = _GATES[gate]
            kw = {}
            if top_k is not None:
                kw["top_k"] = top_k
            if capacity_factor is not None:
                kw["capacity_factor"] = capacity_factor
            self.gate = cls(d_model, num_experts, **kw)
        else:
            self.gate = gate
        init = Normal(0.0, 0.02)
        self.gate_weight = self.create_parameter(
            (d_model, num_experts), default_initializer=init)
        self.w1 = self.create_parameter((num_experts, d_model, d_hidden),
                                        default_initializer=init)
        self.b1 = self.create_parameter((num_experts, d_hidden),
                                        default_initializer=Constant(0.0))
        self.w2 = self.create_parameter((num_experts, d_hidden, d_model),
                                        default_initializer=init)
        self.b2 = self.create_parameter((num_experts, d_model),
                                        default_initializer=Constant(0.0))
        n = _ep_size(self.group)
        if num_experts % n:
            raise ValueError(f"{num_experts} experts do not split over "
                             f"{n} expert-parallel ranks")
        k = num_experts // n
        r = self.group.rank if self.group is not None else 0
        # expert-parallel metadata: stacked expert dim over 'ep'
        for p_ in self._experts():
            if n > 1:
                p_._rebind(p_._data[r * k:(r + 1) * k].detach().clone()
                           .requires_grad_(p_._data.requires_grad))
            p_.mesh_axes = ("ep",) + (None,) * (len(p_.shape) - 1)
            p_.expert = True  # MoE-aware grad clip groups by this
        self.l_aux = None

    def _experts(self):
        return (self.w1, self.b1, self.w2, self.b2)

    def forward(self, x):
        shape = x.shape
        x2d = x.reshape([-1, self.d_model])
        jitter_key = None
        if self.training and getattr(self.gate, "jitter_eps", 0.0):
            from .....framework.random import generator
            jitter_key = generator(x2d._data.device if isinstance(
                x2d, Tensor) else x2d.device)
        for p_ in self._experts():
            # the optimizer hands the clip the parameters' tensors
            p_._data.expert = True
        out, aux = _moe_forward(
            x2d, self.gate_weight, self.w1, self.b1, self.w2, self.b2,
            gate=self.gate, jitter_key=jitter_key,
            activation=self.activation, group=self.group)
        self.l_aux = aux
        return out.reshape(shape)


# ----------------------------- global_scatter / global_gather parity ------

def global_scatter(x, local_count, global_count, group=None):
    """All-to-all token exchange over the expert group (reference
    global_scatter_op.cc semantics).  x: [S, H] already ordered by
    destination rank with per-rank counts; the chunks are exchanged with
    ``all_to_all_single``, so the counts must be uniform."""
    from .....distributed.group import _ensure_default_group

    g = group or _ensure_default_group()
    # the all-to-all below exchanges equal-size per-rank chunks; the
    # reference op supports ragged counts, which this path does not
    for counts in (local_count, global_count):
        if counts is not None:
            arr = np.asarray(counts)
            if arr.size and not (arr == arr.flat[0]).all():
                raise NotImplementedError(
                    "global_scatter/global_gather require uniform per-rank "
                    f"counts (got {arr.tolist()}); use MoELayer's "
                    "capacity-based dense dispatch for ragged routing")
    data = x._data if isinstance(x, Tensor) else x
    out = data if g.process_group is None or g.nranks == 1 else \
        _AllToAll.apply(data, g)
    return Tensor(out) if isinstance(x, Tensor) else out


def global_gather(x, local_count, global_count, group=None):
    """Inverse of global_scatter (reference global_gather_op.cc)."""
    return global_scatter(x, global_count, local_count, group=group)
