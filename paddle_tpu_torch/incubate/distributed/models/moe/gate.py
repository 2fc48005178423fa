"""MoE gates: naive top-k, GShard top-2, Switch top-1.

Port of ``paddle_tpu/incubate/distributed/models/moe/gate.py``
(reference python/paddle/incubate/distributed/models/moe/gate/{naive,
gshard,switch}_gate.py): gates are functions of the token batch
returning the dense GShard (combine, dispatch) tensors, in torch.  The
jitter of ``SwitchGate`` draws from an explicit ``torch.Generator``.
"""

import numpy as np
import torch


def _capacity(num_tokens, num_experts, top_k, capacity_factor):
    cap = int(num_tokens * top_k * capacity_factor / num_experts)
    return max(cap, top_k)


def _one_hot(idx, num):
    return torch.nn.functional.one_hot(idx, num).to(torch.float32)


def topk_gating(logits, top_k, capacity_factor, jitter_key=None,
                jitter_eps=0.0):
    """Dense GShard-style gating.

    logits: [S, E].  Returns dict with:
      combine  [S, E, C] — combine weights (0 for dropped tokens)
      dispatch [S, E, C] bool — routing mask
      aux_loss — load-balance loss (GShard eq.4 / Switch eq.4)
      probs    [S, E]
    ``jitter_key`` is a ``torch.Generator`` on the logits' device; array
    logits (numpy or anything numpy reads) become a CPU tensor.
    """
    if not isinstance(logits, torch.Tensor):
        logits = torch.as_tensor(np.asarray(logits, np.float32))
    s, e = logits.shape
    c = _capacity(s, e, top_k, capacity_factor)
    if jitter_eps and jitter_key is not None:
        noise = torch.rand(logits.shape, generator=jitter_key,
                           device=logits.device, dtype=logits.dtype)
        logits = logits + jitter_eps * (2.0 * noise - 1.0)
    probs = torch.softmax(logits, dim=-1)                     # [S, E]

    combine = torch.zeros((s, e, c), dtype=torch.float32,
                          device=logits.device)
    remaining = probs
    # fill counts per expert as we take top-1, top-2, ...
    counts = torch.zeros((e,), dtype=torch.int32, device=logits.device)
    aux_me = torch.mean(probs, dim=0)                          # [E]
    fracs = torch.zeros((e,), dtype=torch.float32, device=logits.device)
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                  # [S]
        oh = _one_hot(idx, e)                                  # [S, E]
        # position of each token within its expert's capacity buffer
        pos = (torch.cumsum(oh, dim=0) - 1.0) + counts[None, :].to(
            torch.float32)
        pos_tok = torch.sum(pos * oh, dim=-1).to(torch.int32)  # [S]
        keep = pos_tok < c
        gate_k = torch.sum(probs * oh, dim=-1)                 # [S]
        comb_k = (gate_k * keep)[:, None, None] * oh[:, :, None] \
            * _one_hot(torch.clamp(pos_tok, 0, c - 1).long(), c)[:, None, :]
        combine = combine + comb_k
        counts = counts + torch.sum(oh * keep[:, None], dim=0).to(
            torch.int32)
        fracs = fracs + torch.mean(oh, dim=0)
        remaining = remaining * (1.0 - oh)                     # mask chosen
    # normalize combine weights over selected experts (sum over E,C)
    denom = torch.sum(combine, dim=(1, 2), keepdim=True)
    combine = combine / torch.clamp(denom, min=1e-9)
    dispatch = combine > 0.0
    aux_loss = e * torch.sum(aux_me * (fracs / top_k))
    return {"combine": combine, "dispatch": dispatch, "aux_loss": aux_loss,
            "probs": probs}


class BaseGate:
    def __init__(self, d_model, num_experts, top_k, capacity_factor):
        self.d_model = d_model
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor

    def __call__(self, logits, jitter_key=None):
        raise NotImplementedError


class NaiveGate(BaseGate):
    """Reference naive_gate.py: plain top-k softmax routing."""

    def __init__(self, d_model, num_experts, top_k=2, capacity_factor=2.0):
        super().__init__(d_model, num_experts, top_k, capacity_factor)

    def __call__(self, logits, jitter_key=None):
        return topk_gating(logits, self.top_k, self.capacity_factor)


class GShardGate(BaseGate):
    """Reference gshard_gate.py: top-2 with load-balance aux loss."""

    def __init__(self, d_model, num_experts, top_k=2, capacity_factor=2.0):
        super().__init__(d_model, num_experts, top_k, capacity_factor)

    def __call__(self, logits, jitter_key=None):
        return topk_gating(logits, self.top_k, self.capacity_factor)


class SwitchGate(BaseGate):
    """Reference switch_gate.py: top-1 routing with jitter."""

    def __init__(self, d_model, num_experts, top_k=1, capacity_factor=1.25,
                 jitter_eps=0.1):
        super().__init__(d_model, num_experts, 1, capacity_factor)
        self.jitter_eps = jitter_eps

    def __call__(self, logits, jitter_key=None):
        return topk_gating(logits, 1, self.capacity_factor,
                           jitter_key=jitter_key, jitter_eps=self.jitter_eps)
