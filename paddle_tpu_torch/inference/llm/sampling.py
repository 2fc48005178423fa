"""Per-row sampling suite for the ragged serving step.

Every request carries its own top-k / top-p / min-p / repetition /
presence / frequency / logit-bias knobs.  On the device the knobs ride
``[R = max_batch]`` vectors gathered through the token->row map, and
the two vocab-shaped channels (additive bias + token counts) ride
``[Tb, V]`` tensors; neutral values are exact identities (top_k 0,
top_p 1, min_p 0, penalties 1/0/0, bias 0, counts 0), so a row that
sets none of them passes through untouched.  The device argmax is
taken after the pipeline, and the host gumbel sampler draws from the
processed rows, so seeded streams stay the exactness mechanism.

Semantics:

- penalties see the token counts of *prompt + generated so far*.
  Repetition follows the HF rule (positive logits divide by the
  penalty, negative multiply); presence subtracts once per seen token,
  frequency subtracts count-weighted;
- filters apply to the unscaled distribution (temperature reshapes
  within the kept set on the host).  Order: penalties -> bias/masks ->
  top-k -> top-p -> min-p.  Filtered entries are set to
  :data:`FILTERED`, a large finite negative, so a host float64 softmax
  over a fetched row stays NaN-free.
"""

import math

import numpy as np
import torch

__all__ = ["FILTERED", "apply_logits_pipeline", "neutral_row_params",
           "token_counts", "validate_sampling"]

FILTERED = -1e30


# --------------------------------------------------------- device side ----
def apply_logits_pipeline(logits, rows, top_k, top_p, min_p, rep_pen,
                          pres_pen, freq_pen, bias, counts):
    """Transform one ragged step's ``[Tb, V]`` logits (f32 out).

    ``rows [Tb]`` maps each token to its descriptor row; the six ``[R]``
    vectors are per-row knobs gathered through it; ``bias`` and
    ``counts`` are per-token ``[Tb, V]`` channels.  Every transform is
    guarded by its own neutral test, so a row with default knobs passes
    through unchanged."""
    rows = rows.long()
    tk = top_k[rows].long()              # [Tb]
    tp = top_p[rows][:, None]            # [Tb, 1]
    mp = min_p[rows][:, None]
    rp = rep_pen[rows][:, None]
    pp = pres_pen[rows][:, None]
    fp = freq_pen[rows][:, None]
    x = logits.float()
    seen = counts > 0

    # repetition (HF rule) — guarded: rp == 1 rows are untouched
    rep = torch.where(x > 0, x / rp, x * rp)
    x = torch.where((rp != 1.0) & seen, rep, x)
    # presence / frequency — x - 0.0 is the identity when disabled
    x = x - torch.where(seen, pp, 0.0)
    x = x - fp * counts
    # additive bias (zeros when unused)
    x = x + bias

    v = x.shape[-1]
    # top-k: keep the k largest entries of each row (k == 0 disables)
    desc = torch.sort(x, dim=-1, descending=True).values
    kth = desc.gather(-1, (tk - 1).clamp(0, v - 1)[:, None])
    x = torch.where((tk > 0)[:, None] & (x < kth), FILTERED, x)
    # top-p: smallest prefix of the sorted softmax reaching mass top_p
    # (the first entry always survives; ties at the threshold survive)
    desc = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    kept = torch.where(before < tp, desc, math.inf)
    thr = kept.min(dim=-1, keepdim=True).values
    x = torch.where((tp < 1.0) & (x < thr), FILTERED, x)
    # min-p: drop tokens whose probability is below min_p * p(max) —
    # in logit space, x < max + log(min_p)
    xmax = x.max(dim=-1, keepdim=True).values
    floor = xmax + torch.log(mp.clamp(min=1e-38))
    return torch.where((mp > 0.0) & (x < floor), FILTERED, x)


# ----------------------------------------------------------- host side ----
def neutral_row_params(rmax):
    """The six per-row knob vectors at their identity values, in
    operand order: (top_k, top_p, min_p, rep_pen, pres_pen, freq_pen)."""
    return (np.zeros(rmax, np.int32),
            np.ones(rmax, np.float32),
            np.zeros(rmax, np.float32),
            np.ones(rmax, np.float32),
            np.zeros(rmax, np.float32),
            np.zeros(rmax, np.float32))


def token_counts(ids, vocab_size):
    """Occurrence counts of ``ids`` over the vocab as one f32 row — the
    penalties' counts channel for a single query position."""
    c = np.zeros(vocab_size, np.float32)
    np.add.at(c, np.asarray(ids, np.int64), 1.0)
    return c


def validate_sampling(top_k, top_p, min_p, repetition_penalty,
                      presence_penalty, frequency_penalty, logit_bias,
                      logprobs, stop, n, vocab_size=None):
    """Up-front request validation.  Returns the normalized
    ``(logit_bias, stop)`` pair: bias as ``{int: float}`` or None, stop
    as a tuple of non-empty strings."""
    if isinstance(top_k, bool) or not isinstance(top_k, (int, np.integer)) \
            or top_k < 0:
        raise ValueError(f"top_k must be an int >= 0 (0 disables), "
                         f"got {top_k!r}")
    if not isinstance(top_p, (int, float, np.integer, np.floating)) \
            or isinstance(top_p, bool) or not 0.0 < float(top_p) <= 1.0:
        raise ValueError(f"top_p must satisfy 0 < top_p <= 1, got {top_p!r}")
    if not isinstance(min_p, (int, float, np.integer, np.floating)) \
            or isinstance(min_p, bool) or not 0.0 <= float(min_p) <= 1.0:
        raise ValueError(f"min_p must satisfy 0 <= min_p <= 1, "
                         f"got {min_p!r}")
    for name, val in (("repetition_penalty", repetition_penalty),
                      ("presence_penalty", presence_penalty),
                      ("frequency_penalty", frequency_penalty)):
        if isinstance(val, bool) or \
                not isinstance(val, (int, float, np.integer, np.floating)) \
                or not math.isfinite(float(val)):
            raise ValueError(f"{name} must be a finite number, got {val!r}")
    if float(repetition_penalty) <= 0.0:
        raise ValueError(f"repetition_penalty must be > 0, "
                         f"got {repetition_penalty!r}")
    norm_bias = None
    if logit_bias:
        if not isinstance(logit_bias, dict):
            raise ValueError(f"logit_bias must be a dict of "
                             f"{{token_id: bias}}, got {logit_bias!r}")
        norm_bias = {}
        for tid, b in logit_bias.items():
            t = int(tid)
            if t < 0 or (vocab_size is not None and t >= vocab_size):
                raise ValueError(
                    f"logit_bias token id {tid!r} outside the vocab"
                    + (f" [0, {vocab_size})" if vocab_size else ""))
            if isinstance(b, bool) or \
                    not isinstance(b, (int, float, np.integer,
                                       np.floating)) \
                    or not math.isfinite(float(b)):
                raise ValueError(
                    f"logit_bias[{tid!r}] must be a finite number, "
                    f"got {b!r}")
            norm_bias[t] = float(b)
    if isinstance(logprobs, bool) or \
            not isinstance(logprobs, (int, np.integer)) or logprobs < 0:
        raise ValueError(f"logprobs must be an int >= 0 (top-N "
                         f"alternatives per token), got {logprobs!r}")
    if vocab_size is not None and logprobs > vocab_size:
        raise ValueError(f"logprobs={logprobs} exceeds the vocab size "
                         f"{vocab_size}")
    norm_stop = ()
    if isinstance(stop, str):
        stop = (stop,)          # "" becomes ("",) and fails below
    if stop:
        if not all(isinstance(s, str) and s for s in stop):
            raise ValueError(f"stop must be a non-empty string or a "
                             f"sequence of them, got {stop!r}")
        norm_stop = tuple(stop)
    if isinstance(n, bool) or not isinstance(n, (int, np.integer)) \
            or n < 1:
        raise ValueError(f"n must be an int >= 1 parallel samples, "
                         f"got {n!r}")
    return norm_bias, norm_stop
