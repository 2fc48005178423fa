"""Split-KV flash-decoding on the host: the split plan of the decode
attention kernels and the plain PyTorch version of their combine.

The kernels of ``csrc/decode_attention.cu`` (B6) and
``csrc/ragged_attention.cu`` (B1, B5) cut each query row's keys into
chunks of ``CHUNK`` keys, attend every chunk in a block of its own, and
merge the per-chunk partial softmax states in a second kernel, in split
order.  A partial of a row over split ``s`` (keys ``[s * CHUNK,
(s + 1) * CHUNK)`` below the row's key limit) is

    m   = max of the scores, in log2 units (score * log2 e)
    l   = sum of 2^(score * log2 e - m)
    acc = sum of 2^(score * log2 e - m) * v       [D], unnormalised

and the merged row is ``sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M)``
with ``M = max_s m_s`` over the row's first ``ceil(limit / CHUNK)``
splits.  A row with no visible key (limit <= 0) is exact zeros.

The ragged kernel's partials take :func:`ragged_slots` slots.
"""

import math

import torch

# keys per split: kChunk in csrc/split_decode.cuh, which says how it was
# chosen
CHUNK = 128
ROWS = 16           # kRows in csrc/split_decode.cuh: query rows per block
# the ragged partials stay indexed by token up to this size
TOKEN_SCRATCH_BYTES = 64 << 20
_LOG2E = 1.4426950408889634


def plan(max_keys):
    """The number of splits for rows of at most ``max_keys`` keys, the
    fewest with ``num_splits * CHUNK >= max_keys``.  It reads shapes
    only, never data on the card, so a launch needs no sync."""
    return max(1, -(-int(max_keys) // CHUNK))


def ragged_slots(num_tokens, num_rows, num_q_heads, num_kv_heads,
                 num_splits, head_dim):
    """Slots of the ragged kernel's partials, each ``num_q_heads x
    num_splits`` partials of ``head_dim + 2`` f32; the kernel reads its
    layout from their count.  One a token where that takes at most
    ``TOKEN_SCRATCH_BYTES`` or at most ``num_rows * tile`` slots (tile =
    ROWS // G tokens), and then every query tile splits; otherwise
    ``num_rows * tile``, one a token of a row's last tile, which alone
    splits (the others are walked whole)."""
    tile = ROWS // (num_q_heads // num_kv_heads)
    token_bytes = num_tokens * num_q_heads * num_splits * (head_dim + 2) * 4
    if num_tokens <= num_rows * tile or token_bytes <= TOKEN_SCRATCH_BYTES:
        return num_tokens
    return num_rows * tile


def partials_plain(q, k, v, limit, num_splits):
    """Per-split partial states in plain PyTorch, f32.

    q [N, Nq, D] against k / v [N, S, Nkv, D] (query head h reads kv
    head h // G); row n sees keys ``< limit[n]``.  Returns ``(acc [N,
    Nq, num_splits, D], m [N, Nq, num_splits], l [N, Nq, num_splits])``;
    a split with no visible key holds m = -1e30, l = 0, acc = 0."""
    n, nq, d = q.shape
    s_len, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    pad = num_splits * CHUNK - s_len
    if pad < 0:
        raise ValueError(f"{num_splits} splits of {CHUNK} keys do not cover "
                         f"{s_len} keys")
    k = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    scores = torch.einsum("bngd,bsnd->bngs", q.float().reshape(n, nkv, g, d),
                          k) * (_LOG2E / math.sqrt(d))
    pos = torch.arange(num_splits * CHUNK, device=q.device)
    visible = pos[None, :] < limit.to(q.device)[:, None]          # [N, S']
    visible = visible[:, None, None, :].expand_as(scores)
    scores = torch.where(visible, scores, -1e30)
    scores = scores.reshape(n, nkv, g, num_splits, CHUNK)
    visible = visible.reshape(scores.shape)
    m = scores.amax(-1)
    p = torch.where(visible, torch.exp2(scores - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bngsc,bscnd->bngsd", p,
                       v.reshape(n, num_splits, CHUNK, nkv, d))
    return (acc.reshape(n, nq, num_splits, d), m.reshape(n, nq, num_splits),
            l.reshape(n, nq, num_splits))


def merge_partials_plain(acc, m, l, limit):
    """The combine kernel in plain PyTorch: row n merges its first
    ``ceil(limit[n] / CHUNK)`` splits -> [N, Nq, D] f32, exact zeros
    where ``limit[n] <= 0``."""
    num_splits = m.shape[-1]
    limit = limit.to(m.device).long()
    live = torch.clamp((limit + CHUNK - 1) // CHUNK, 0, num_splits)
    used = (torch.arange(num_splits, device=m.device)[None, :]
            < live[:, None])[:, None, :].expand_as(m)
    big = torch.where(used, m, -torch.inf).amax(-1, keepdim=True)
    w = torch.where(used, torch.exp2(m - big), 0.0)
    # splits past a row's last are never read, as in the kernel
    out = (torch.where(used[..., None], acc * w[..., None], 0.0).sum(-2)
           / torch.where(used, l * w, 0.0).sum(-1, keepdim=True))
    return torch.where((limit > 0)[:, None, None], out, 0.0)
