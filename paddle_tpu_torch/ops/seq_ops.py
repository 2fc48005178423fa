"""Sequence ops: the RNN op, CTC and RNN-T losses, decoding, framing.

Port of ``paddle_tpu/ops/seq_ops.py``.  Every ``lax.scan`` of the JAX
body is a Python loop over its steps here, each step a few device ops
over the whole batch (the JAX ``vmap``); no step reads a value on the
host.  ``warpctc`` is the forward recursion of ``optax.ctc_loss``,
which the JAX op calls, step for step: ``log(0)`` is ``-1e5``, so an
impossible alignment gives a large finite loss, not ``inf`` as
``torch.nn.functional.ctc_loss`` would.  ``rnn`` is the op only (the
``nn.RNN`` layers are ROADMAP A23b-3).
"""

import torch

from .registry import op

_tF = torch.nn.functional
_f32 = torch.float32

# ------------------------------------------------------------------- RNN


def _lstm_cell(x, h, c, wi, wh, bi, bh):
    g = x @ wi.T + h @ wh.T + bi + bh
    i, f, gg, o = torch.chunk(g, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(gg)
    return torch.tanh(c_new) * o, c_new


def _gru_cell(x, h, wi, wh, bi, bh):
    ri, zi, ni = torch.chunk(x @ wi.T + bi, 3, dim=-1)
    rh, zh, nh = torch.chunk(h @ wh.T + bh, 3, dim=-1)
    r = torch.sigmoid(ri + rh)
    z = torch.sigmoid(zi + zh)
    n = torch.tanh(ni + r * nh)
    return (1 - z) * n + z * h


def _run_layer(x, h0, c0, weights, mode, reverse=False):
    """x [T,B,I] -> (out [T,B,H], h_T, c_T)."""
    wi, wh, bi, bh = weights
    steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    h, c = h0, c0
    outs = [None] * x.shape[0]
    act = torch.tanh if mode == "RNN_TANH" else torch.relu
    for t in steps:
        if mode == "LSTM":
            h, c = _lstm_cell(x[t], h, c, wi, wh, bi, bh)
        elif mode == "GRU":
            h = _gru_cell(x[t], h, wi, wh, bi, bh)
        else:
            h = act(x[t] @ wi.T + h @ wh.T + bi + bh)
        outs[t] = h
    return torch.stack(outs), h, c


@op()
def rnn(x, pre_state, weight_list, sequence_length=None, dropout_prob=0.0,
        is_bidirec=False, input_size=0, hidden_size=0, num_layers=1,
        mode="LSTM", seed=0, is_test=False):
    """Multi-layer (bi)directional RNN; x [T,B,I] (time-major).
    weight_list per layer per direction: [w_ih, w_hh, b_ih, b_hh]."""
    num_dir = 2 if is_bidirec else 1
    h0_all = pre_state[0]
    c0_all = pre_state[1] if mode == "LSTM" and len(pre_state) > 1 else \
        torch.zeros_like(h0_all)
    out = x
    h_finals, c_finals = [], []
    wptr = 0
    for layer in range(num_layers):
        outs_dir = []
        for d in range(num_dir):
            idx = layer * num_dir + d
            w = tuple(weight_list[wptr:wptr + 4])
            wptr += 4
            o, h_t, c_t = _run_layer(out, h0_all[idx], c0_all[idx], w, mode,
                                     reverse=(d == 1))
            outs_dir.append(o)
            h_finals.append(h_t)
            c_finals.append(c_t)
        out = torch.cat(outs_dir, dim=-1) if num_dir == 2 else outs_dir[0]
    h_out, c_out = torch.stack(h_finals), torch.stack(c_finals)
    if sequence_length is not None:
        t = out.shape[0]
        mask = torch.arange(t, device=x.device)[:, None] < \
            sequence_length.to(x.device)[None, :]
        out = out * mask[..., None].to(out.dtype)
    if mode == "LSTM":
        return out, (h_out, c_out)
    return out, (h_out,)


# ------------------------------------------------------------------- CTC

def _ctc_optax(logits, logit_paddings, labels, label_paddings, blank_id=0,
               log_epsilon=-1e5):
    """``optax.ctc_loss``: logits [B,T,K], paddings 1.0 past each length,
    labels [B,N] -> per-sequence loss [B]."""
    b, t, k = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = n - label_paddings.sum(dim=1).to(torch.int32)
    repeat = (labels[:, :-1] == labels[:, 1:]).to(_f32)
    repeat = _tF.pad(repeat, (0, 1))
    logprobs_phi = logprobs[:, :, blank_id:blank_id + 1].transpose(0, 1)
    valid = (labels >= 0) & (labels < k)
    lab = torch.clamp(labels, 0, k - 1).long()
    emit = torch.gather(logprobs, 2, lab[:, None, :].expand(b, t, n))
    emit = (emit * valid[:, None, :]).transpose(0, 1)          # [T,B,N]
    dev = logits.device
    phi = torch.full((b, n + 1), log_epsilon, dtype=_f32, device=dev)
    phi = torch.cat([torch.zeros((b, 1), dtype=_f32, device=dev),
                     phi[:, 1:]], dim=1)
    emit_a = torch.full((b, n), log_epsilon, dtype=_f32, device=dev)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], dim=-1)

    pads = logit_paddings.transpose(0, 1)
    for step in range(t):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit_a + log_epsilon * repeat)
        lp_emit, lp_phi = emit[step], logprobs_phi[step]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit,
                                    emit_a + lp_emit)
        next_phi = prev_phi + lp_phi
        next_phi = update_phi(next_phi,
                              emit_a + lp_phi + log_epsilon * (1.0 - repeat))
        pad = pads[step].reshape(b, 1)
        emit_a = pad * emit_a + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit_a)
    return -torch.gather(last, 1, labellens.long()[:, None])[:, 0]


@op()
def warpctc(logits, label, logits_length=None, labels_length=None,
            blank=0, norm_by_times=False):
    """CTC loss.  logits [T,B,C] (the warpctc layout); label [B,L]."""
    if logits.dim() != 3:
        raise ValueError("warpctc expects rank-3 logits")
    t, b, _ = logits.shape
    dev = logits.device
    lg = logits.transpose(0, 1).float()
    if logits_length is None:
        logits_length = torch.full((b,), t, dtype=torch.int32, device=dev)
    lab = label.to(torch.int32)
    if labels_length is None:
        labels_length = (lab != blank).sum(-1).to(torch.int32)
    tpad = (torch.arange(t, device=dev)[None, :]
            >= logits_length[:, None]).to(_f32)
    lpad = (torch.arange(lab.shape[1], device=dev)[None, :]
            >= labels_length[:, None]).to(_f32)
    loss = _ctc_optax(lg, tpad, lab, lpad, blank_id=blank)
    if norm_by_times:
        loss = loss / torch.clamp(logits_length.float(), min=1)
    return loss


# ----------------------------------------------------------------- RNN-T

@op()
def warprnnt(logits, label, input_lengths, label_lengths, blank=0,
             fastemit_lambda=0.0):
    """RNN-T loss, a log-space DP over t then u.  logits [B,T,U+1,C];
    label [B,U]."""
    b, t, u1, _ = logits.shape
    lp = torch.log_softmax(logits.float(), dim=-1)
    lab = label.long()
    blank_lp = lp[:, :, :, blank]                              # [B,T,U+1]
    emit_lp = torch.gather(lp[:, :, :-1, :], 3,
                           lab[:, None, :, None].expand(
                               b, t, u1 - 1, 1))[..., 0]       # [B,T,U]
    a0 = torch.cat([torch.zeros((b, 1), device=lp.device),
                    torch.cumsum(emit_lp[:, 0], dim=1)], dim=1)
    rows = [a0]
    alpha = a0
    for ti in range(1, t):
        from_top = alpha + blank_lp[:, ti - 1]
        vals = [from_top[:, 0]]
        for u in range(1, u1):
            vals.append(torch.logaddexp(from_top[:, u],
                                        vals[-1] + emit_lp[:, ti, u - 1]))
        alpha = torch.stack(vals, dim=1)
        rows.append(alpha)
    alphas = torch.stack(rows, dim=1)                          # [B,T,U+1]
    bi = torch.arange(b, device=lp.device)
    tl = input_lengths.long() - 1
    ul = label_lengths.long()
    return -(alphas[bi, tl, ul] + blank_lp[bi, tl, ul])


# --------------------------------------------------------------- decoding

@op()
def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True):
    """CRF Viterbi.  potentials [B,T,N]; transition [N+2,N+2] with the
    BOS/EOS rows, or [N,N]."""
    pot = potentials.float()
    trans = transition_params.float()
    b, t, n = pot.shape
    dev = pot.device
    zeros = torch.zeros((n,), device=dev)
    if include_bos_eos_tag and trans.shape[0] == n + 2:
        start, stop, core = trans[n, :n], trans[:n, n + 1], trans[:n, :n]
    else:
        start, stop, core = zeros, zeros, trans
    ln = lengths.to(torch.int32).to(dev)
    alpha = pot[:, 0] + start
    ar = torch.arange(n, device=dev).expand(b, n)
    backptrs = []
    for step in range(1, t):
        v = (step < ln)[:, None]
        scores = alpha[:, :, None] + core
        bp = torch.argmax(scores, dim=1)
        alpha_new = scores.amax(dim=1) + pot[:, step]
        alpha = torch.where(v, alpha_new, alpha)
        backptrs.append(torch.where(v, bp, ar))
    if include_bos_eos_tag:
        alpha = alpha + stop
    best = torch.argmax(alpha, dim=1)
    score = alpha.amax(dim=1)
    path = [best]
    tag = best
    for bp in reversed(backptrs):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    return score, torch.stack(path[::-1], dim=1).to(torch.int64)


@op()
def gather_tree(ids, parents):
    """Beam-search backtrace: ids/parents [T, B, W] -> full paths."""
    t, b, w = ids.shape
    beam = torch.arange(w, device=ids.device).expand(b, w)
    toks = [None] * t
    for step in range(t - 1, -1, -1):
        toks[step] = torch.gather(ids[step], 1, beam)
        beam = torch.gather(parents[step], 1, beam)
    return torch.stack(toks)


@op()
def edit_distance(hyps, refs, hypslength=None, refslength=None,
                  normalized=True):
    """Levenshtein distance per pair; hyps/refs [B, L] padded ints."""
    b, lh = hyps.shape
    lr = refs.shape[1]
    dev = hyps.device
    if hypslength is None:
        hypslength = torch.full((b,), lh, dtype=torch.int32, device=dev)
    if refslength is None:
        refslength = torch.full((b,), lr, dtype=torch.int32, device=dev)
    prev = torch.arange(lr + 1, dtype=torch.int32, device=dev).expand(
        b, lr + 1)
    for i in range(lh):
        cols = [prev[:, 0] + 1]
        for j in range(lr):
            cost = (hyps[:, i] != refs[:, j]).to(torch.int32)
            cols.append(torch.minimum(torch.minimum(prev[:, j + 1] + 1,
                                                    cols[-1] + 1),
                                      prev[:, j] + cost))
        row = torch.stack(cols, dim=1)
        prev = torch.where((i < hypslength)[:, None], row, prev)
    rl = refslength.long()
    d = torch.gather(prev, 1, rl[:, None])[:, 0].float()
    if normalized:
        d = d / torch.clamp(rl.float(), min=1.0)
    return d.reshape(b, 1), torch.tensor([b], dtype=torch.int64, device=dev)


# ------------------------------------------------------------ stft helpers

@op()
def frame(x, frame_length, hop_length, axis=-1):
    """Overlapping frames along ``axis``: axis -1 gives [...,
    frame_length, n_frames], axis 0 [frame_length, n_frames, ...]."""
    if axis in (-1, x.dim() - 1):
        n_frames = 1 + (x.shape[-1] - frame_length) // hop_length
        return x.unfold(-1, frame_length, hop_length)[..., :n_frames, :] \
            .transpose(-1, -2)
    n_frames = 1 + (x.shape[0] - frame_length) // hop_length
    idx = (torch.arange(n_frames, device=x.device)[None, :] * hop_length
           + torch.arange(frame_length, device=x.device)[:, None])
    return x[idx]


@op()
def overlap_add(x, hop_length, axis=-1):
    """Inverse of frame: x [..., frame_length, n_frames] -> signal."""
    if axis in (-1, x.dim() - 1):
        frame_length, n_frames = x.shape[-2], x.shape[-1]
        out_len = (n_frames - 1) * hop_length + frame_length
        lead = x.shape[:-2]
        flat = x.transpose(-1, -2).reshape(-1, n_frames * frame_length)
        idx = (torch.arange(n_frames, device=x.device)[:, None] * hop_length
               + torch.arange(frame_length, device=x.device)[None, :])
        out = torch.zeros((flat.shape[0], out_len), dtype=x.dtype,
                          device=x.device)
        out = out.index_add(1, idx.reshape(-1), flat)
        return out.reshape(tuple(lead) + (out_len,))
    xt = torch.movedim(x, (0, 1), (-1, -2))
    res = overlap_add(xt.transpose(-1, -2), hop_length, axis=-1)
    return torch.movedim(res, -1, 0)
