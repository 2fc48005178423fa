"""Conformer ASR encoder (port of ``paddle_tpu/models/conformer.py``;
BASELINE.md ASR config; the reference ships the op substrate —
warpctc/warprnnt kernels, SURVEY §2.9 audio — and model zoos live in
PaddleSpeech).

The standard conformer block: feed-forward "macaron" halves, MHSA, a
depthwise conv module, CTC head; positional information comes from the
convolution modules (the "conv-is-the-position-model" variant).  On the
card every LayerNorm (five a block) runs the LayerNorm kernels (B4a,
B4b) and the self-attention, at head_dim d_model / num_heads (36 at the
defaults), the flash kernels (B2, B3) wherever it runs without dropout
(eval, or ``dropout=0.0``); the convolutions are cuDNN's, as they are
XLA's in the JAX package.  The loss's lengths are built with
``torch.full`` on the logits' device, where the JAX module uses
``jnp.full``.
"""

import torch

from .. import nn
from ..core.tensor import Tensor
from ..nn import functional as F


class FeedForwardModule(nn.Layer):
    def __init__(self, d_model, expansion=4, dropout=0.1):
        super().__init__()
        self.ln = nn.LayerNorm(d_model)
        self.fc1 = nn.Linear(d_model, d_model * expansion)
        self.fc2 = nn.Linear(d_model * expansion, d_model)
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        h = self.ln(x)
        h = F.silu(self.fc1(h))
        return self.drop(self.fc2(self.drop(h)))


class ConvModule(nn.Layer):
    """pointwise-GLU → depthwise conv → BN(→LN here) → silu → pointwise."""

    def __init__(self, d_model, kernel_size=15, dropout=0.1):
        super().__init__()
        self.ln = nn.LayerNorm(d_model)
        self.pw1 = nn.Linear(d_model, 2 * d_model)
        self.dw = nn.Conv1D(d_model, d_model, kernel_size,
                            padding=kernel_size // 2, groups=d_model)
        self.norm = nn.LayerNorm(d_model)
        self.pw2 = nn.Linear(d_model, d_model)
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        h = self.ln(x)
        h = F.glu(self.pw1(h), axis=-1)
        h = h.transpose([0, 2, 1])              # [B, C, T] for conv1d
        h = self.dw(h)
        h = h.transpose([0, 2, 1])
        h = F.silu(self.norm(h))
        return self.drop(self.pw2(h))


class MHSAModule(nn.Layer):
    def __init__(self, d_model, num_heads, dropout=0.1):
        super().__init__()
        self.ln = nn.LayerNorm(d_model)
        self.attn = nn.MultiHeadAttention(d_model, num_heads,
                                          dropout=dropout)
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        h = self.ln(x)
        return self.drop(self.attn(h, h, h))


class ConformerBlock(nn.Layer):
    def __init__(self, d_model, num_heads, conv_kernel=15, ff_expansion=4,
                 dropout=0.1):
        super().__init__()
        self.ff1 = FeedForwardModule(d_model, ff_expansion, dropout)
        self.mhsa = MHSAModule(d_model, num_heads, dropout)
        self.conv = ConvModule(d_model, conv_kernel, dropout)
        self.ff2 = FeedForwardModule(d_model, ff_expansion, dropout)
        self.ln_out = nn.LayerNorm(d_model)

    def forward(self, x):
        x = x + 0.5 * self.ff1(x)
        x = x + self.mhsa(x)
        x = x + self.conv(x)
        x = x + 0.5 * self.ff2(x)
        return self.ln_out(x)


class Conformer(nn.Layer):
    """Conformer-CTC: subsampling front end → N blocks → CTC head.

    Input: log-mel features [B, T, feat]; output logits
    [B, T//4, vocab+1] (blank = index 0, our ctc_loss convention).
    """

    def __init__(self, feat_size=80, vocab_size=29, d_model=144,
                 num_layers=8, num_heads=4, conv_kernel=15, dropout=0.1):
        super().__init__()
        # 2x conv2d stride-2 subsampling (standard 4x time reduction)
        self.sub1 = nn.Conv2D(1, d_model, 3, stride=2, padding=1)
        self.sub2 = nn.Conv2D(d_model, d_model, 3, stride=2, padding=1)
        self.proj = nn.Linear(d_model * ((feat_size + 3) // 4), d_model)
        self.blocks = nn.LayerList([
            ConformerBlock(d_model, num_heads, conv_kernel,
                           dropout=dropout)
            for _ in range(num_layers)])
        self.head = nn.Linear(d_model, vocab_size + 1)  # +1 CTC blank
        self.vocab_size = vocab_size

    def forward(self, feats):
        b, t, f = feats.shape
        h = feats.unsqueeze(1)                  # [B, 1, T, F]
        h = F.relu(self.sub1(h))
        h = F.relu(self.sub2(h))                # [B, C, T/4, F/4]
        h = h.transpose([0, 2, 1, 3])           # [B, T/4, C, F/4]
        h = h.reshape([b, h.shape[1], -1])
        h = self.proj(h)
        for blk in self.blocks:
            h = blk(h)
        return self.head(h)

    def loss(self, logits, labels, label_lengths=None):
        """CTC loss (reference warpctc kernel; ours is the native
        ctc_loss op).  ctc_loss wants time-major [T, B, C] log-probs."""
        b, t = logits.shape[0], logits.shape[1]
        dev = logits._data.device
        log_probs = F.log_softmax(logits, axis=-1).transpose([1, 0, 2])
        input_lengths = Tensor(torch.full((b,), t, dtype=torch.int32,
                                          device=dev))
        if label_lengths is None:
            label_lengths = Tensor(torch.full((labels.shape[0],),
                                              labels.shape[1],
                                              dtype=torch.int32, device=dev))
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=0)


def conformer_tiny(**kw):
    cfg = dict(feat_size=32, vocab_size=16, d_model=32, num_layers=2,
               num_heads=2, conv_kernel=7, dropout=0.0)
    cfg.update(kw)
    return Conformer(**cfg)
