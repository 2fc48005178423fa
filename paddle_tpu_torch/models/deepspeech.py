"""DeepSpeech2-style ASR model (port of ``paddle_tpu/models/deepspeech.py``;
BASELINE.md ASR config).

Conv2D subsampling over (time, freq) spectrogram -> bidirectional GRU stack
-> per-frame vocabulary logits -> CTC loss (``F.ctc_loss``, the
``warpctc`` op).  The GRU is ``nn.GRU`` over the ``rnn`` op: a Python
loop of per-step launches, 2 directions x T' steps a layer.
"""

from .. import nn
from ..nn import functional as F


class ConvSubsample(nn.Layer):
    """Two conv layers, each halving the time axis."""

    def __init__(self, out_channels=32):
        super().__init__()
        self.conv1 = nn.Conv2D(1, out_channels, kernel_size=(3, 3),
                               stride=(2, 2), padding=1)
        self.conv2 = nn.Conv2D(out_channels, out_channels, kernel_size=(3, 3),
                               stride=(2, 1), padding=1)

    def forward(self, x):
        # x: [B, 1, T, F]
        x = F.relu(self.conv1(x))
        return F.relu(self.conv2(x))


class DeepSpeech2(nn.Layer):
    def __init__(self, feat_size=64, vocab_size=29, num_rnn_layers=3,
                 rnn_size=256, conv_channels=32):
        super().__init__()
        self.conv = ConvSubsample(conv_channels)
        freq_after = (feat_size + 1) // 2  # conv1 halves freq, conv2 keeps
        rnn_in = conv_channels * freq_after
        self.rnn = nn.GRU(rnn_in, rnn_size, num_layers=num_rnn_layers,
                          direction="bidirect", time_major=False)
        self.fc = nn.Linear(2 * rnn_size, vocab_size)

    def forward(self, x):
        """x: [B, T, F] log-mel features.  Returns logits [T', B, V]
        (time-major, CTC layout) and the subsampled lengths factor 4."""
        b, t, f = x.shape
        h = self.conv(x.reshape([b, 1, t, f]))        # [B, C, T/4, F/2]
        c, t2, f2 = h.shape[1], h.shape[2], h.shape[3]
        h = h.transpose([0, 2, 1, 3]).reshape([b, t2, c * f2])
        out, _ = self.rnn(h)                          # [B, T', 2H]
        logits = self.fc(out)                         # [B, T', V]
        return logits.transpose([1, 0, 2])            # [T', B, V]

    def loss(self, logits, labels, label_lengths=None):
        return F.ctc_loss(logits, labels, label_lengths=label_lengths,
                          blank=0, reduction="mean")


def deepspeech2_tiny(**kw):
    cfg = dict(feat_size=16, vocab_size=12, num_rnn_layers=1, rnn_size=32,
               conv_channels=4)
    cfg.update(kw)
    return DeepSpeech2(**cfg)
