"""paddle.text — viterbi decoding + dataset scaffolds (port of
``paddle_tpu/text``).

Reference: python/paddle/text/viterbi_decode.py (ViterbiDecoder over the
viterbi_decode op) and text/datasets/ (downloadable corpora — gated here,
as in the JAX package).  ``viterbi_decode`` keeps the JAX module's own
convention (``_vit_pure``: [N, N] transitions, tag N-2 the BOS and N-1
the EOS, each step's emission added inside the score, the path zero past
a sequence's length), which is not the registered ``seq_ops``
``viterbi_decode`` op's ([N+2, N+2] BOS/EOS rows): the two scans are
each their module's.  Its ``lax.scan`` loops become Python loops of
whole-batch steps on the inputs' device.
"""

import numpy as np
import torch

from ..core.tensor import Tensor
from ..framework.device import current_device
from ..nn.layer_base import Layer
from ..ops.registry import register_external

__all__ = ["viterbi_decode", "ViterbiDecoder"]


def _vit_pure(potentials, transitions, lengths, include_bos_eos_tag):
    """potentials [B, T, N], transitions [N, N], lengths [B] int64.

    Returns (scores [B], paths [B, T]) — best-path score and tag indices;
    positions beyond a sequence's length hold zeros (reference semantics:
    outputs are only meaningful up to lengths[b]).
    """
    b, t, n = potentials.shape
    lengths = lengths.to(torch.int32)
    if include_bos_eos_tag:
        # reference convention: tag N-2 = BOS, N-1 = EOS
        alpha = potentials[:, 0] + transitions[n - 2][None, :]
    else:
        alpha = potentials[:, 0]
    backptrs = []
    for tpos in range(1, t):
        # score[b, i, j] = alpha[b, i] + trans[i, j] + emit[b, j]
        scores = alpha[:, :, None] + transitions[None, :, :] \
            + potentials[:, tpos][:, None, :]
        backptrs.append(torch.argmax(scores, dim=1))            # [B, N]
        # frozen once past the sequence end
        alpha = torch.where((tpos < lengths)[:, None], scores.amax(dim=1),
                            alpha)
    if include_bos_eos_tag:
        alpha = alpha + transitions[:, n - 1][None, :]
    tag = torch.argmax(alpha, dim=-1)                           # [B]
    scores = alpha.amax(dim=-1)
    path = [tag]
    for tpos in range(t - 1, 0, -1):
        prev = torch.gather(backptrs[tpos - 1], 1, tag[:, None])[:, 0]
        # only follow pointers inside the sequence
        tag = torch.where(tpos < lengths, prev, tag)
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)                       # [B, T]
    # zero out positions past each length (reference: unused tail)
    mask = torch.arange(t, device=path.device)[None, :] < lengths[:, None]
    return scores, torch.where(mask, path, 0).to(torch.int64)


def _arg(x, dev):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=dev)


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """Best tag sequence under a linear-chain CRF (reference
    python/paddle/text/viterbi_decode.py:25)."""
    pot = _arg(potentials, None if isinstance(potentials, (Tensor,
               torch.Tensor)) else current_device())
    trans = _arg(transition_params, pot.device).to(pot.device)
    lens = _arg(lengths, pot.device).to(pot.device)
    scores, path = _vit_pure(pot, trans, lens, bool(include_bos_eos_tag))
    return Tensor(scores), Tensor(path)


register_external("viterbi_decode", viterbi_decode, tags=("text",))


class ViterbiDecoder(Layer):
    """Reference python/paddle/text/viterbi_decode.py:93."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)


class _GatedDataset:
    """Downloadable corpora are unavailable (no network): raise with
    guidance."""

    NAME = "dataset"

    def __init__(self, *a, **k):
        raise RuntimeError(
            f"paddle_tpu_torch.text.{self.NAME}: automatic download is "
            "unavailable; load the corpus from local files with "
            "paddle_tpu_torch.io.Dataset instead.")


class Imdb(_GatedDataset):
    NAME = "Imdb"


class Conll05st(_GatedDataset):
    NAME = "Conll05st"


class Movielens(_GatedDataset):
    NAME = "Movielens"


class UCIHousing(_GatedDataset):
    NAME = "UCIHousing"


class WMT14(_GatedDataset):
    NAME = "WMT14"


class WMT16(_GatedDataset):
    NAME = "WMT16"
