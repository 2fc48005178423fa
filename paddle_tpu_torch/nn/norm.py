"""Normalization layers: ``RMSNorm``, the llama family's norm.

LayerNorm for GPT lives in ``models/gpt.py`` with the model's other
small layers; the general layer set is slice 8."""

import torch
from torch import nn

from . import functional as F


class RMSNorm(nn.Module):
    """``y = x * rsqrt(mean(x ** 2) + epsilon) * weight`` over the last
    dim, with ``weight`` [hidden_size] initialised to ones."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)
