"""paddle_tpu_torch.nn — ``functional`` (the subset the GPT training path
and the Llama model run) and ``RMSNorm``.  The layer classes GPT needs
live in ``models/gpt.py``; the general ``nn`` package is slice 8."""

from . import functional  # noqa: F401
from .norm import RMSNorm

__all__ = ["RMSNorm", "functional"]
