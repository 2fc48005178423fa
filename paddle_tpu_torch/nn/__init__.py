"""paddle_tpu_torch.nn — so far only ``functional``, the subset the GPT
training path runs.  The layer classes GPT needs live in
``models/gpt.py``; the general ``nn`` package is slice 8."""

from . import functional  # noqa: F401
