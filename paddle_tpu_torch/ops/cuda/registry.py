"""The port's kernel table: kernel name -> (kernel, plain version, CPU
parity test, source, the TPU kernel it replaces).

``chip_smoke.py`` walks this table: it builds every source, holds each
kernel against its plain version on the card, and reads each kernel's
launch counter around the main path.  A kernel that is ported lands
here, so the smoke's ``kernels`` line lists every ported kernel.

A wrapper's counter advances where the wrapper launches its kernel.  A
replayed CUDA graph launches kernels without calling their wrappers, so
its launches are added through :func:`add_counts` (``jit/graphs.py``).
"""

from dataclasses import dataclass

from . import (
    decode_attention_kernel,
    flash_attention_kernel,
    layernorm_kernel,
    ragged_attention_kernel,
)


@dataclass(frozen=True)
class KernelEntry:
    name: str
    kernel: object      # the wrapper: launches the CUDA kernel
    plain: object       # plain PyTorch version, same signature
    parity: str         # the CPU test holding the plain version to the JAX package
    source: str         # CUDA source, repo-relative
    replaces: str       # the Pallas kernel's entry function, file:line
    counter: object     # module whose ``count`` attribute counts launches
    count: str = "launches"

    @property
    def launches(self):
        return getattr(self.counter, self.count)

    def reset(self):
        setattr(self.counter, self.count, 0)


def _ragged_plain(q, k_pages, v_pages, block_tables, row_start, row_qlen,
                  row_pos0):
    """The plain version in the kernel's per-row signature."""
    from ...inference.llm.paged_attention import (
        paged_ragged_attention_plain,
        token_descriptors,
    )
    ctx, rows = token_descriptors(q.shape[0], row_start, row_qlen,
                                  row_pos0)
    return paged_ragged_attention_plain(q, k_pages, v_pages, block_tables,
                                        ctx, rows)


def _ragged_quant_plain(q, k_pages, v_pages, k_scales, v_scales,
                        block_tables, row_start, row_qlen, row_pos0):
    """The int8 plain version in the kernel's per-row signature."""
    from ...inference.llm.paged_attention import (
        paged_ragged_attention_quant_plain,
        token_descriptors,
    )
    ctx, rows = token_descriptors(q.shape[0], row_start, row_qlen,
                                  row_pos0)
    return paged_ragged_attention_quant_plain(q, k_pages, v_pages, k_scales,
                                              v_scales, block_tables, ctx,
                                              rows)


KERNELS = {
    "paged_ragged_attention": KernelEntry(
        name="paged_ragged_attention",
        kernel=ragged_attention_kernel.paged_ragged_attention_cuda,
        plain=_ragged_plain,
        parity="tests/test_torch_ragged_attention.py",
        source="paddle_tpu_torch/csrc/ragged_attention.cu",
        replaces="paddle_tpu/ops/pallas/ragged_attention_kernel.py:229",
        counter=ragged_attention_kernel),
    "paged_ragged_attention_quant": KernelEntry(
        name="paged_ragged_attention_quant",
        kernel=ragged_attention_kernel.paged_ragged_attention_quant_cuda,
        plain=_ragged_quant_plain,
        parity="tests/test_torch_quant_serving.py",
        source="paddle_tpu_torch/csrc/ragged_attention.cu",
        replaces="paddle_tpu/ops/pallas/ragged_attention_kernel.py:322",
        counter=ragged_attention_kernel, count="quant_launches"),
    "decode_attention": KernelEntry(
        name="decode_attention",
        kernel=decode_attention_kernel.decode_attention_cuda,
        plain=decode_attention_kernel.decode_attention_plain,
        parity="tests/test_torch_decode_attention.py",
        source="paddle_tpu_torch/csrc/decode_attention.cu",
        replaces="paddle_tpu/ops/pallas/decode_attention_kernel.py:115",
        counter=decode_attention_kernel),
    "flash_attention_fwd": KernelEntry(
        name="flash_attention_fwd",
        kernel=flash_attention_kernel.flash_attention_fwd_cuda,
        plain=flash_attention_kernel.flash_fwd_plain,
        parity="tests/test_torch_flash_attention.py",
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas/attention_kernel.py:95",
        counter=flash_attention_kernel, count="fwd_launches"),
    "flash_attention_bwd": KernelEntry(
        name="flash_attention_bwd",
        kernel=flash_attention_kernel.flash_attention_bwd_cuda,
        plain=flash_attention_kernel.flash_bwd_plain,
        parity="tests/test_torch_flash_attention.py",
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas/attention_kernel.py:207",
        counter=flash_attention_kernel, count="bwd_launches"),
    "layernorm_fwd": KernelEntry(
        name="layernorm_fwd",
        kernel=layernorm_kernel.layernorm_fwd_cuda,
        plain=layernorm_kernel.layernorm_fwd_plain,
        parity="tests/test_torch_layernorm.py",
        source="paddle_tpu_torch/csrc/layernorm.cu",
        replaces="paddle_tpu/ops/pallas/layernorm_kernel.py:73",
        counter=layernorm_kernel, count="fwd_launches"),
    "layernorm_bwd": KernelEntry(
        name="layernorm_bwd",
        kernel=layernorm_kernel.layernorm_bwd_cuda,
        plain=layernorm_kernel.layernorm_bwd_plain,
        parity="tests/test_torch_layernorm.py",
        source="paddle_tpu_torch/csrc/layernorm.cu",
        replaces="paddle_tpu/ops/pallas/layernorm_kernel.py:99",
        counter=layernorm_kernel, count="bwd_launches"),
}


def reset_counts():
    for entry in KERNELS.values():
        entry.reset()


def counts():
    return {name: entry.launches for name, entry in KERNELS.items()}


def add_counts(delta):
    """Add ``{kernel name: launches}`` to the wrappers' counters.

    The only way a CUDA-graph replay advances them: a replay launches
    the kernels its capture recorded without calling a wrapper, so
    ``jit/graphs.py`` adds each replay's launches here (and takes a
    capture's recorded calls back out, since a capture runs no kernel).
    The ``kernels`` line of ``chip_smoke.py`` counts replayed launches
    this way."""
    for name, n in delta.items():
        entry = KERNELS[name]
        setattr(entry.counter, entry.count, entry.launches + n)
