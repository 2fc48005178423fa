"""The port's kernel table: kernel name -> (kernel, plain version, CPU
parity test, source, the TPU kernel it replaces).

``chip_smoke.py`` walks this table: it builds every source, holds each
kernel against its plain version on the card, and reads each kernel's
launch counter around the main path.  A kernel that is ported lands
here, so the smoke's ``kernels`` line lists every ported kernel.
"""

from dataclasses import dataclass

from . import ragged_attention_kernel


@dataclass(frozen=True)
class KernelEntry:
    name: str
    kernel: object      # the wrapper: launches the CUDA kernel
    plain: object       # plain PyTorch version, same signature
    parity: str         # the CPU test holding the plain version to the JAX package
    source: str         # CUDA source, repo-relative
    replaces: str       # the Pallas kernel's entry function, file:line
    counter: object     # module whose ``launches`` counts kernel launches

    @property
    def launches(self):
        return self.counter.launches

    def reset(self):
        self.counter.launches = 0


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


KERNELS = {
    "paged_ragged_attention": KernelEntry(
        name="paged_ragged_attention",
        kernel=ragged_attention_kernel.paged_ragged_attention_cuda,
        plain=_ragged_plain,
        parity="tests/test_torch_ragged_attention.py",
        source="paddle_tpu_torch/csrc/ragged_attention.cu",
        replaces="paddle_tpu/ops/pallas/ragged_attention_kernel.py:229",
        counter=ragged_attention_kernel),
}


def reset_counts():
    for entry in KERNELS.values():
        entry.reset()


def counts():
    return {name: entry.launches for name, entry in KERNELS.items()}
