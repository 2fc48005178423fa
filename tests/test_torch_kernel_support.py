"""What the port's flash-attention and LayerNorm kernels take, and where
their routes send the rest, against the JAX package's rules.

B2/B3: the JAX ``supports`` takes every head_dim up to 128 (on sequence
lengths its blocks divide); the port's takes every head_dim from 1 to
128 at any length, and ``ops/attention.py::kernel_route`` sends a
head_dim above 128 to the plain composition before any launch, as the
JAX dispatcher sends it to ``_xla_attention``.  B4a/B4b: the JAX kernel
takes ``C % 128 == 0``; the port's takes every ``C % 8 == 0`` from 8 to
8192 (a warp's row up to 2048, a block's beyond), and
``nn.functional.layer_norm`` sends any other width to the plain
composition.  The host constants equal the sources' constexprs.
"""

import re
from pathlib import Path

import torch

from paddle_tpu.ops.pallas import attention_kernel as jattn
from paddle_tpu.ops.pallas import layernorm_kernel as jln

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import attention
from paddle_tpu_torch.ops.cuda import flash_attention_kernel as fak
from paddle_tpu_torch.ops.cuda import layernorm_kernel as lnk

CSRC = Path(fak.__file__).resolve().parents[2] / "csrc"


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_flash_head_dims_agree_with_the_reference():
    for d in range(1, 161):
        want = jattn.supports(256, 256, d)      # blocks divide 256
        for dtype in (torch.float32, torch.bfloat16):
            assert fak.supports(256, 256, d, dtype) == want, (d, dtype)
            assert fak.supports(77, 333, d, dtype) == want, (d, dtype)
        q, k = _meta(2, 256, 4, d), _meta(2, 256, 4, d)
        assert attention.kernel_route(q, k) == want, d
        assert attention.kernel_route(q, k, is_causal=True) == want, d
        # the semantic routes stay plain whatever the head_dim
        assert not attention.kernel_route(q, k, dropout_p=0.1)
        assert not attention.kernel_route(q, k, scale=0.5)


def test_layernorm_widths_agree_with_the_kernel_rule():
    for c in range(8, 8193):
        want = c % 8 == 0
        assert lnk.takes_channels(c) == want, c
        for dtype in (torch.float32, torch.bfloat16):
            assert lnk.supports(64, c, dtype) == want, (c, dtype)
        if jln.supports(64, c):                  # every JAX width too
            assert want
    assert not lnk.takes_channels(8200) and not lnk.takes_channels(4)


class _OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` as a card's would, so the
    routing decision runs here."""

    @property
    def is_cuda(self):
        return True


def test_layernorm_route_sends_other_widths_to_the_composition(
        monkeypatch):
    import paddle_tpu_torch.nn.functional as fmod

    launched = []
    monkeypatch.setattr(fmod, "layernorm_cuda",
                        lambda x, w, b, eps: launched.append(x.shape[-1]))
    for c in (8, 144, 100, 2048, 2056, 4096, 8192, 8200, 12):
        x = torch.Tensor._make_subclass(_OnCard, torch.ones(2, c))
        w, b = torch.ones(c), torch.zeros(c)
        F.layer_norm(x, [c], w, b)
        F.layer_norm(x, [c])                  # no affine: always plain
    assert launched == [8, 144, 2048, 2056, 4096, 8192]


def test_host_constants_are_the_kernel_constexprs():
    ln = (CSRC / "layernorm.cu").read_text()
    fa = (CSRC / "flash_attention.cu").read_text()

    def constexpr(src, name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    max_vec = int(constexpr(ln, "kMaxVec"))
    wide_threads = int(constexpr(ln, "kWideThreads"))
    wide_vec = int(constexpr(ln, "kWideMaxVec"))
    assert constexpr(ln, "kNarrowC") == "32 * 8 * kMaxVec"
    assert constexpr(ln, "kMaxC") == "kWideThreads * 8 * kWideMaxVec"
    assert lnk.NARROW_C == 32 * 8 * max_vec
    assert lnk.WIDE_THREADS == wide_threads
    assert lnk._MAX_C == wide_threads * 8 * wide_vec
    assert fak._MAX_D == int(constexpr(fa, "kMaxD"))


# ---------------------------------------------------------- float16 (C10) --
# The JAX kernels take any floating dtype (they cast to f32 inside, and
# their ``supports`` never reads the dtype); the port's B2/B3 and B4a/B4b
# take float16 beside f32 and bf16, in a float16 instance of the same
# kernels with f32 accumulators, lse, delta, mu and rstd.
F16 = torch.float16


def test_flash_takes_float16_wherever_the_reference_takes_the_shape():
    for d in range(1, 161):
        want = jattn.supports(256, 256, d)
        assert fak.supports(256, 256, d, F16) == want, d
        assert fak.supports(77, 333, d, F16) == want, d
        assert fak.supports(77, 77, d, F16, causal=True) == want, d


def test_layernorm_takes_float16_at_every_width_it_takes():
    for c in range(8, 8193):
        assert lnk.supports(64, c, F16) == (c % 8 == 0), c


def _on_card(*shape, dtype=F16):
    return torch.Tensor._make_subclass(_OnCard, torch.ones(*shape,
                                                           dtype=dtype))


def test_float16_calls_reach_the_kernels(monkeypatch):
    """A float16 attention and LayerNorm on the card take the kernels'
    routes and pass the wrappers' checks (C10: ``_check`` raised
    ValueError for both while the kernels took f32 and bf16 only)."""
    import paddle_tpu_torch.nn.functional as fmod

    q, k, v = (_on_card(2, 64, 4, 32) for _ in range(3))
    fak._check({"q": q, "k": k, "v": v}, True, seq_k_names=("k", "v"))
    launched = []
    monkeypatch.setattr(attention, "flash_attention_cuda",
                        lambda q, k, v, c: launched.append(("flash", q.dtype)))
    attention.flash_attention(q, k, v, is_causal=True)
    monkeypatch.setattr(fmod, "layernorm_cuda",
                        lambda x, w, b, eps: launched.append(("ln", x.dtype)))
    x = _on_card(8, 768)
    F.layer_norm(x, [768], torch.ones(768, dtype=F16),
                 torch.zeros(768, dtype=F16))
    assert launched == [("flash", F16), ("ln", F16)]


def test_float16_codes_and_instances_match_the_sources():
    """The wrappers' dtype code 2 is the sources' float16 branch, and the
    kernel lint names the float16 instances the sources compile."""
    from paddle_tpu_torch.framework import kernel_lint as kl

    assert fak._DTYPES[F16] == 2 and lnk._DTYPES[F16] == 2
    flash = (CSRC / "flash_attention.cu").read_text()
    ln = (CSRC / "layernorm.cu").read_text()
    assert "if (dtype == 2) return tc_fwd<tc::f16, V>" in flash
    assert "if (dtype == 2) return tc_bwd<tc::f16, V>" in flash
    assert "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32" in flash
    assert "if (dtype == 2) { LN_DISPATCH(__half, launch_fwd" in ln
    assert "if (dtype == 2) { LN_DISPATCH(__half, launch_bwd" in ln
    launches, _ = kl.launch_plan("flash_attention_bwd",
                                 q=((8, 1024, 12, 64), F16),
                                 k=((8, 1024, 12, 64), F16))
    assert [x.kernel for x in launches] == ["flash_dq_tc<f16,64,64,64>",
                                            "flash_dkv_tc<f16,64,64,64>"]
    launches, _ = kl.launch_plan("layernorm_fwd", x2d=((8192, 768), F16))
    assert launches[0].kernel == "ln_fwd_kernel<f16,3>"
