"""The port's Hopper kernel lint (``paddle_tpu_torch/framework/
kernel_lint.py``) and the kernels as ``torch.library`` ops.

K005 is clean on the real registry and fires on each seeded violation
(an unregistered library module, a plain version that is not callable,
a missing parity file or source, a ``replaces`` that reaches no
``pallas_call``, an op without implementations, no smoke phase).
K001-K004 are clean on every kernel's launch plan at the engine's
shapes (traced from the bf16 and int8 engines' bucket grids) and at
FMT's, Llama's and training's (``MAIN_PATH_SHAPES``), and a seeded fault
fires each rule: shared memory over 232448 B, a grid one row short, two
blocks writing one output element, a split plan short of the keys.
Each op's fake gives its plain version's output shapes and dtypes; a
bucket's graph holds one B1 node a layer with the step's shapes; the
constants the plans mirror equal the CUDA sources' text, and every
source has its ``*_info`` entry.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from paddle_tpu_torch.framework import analysis
from paddle_tpu_torch.framework import kernel_lint as kl
from paddle_tpu_torch.inference.llm import LLMEngine
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.ops.cuda import _build, layernorm_kernel, registry

ENGINE = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=16,
              device="cpu")


@pytest.fixture(scope="module")
def model():
    return gpt_tiny(device="cpu", num_layers=2, seed=0).eval()


# ----------------------------------------------------------------- K005 --
def test_k005_clean_on_the_registry():
    assert kl.check_registry() == []


def _seeded(**changes):
    entries = dict(registry.KERNELS)
    entries["decode_attention"] = dataclasses.replace(
        entries["decode_attention"], **changes)
    return entries


@pytest.mark.parametrize("change, category", [
    (dict(plain="not a function"), "plain"),
    (dict(parity="tests/test_torch_no_such_file.py"), "parity"),
    (dict(parity="tests/test_torch_sim.py"), "parity"),
    (dict(source="paddle_tpu_torch/csrc/no_such.cu"), "source"),
    (dict(replaces="paddle_tpu/ops/pallas/decode_attention_kernel.py:1"),
     "replaces"),
    (dict(replaces="paddle_tpu/ops/attention.py:10"), "replaces"),
], ids=["plain", "parity_file", "parity_test", "source", "replaces_line",
        "replaces_outside_pallas"])
def test_k005_fires_on_seeded_violations(change, category):
    found = kl.check_registry(_seeded(**change))
    assert [(f.rule, f.category) for f in found] == [("K005", category)]
    assert found[0].where == "kernels/decode_attention"


def test_k005_fires_on_an_unregistered_module_an_op_and_a_phase(tmp_path):
    (tmp_path / "orphan_kernel.py").write_text(
        "from . import _build\n\n\ndef go():\n    return _build.load('x')\n")
    (tmp_path / "helper.py").write_text("def go():\n    return 1\n")
    found = kl.check_registry(search_dir=str(tmp_path))
    assert [(f.category, f.where) for f in found] == \
        [("unregistered", "kernels/orphan_kernel.py")]
    entries = dict(registry.KERNELS)
    entries["no_such_op"] = dataclasses.replace(
        entries["decode_attention"], name="no_such_op")
    cats = sorted(f.category for f in kl.check_registry(entries))
    assert cats == ["op", "op", "op", "smoke"]


# ------------------------------------------------------------ K001-K004 --
@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bf16", "int8"])
def test_lint_clean_at_the_engine_and_main_path_shapes(model, quantize):
    eng = LLMEngine(model, dtype="bfloat16", quantize=quantize, **ENGINE)
    assert kl.lint_registry(eng) == []
    names = {name for _, name, _ in kl.engine_calls(eng)}
    assert names == {"paged_ragged_attention_quant" if quantize
                     else "paged_ragged_attention"}


@pytest.mark.parametrize("label", sorted(kl.MAIN_PATH_SHAPES))
def test_every_main_path_plan_is_clean(label):
    name, ops = kl.MAIN_PATH_SHAPES[label]
    launches, facts = kl.launch_plan(name, **ops)
    assert launches and kl.check_plan(name, launches, facts) == []


def _plan(label):
    name, ops = kl.MAIN_PATH_SHAPES[label]
    return (name,) + kl.launch_plan(name, **ops)


def test_k002_fires_on_shared_memory_over_the_card():
    name, launches, facts = _plan("train_flash_bwd")
    launches[0].smem = 240000
    found = kl.check_plan(name, launches, facts)
    assert [f.rule for f in found] == ["K002"]
    assert "232448" in found[0].message
    # the card's numbers: static shared memory, registers, residency
    name, launches, facts = _plan("train_flash_fwd")
    launches[0].static_smem = 232448 - launches[0].smem + 1
    launches[0].regs, launches[0].blocks_per_sm = 256, 0
    rules = [f.rule for f in kl.check_plan(name, launches, facts)]
    assert rules == ["K002", "K002", "K002"]


def test_k001_fires_on_a_grid_one_row_short():
    for label, axis in (("fmt_decode", 0), ("train_ln_fwd", 0),
                        ("train_flash_fwd", 1)):
        name, launches, facts = _plan(label)
        last = launches[-1]
        grid = list(last.grid)
        grid[axis] -= 1
        last.grid = tuple(grid)
        found = kl.check_plan(name, launches, facts)
        assert found and {f.rule for f in found} == {"K001"}, label
        assert all("without a block" in f.message for f in found)


def test_k004_fires_on_two_blocks_writing_one_output():
    def overlapping(counts, grid):
        kl.span(counts, grid[0], 8, stride=4)     # tiles overlap by half

    launch = kl.Launch("seeded", (16,), 128, 0,
                       {"out": ((64,), overlapping)})
    found = kl.check_plan("seeded", [launch], {})
    assert [f.rule for f in found] == ["K004"]
    assert "more than one block" in found[0].message
    # a split's partial written twice is a race too
    name, launches, facts = _plan("llama_decode")
    shape, cover = launches[0].writes["partials"]

    def twice(counts, grid):
        cover(counts, grid)
        cover(counts, grid)

    launches[0].writes["partials"] = (shape, twice)
    assert [f.rule for f in kl.check_plan(name, launches, facts)] == \
        ["K004"]


def test_k003_fires_on_plans_short_of_keys_slots_or_pages(model):
    name, launches, facts = _plan("llama_decode")
    assert kl.check_plan(name, launches, dict(facts, splits=15)) != []
    eng = LLMEngine(model, **ENGINE)
    _label, name, ops = next(kl.engine_calls(eng))
    launches, facts = kl.launch_plan(name, **ops)
    assert kl.check_plan(name, launches, facts,
                         max_pages=eng.max_pages) == []
    found = kl.check_plan(name, launches, dict(facts, slots=1))
    assert [f.rule for f in found] == ["K003"]
    found = kl.check_plan(name, launches, facts,
                          max_pages=eng.max_pages + 1)
    assert [f.rule for f in found] == ["K003"]
    launches[0].grid = (1, 70000, 1)
    assert [f.rule for f in kl.check_plan(name, launches, facts)] == \
        ["K003"]


def test_ln_backward_plan_follows_bwd_plan():
    for slots in (1, 64, 264, 5000):
        launches, facts = kl.launch_plan(
            "layernorm_bwd", slots=slots,
            x2d=((8192, 768), torch.bfloat16))
        assert (launches[0].grid[0], launches[1].grid[0]) == \
            layernorm_kernel.bwd_plan(8192, 768, slots)
        assert kl.check_plan("layernorm_bwd", launches, facts) == []


# -------------------------------------------------------- ops and fakes --
def _ragged_args():
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.rand(6, 4, 16).astype(np.float32))
    kp = torch.from_numpy(rng.rand(5, 4, 2, 16).astype(np.float32))
    bt = torch.tensor([[0, 1, 2], [3, 4, 0]], dtype=torch.int32)
    rs, rq, rp = (torch.tensor(v, dtype=torch.int32)
                  for v in ([0, 3], [3, 2], [2, 5]))
    return q, kp, kp.clone(), bt, rs, rq, rp


def _op_cases():
    rng = np.random.RandomState(1)

    def t(*shape, dtype=np.float32):
        return torch.from_numpy(rng.rand(*shape).astype(dtype))

    q, kp, vp, bt, rs, rq, rp = _ragged_args()
    k8 = torch.from_numpy(rng.randint(-127, 128, kp.shape).astype(np.int8))
    sc = t(5, 2, 4)
    x2d, g, b = t(6, 16), t(16), t(16)
    mu, rstd = t(6), t(6) + 1.0
    fq, fk = t(2, 8, 2, 16), t(2, 8, 2, 16)
    out, lse = registry.KERNELS["flash_attention_fwd"].plain(fq, fk, fk,
                                                             True, 0.25)
    return {
        "paged_ragged_attention": (q, kp, vp, bt, rs, rq, rp),
        "paged_ragged_attention_quant": (q, k8, k8.clone(), sc, sc.clone(),
                                         bt, rs, rq, rp),
        "decode_attention": (t(3, 4, 16), t(3, 10, 2, 16), t(3, 10, 2, 16),
                             torch.tensor([0, 4, 10], dtype=torch.int32)),
        "flash_attention_fwd": (fq, fk, fk, True, 0.25),
        "flash_attention_bwd": (fq, fk, fk, out, lse, t(2, 8, 2, 16), True,
                                0.25),
        "layernorm_fwd": (x2d, g, b, 1e-5),
        "layernorm_bwd": (x2d, g, mu, rstd, t(6, 16)),
    }


def _sig(x):
    xs = x if isinstance(x, tuple) else (x,)
    return [(tuple(v.shape), v.dtype) for v in xs]


@pytest.mark.parametrize("name", sorted(registry.KERNELS))
def test_fake_shapes_equal_the_plain_outputs(name):
    entry = registry.KERNELS[name]
    args = _op_cases()[name]
    real = entry.op(*args)                  # CPU tensors: the plain version
    with FakeTensorMode() as mode:
        fake = entry.op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                          else a for a in args))
    assert _sig(fake) == _sig(real)
    if name != "layernorm_bwd":             # the op returns [dg; db] f32
        assert _sig(real) == _sig(entry.plain(*args))


def test_the_cpu_op_is_the_plain_version_bitwise():
    entry = registry.KERNELS["paged_ragged_attention"]
    args = _ragged_args()
    assert torch.equal(entry.op(*args), entry.plain(*args))
    dx, dgdb = registry.KERNELS["layernorm_bwd"].op(
        *_op_cases()["layernorm_bwd"])
    want = registry.KERNELS["layernorm_bwd"].plain(
        *_op_cases()["layernorm_bwd"])
    assert torch.equal(dx, want[0])
    assert torch.equal(dgdb, torch.stack(want[1:]))


def test_a_bucket_trace_shows_one_b1_node_a_layer(model):
    eng = LLMEngine(model, **ENGINE)
    for kind, bucket, body, operands in eng.executable_grid():
        calls = kl.introspect_kernels(body, *operands)
        assert [c.name for c in calls] == \
            ["paged_ragged_attention"] * eng.num_layers
        assert calls[0].operands["q"] == (
            (bucket, eng.num_heads, eng.head_dim), torch.float32)
        assert calls[0].operands["block_tables"][0] == (eng.max_batch,
                                                        eng.max_pages)


# ---------------------------------------------- the plans' C counterparts --
def _cu(name):
    with open(os.path.join(_build.CSRC, name)) as f:
        return f.read()


def _constexpr(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+)", text).group(1))


def test_mirrored_constants_equal_the_sources():
    split = _cu("split_decode.cuh")
    assert kl.SPLIT_THREADS == _constexpr(split, "kWarps") * 32
    ln = _cu("layernorm.cu")
    assert kl.LN_FWD_WARPS == _constexpr(ln, "kFwdWarps")
    assert kl.LN_RED_THREADS == _constexpr(ln, "kRedThreads")
    assert kl.LN_RING_SLOTS == _constexpr(ln, "kRingSlots")
    assert layernorm_kernel.BWD_WARPS == _constexpr(ln, "kBwdWarps")
    flash = _cu("flash_attention.cu")
    assert kl.FLASH_MAX_D == _constexpr(flash, "kMaxD")
    # kBN: 32 rows a streamed tile for f32 and at DP 128, else 64
    assert ("constexpr int kBN = (std::is_same<T, float>::value || "
            "DP == 128) ? 32 : 64;") in flash
    for d, dp in ((32, 32), (64, 64), (128, 128)):
        assert kl._tc_tiles(d, torch.bfloat16) == (dp, 64,
                                                   32 if dp == 128 else 64)
        assert kl._tc_tiles(d, torch.float32) == (dp, 64, 32)
        # every instance (T: f32, bf16 or f16; V: the aligned one, or the
        # general) takes BM 64 and kBN, forward and backward
        for fn in ("launch_fwd", "launch_bwd", "info_fwd", "info_bwd"):
            assert f"tc::{fn}<T, {dp}, 64, tc::kBN<T, {dp}>, V>" in flash
    # f32 reaches the same table as the 16-bit types
    for entry in ("tc_fwd", "tc_bwd", "tc_info"):
        assert f"if (dtype == 0) return {entry}<float, V>" in flash
    # the plan's shared bytes are Inst's
    for fn in ("2 * DP * (BM + 4 * BN)", "2 * DP * (3 * BM + 4 * BN)",
               "2 * DP * (2 * BM + 4 * BN) + 16 * BN",
               "4 * (DP + 4) * (2 * BM + 6 * BN)",
               "4 * (DP + 4) * (3 * BM + 6 * BN)",
               "4 * (DP + 4) * (3 * BM + 6 * BN) + 16 * BN"):
        assert fn in flash, fn


def test_every_source_has_its_info_entry():
    for name in ("ragged_attention", "decode_attention", "flash_attention",
                 "layernorm"):
        text = _cu(name + ".cu")
        assert '#include "kernel_info.cuh"' in text
        assert re.search(r'extern "C" int \w+_info\(', text), name


def test_cli_kernels_on_the_cpu(capsys):
    assert analysis.main(["kernels", "--device", "cpu"]) == 0
    assert analysis.main(["kernels", "--device", "cpu", "--quantize",
                          "int8"]) == 0
    assert "0 error(s), 0 warning(s)" in capsys.readouterr().out
