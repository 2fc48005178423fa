"""The port's cost walker and census (``paddle_tpu_torch/framework/
cost.py``) against the JAX package's.

The walker's FLOPs and transcendentals on small functions equal the JAX
``estimate_jitted`` on the same function (matrix product, elementwise
chains, transcendentals, reductions), and its matrix-product FLOPs over
an engine step equal ``torch.utils.flop_counter.FlopCounterMode``'s on
the same body (held within 1%; they agree exactly here).
``run_census`` over ``gpt_tiny(num_layers=2)`` at tp=1 against the JAX
``run_census`` over the same configuration: ``compile_count``,
``families`` and ``memory`` equal, and each bucket's dense products
(the GEMMs against weights) equal.  The difference is attention: the
JAX step composes it in XLA over every key of ``max_model_len`` and
counts ``4 * L * T * Nq * S_max * D`` FLOPs for it, while the port's
step is one B1 node a layer whose cost rule counts the keys the rows'
descriptors reach, which a trace over fake tensors does not hold — 0
FLOPs (a lower bound).  M001 and B001 fire with the JAX messages, and
``speculative_draft_estimate`` equals the JAX one.  The step-time model
prices each bucket by the walker's roofline.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import cost as jax_cost
from paddle_tpu.framework.analysis import walk_jaxprs
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.framework import cost
from paddle_tpu_torch.inference.llm import LLMEngine
from paddle_tpu_torch.models.gpt import gpt_tiny

ENGINE = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=16)
DRAFT = dict(method="draft-model", num_tokens=2, draft_layers=1)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = jax_gpt_tiny(num_layers=2)
    jm.eval()
    return jm, gpt_tiny(device="cpu", num_layers=2, seed=0).eval()


def _x_w():
    x = np.random.RandomState(0).rand(8, 16).astype(np.float32)
    w = np.random.RandomState(1).rand(16, 32).astype(np.float32)
    return x, w


WALKER_CASES = {
    "dot": (lambda a, b: a @ b, lambda a, b: a @ b),
    "elementwise": (lambda a, b: a * 2.0 + a - a / 3.0,
                    lambda a, b: a * 2.0 + a - a / 3.0),
    "transcendental": (
        lambda a, b: jnp.exp(a) + jnp.tanh(a) * jnp.sqrt(a),
        lambda a, b: torch.exp(a) + torch.tanh(a) * torch.sqrt(a)),
    "reductions": (lambda a, b: a.sum(-1) + a.max(-1),
                   lambda a, b: a.sum(-1) + a.amax(-1)),
    "mean": (lambda a, b: a.mean(-1), lambda a, b: a.mean(-1)),
    "dot_then_bias": (lambda a, b: jnp.tanh(a @ b + 1.0),
                      lambda a, b: torch.tanh(a @ b + 1.0)),
}


@pytest.mark.parametrize("case", sorted(WALKER_CASES))
def test_walker_counts_equal_the_jax_walker(case):
    jf, tf = WALKER_CASES[case]
    x, w = _x_w()
    want = jax_cost.estimate_jitted(jax.jit(jf), jnp.asarray(x),
                                    jnp.asarray(w))
    got = cost.estimate_fn(tf, torch.from_numpy(x), torch.from_numpy(w))
    assert got.flops == want.flops
    assert got.transcendentals == want.transcendentals


def test_matmul_flops_equal_the_flop_counter(models):
    eng = LLMEngine(models[1], device="cpu", **ENGINE)
    for _kind, _bucket, body, operands in eng.executable_grid():
        est = cost.estimate_fn(body, *operands)
        counted = cost.flop_counter_analysis(body, *operands)
        assert est.matmul_flops > 0
        assert abs(est.matmul_flops - counted["flops"]) <= \
            0.01 * counted["flops"]
        assert set(counted["by_op"]) == {"aten.mm"}


def _jax_dense_and_attention_flops(engine):
    """{bucket: (dense, attention)} dot FLOPs of the JAX grid: a dense
    product multiplies by a 2-D weight, attention's by the gathered
    [.., S, Nkv, D] keys and values; scan bodies count once a layer."""
    out = {}
    for _kind, tb, fn, args in engine.executable_grid():
        closed = fn.trace(*args).jaxpr
        dense = attention = 0
        for path, j in walk_jaxprs(closed):
            mult = engine.num_layers if path else 1
            for eqn in j.eqns:
                if eqn.primitive.name != "dot_general":
                    continue
                flops = jax_cost._dot_flops(eqn) * mult
                if len(eqn.invars[1].aval.shape) == 2:
                    dense += flops
                else:
                    attention += flops
        out[tb] = (dense, attention)
    return out


def test_census_matches_the_jax_census(models):
    jax_eng = JaxEngine(models[0], **ENGINE)
    port_eng = LLMEngine(models[1], device="cpu", **ENGINE)
    want = jax_cost.run_census(jax_eng, profile="cpu")
    got = cost.run_census(port_eng, profile="cpu")
    assert got.compile_count == want.compile_count == 2
    assert got.families == want.families == {"ragged": 2}
    assert got.memory == want.memory
    jax_dots = _jax_dense_and_attention_flops(jax_eng)
    nq, d, s_max = port_eng.num_heads, port_eng.head_dim, \
        port_eng.max_model_len
    for e in got.entries:
        dense, attention = jax_dots[e["bucket"]]
        assert e["cost"]["matmul_flops"] == dense, e["label"]
        # the stated difference: XLA's attention over every key of
        # max_model_len against B1's data-dependent count (0 over fakes)
        assert attention == 4 * port_eng.num_layers * e["bucket"] * nq \
            * s_max * d
        assert e["cost"]["kernels"] == {
            "paged_ragged_attention": port_eng.num_layers}
    assert got.findings == want.findings == []


def _shape(message):
    """A message with its numbers masked."""
    return re.sub(r"\d+(\.\d+)?(B|KiB|MiB|GiB|TiB)?", "N", message)


def test_m001_and_b001_fire_with_the_jax_messages(models):
    jax_eng = JaxEngine(models[0], **ENGINE)
    port_eng = LLMEngine(models[1], device="cpu", **ENGINE)
    kw = dict(memory_budget=300_000, max_executables=1)
    want = jax_cost.run_census(jax_eng, profile="cpu", **kw).findings
    got = cost.run_census(port_eng, profile="cpu", **kw).findings
    assert [f.rule for f in got] == [f.rule for f in want] == \
        ["M001", "M001", "B001"]
    for g, w in zip(got, want):
        assert (g.severity, g.where) == (w.severity, w.where)
        assert _shape(g.message) == _shape(w.message)
    assert got[-1].message == want[-1].message       # B001, no estimate
    # the host budget's M001
    kw = dict(host_budget=1000)
    jax_tier = JaxEngine(models[0], kv_tier="64KiB", **ENGINE)
    port_tier = LLMEngine(models[1], device="cpu", kv_tier="64KiB",
                          **ENGINE)
    want = jax_cost.run_census(jax_tier, profile="cpu", **kw).findings
    got = cost.run_census(port_tier, profile="cpu", **kw).findings
    assert [(f.rule, f.where, f.message) for f in got] == \
        [(f.rule, f.where, f.message) for f in want]
    assert got and got[0].where == "kv_tier"


def test_speculative_draft_estimate_equals_the_jax_one(models):
    jax_eng = JaxEngine(models[0], speculative=DRAFT, **ENGINE)
    port_eng = LLMEngine(models[1], device="cpu", speculative=DRAFT,
                         **ENGINE)
    want = jax_cost.speculative_draft_estimate(jax_eng)
    assert want is not None
    assert cost.speculative_draft_estimate(port_eng) == want
    plain = LLMEngine(models[1], device="cpu", **ENGINE)
    assert cost.speculative_draft_estimate(plain) is None


def test_step_time_model_prices_the_walker_roofline(models):
    eng = LLMEngine(models[1], device="cpu", **ENGINE)
    model = cost.StepTimeModel.from_engine(eng, profile="cpu")
    census = cost.run_census(eng, profile="cpu")
    assert model.times_s == {("ragged", e["bucket"]): e["roofline_s"]
                             for e in census.entries}
    assert all(t > 0 for t in model.times_s.values())


def test_census_and_step_time_model_raise_at_tp_above_one():
    class TwoRanks:
        tp = 2

    with pytest.raises(NotImplementedError, match="A20b"):
        cost.run_census(TwoRanks())
    with pytest.raises(NotImplementedError, match="A20b"):
        cost.StepTimeModel.from_engine(TwoRanks())


def test_h100_profile_holds_the_card_limits():
    prof = cost.DEVICE_PROFILES["h100"]
    assert (prof["smem_per_block"], prof["regs_per_sm"],
            prof["regs_per_thread"], prof["threads_per_block"]) == \
        (232448, 65536, 255, 1024)
    assert prof["sms"] is None          # read from the card
