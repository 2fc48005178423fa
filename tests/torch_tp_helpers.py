"""Helpers of the tests that hold the port's tensor-parallel host tier,
migration, fleets and analysis (``test_torch_tp_tier.py``,
``test_torch_tp_migration.py``, ``test_torch_tp_analysis.py``) to the
port's tp=1 engine and the JAX package's tp=1 engine.

Both packages get ``gpt_tiny(num_layers=2)`` in f32 with the same seeded
random weights, carried as numpy arrays.  The ranks of a tp=2 engine are
gloo processes on the CPU (``device="cpu"``); every engine a test builds
is closed at its module's end by the ``spawned`` fixture of the module.
"""

import numpy as np

import paddle_tpu as paddle
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.models.gpt import gpt_tiny

ENGINE = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=16)


def randomized(params, seed):
    """Seeded random weights of the shapes of ``params``: LayerNorm and
    head scales near 1, biases near 0, the rest at 0.1 scale."""
    rng = np.random.RandomState(seed)
    out = {}
    for g, sub in params.items():
        out[g] = {}
        for k, v in sub.items():
            noise = rng.randn(*np.shape(v)).astype(np.float32)
            if k.startswith("ln_") or g == "head":
                val = (1.0 if k.endswith("weight") else 0.0) + 0.1 * noise
            elif k.endswith("bias"):
                val = 0.05 * noise
            else:
                val = 0.1 * noise
            out[g][k] = val.astype(np.float32)
    return out


def seeded_models(seed):
    """(JAX model, port model on the CPU) with the same seeded weights."""
    paddle.seed(0)
    jm = jax_gpt_tiny(num_layers=2)
    jm.eval()
    params = randomized(
        {g: {k: np.asarray(v) for k, v in sub.items()}
         for g, sub in jm.functional_decompose()["params"].items()},
        seed=seed)
    jm.load_stacked(params)
    pm = gpt_tiny(device="cpu", num_layers=2)
    pm.load_stacked(params)
    return jm, pm


def close_all(engines):
    """Shut down the worker processes of every tensor-parallel engine in
    ``engines`` (a fleet's replicas included, given the fleet)."""
    for eng in engines:
        for e in ([r.engine for r in eng.replicas]
                  if hasattr(eng, "replicas") else [eng]):
            if e is not None and getattr(e, "_tp", None) is not None:
                e._tp.close()


def drive(eng):
    """Step an engine (or a fleet) to completion with its invariant
    check after every step -> {request id: output}."""
    outs = {}
    while eng.has_unfinished():
        for fo in eng.step():
            outs[fo.request_id] = fo
        eng.check_invariants()
    return outs


def recorded_demotes(eng):
    """Record every chain the engine's host pool takes: [(rid, entry)]."""
    got = []
    put = eng.host_pool.put

    def spy(rid, entry):
        got.append((rid, entry))
        return put(rid, entry)

    eng.host_pool.put = spy
    return got


def tier_bytes(eng):
    """Step an engine to completion -> (outputs, the host bytes its tier
    moved: ``last_tier_bytes`` summed over the steps)."""
    outs, moved = {}, 0
    while eng.has_unfinished():
        for fo in eng.step():
            outs[fo.request_id] = fo
        moved += eng.last_tier_bytes
        eng.check_invariants()
    return outs, moved


def assert_pages_close(got, want, int8_codes=False):
    """Page payloads equal in shape and dtype and within 1e-5 (int8 codes
    within 1: a value half-way between two codes may round either
    way)."""
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if int8_codes:
        assert np.abs(got.astype(np.int32)
                      - want.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
