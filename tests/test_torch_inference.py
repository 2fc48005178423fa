"""The port's ``inference`` — ``Config``, ``Predictor``,
``create_predictor``, ``PredictorServer`` — against the JAX package's.

Both predictors serve one MLP on the same weights (carried by name):
positional and handle-style runs agree at 1e-5, feeds bind by their
declared names, the program is traced once per input signature and
replays the live weights, and ``enable_mixed_precision`` casts the
parameters once (bf16 runs agree with JAX's bf16 predictor at 2e-2).
``PredictorServer`` (a verbatim copy of the JAX module) serves the
predictor and, in its generative form, a port ``LLMEngine`` or
``Fleet`` built on the CPU (the reference's ``TestFleetServing`` with
``device="cpu"``), whose wire outputs equal the engine's own greedy
``generate``.
"""

import socket
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.inference as jinf
import paddle_tpu_torch as paddle
from paddle_tpu_torch import inference
from paddle_tpu_torch.inference.serving import (
    PredictorServer,
    _recv_exact,
    _recv_tensor,
    _send_tensor,
)
from torch_ref_helpers import jax_twin

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    paddle.set_device("cpu")


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                           P.nn.Linear(16, 4))


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture
def twins():
    paddle.seed(0)
    pm = _mlp(paddle)
    return pm, jax_twin(lambda: _mlp(J), pm)


def _predictors(pm, jm, precision=None):
    cfg, jcfg = inference.Config(), jinf.Config()
    cfg.set_model_obj(pm)
    jcfg.set_model_obj(jm)
    if precision:
        cfg.enable_mixed_precision(precision)
        jcfg.enable_mixed_precision(precision)
    return inference.create_predictor(cfg), jinf.create_predictor(jcfg)


def test_predictor_positional_run_follows_jax(twins):
    pred, jpred = _predictors(*twins)
    for n in (3, 5):
        x = _x(n, 8, seed=n)
        got, want = pred.run([x]), jpred.run([x])
        assert len(got) == len(want) == 1
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5,
                                   atol=1e-6)
    assert len(pred._program._cache) == 2


def test_predictor_handles_follow_jax(twins):
    pred, jpred = _predictors(*twins)
    x = _x(4, 8, seed=1)
    for p in (pred, jpred):
        assert p.get_input_names() == ["x0"]
        p.get_input_handle("x0").copy_from_cpu(x)
        assert p.run() is True
    got = pred.get_output_handle("out0").copy_to_cpu()
    want = jpred.get_output_handle("out0").copy_to_cpu()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert pred.get_output_handle("out0").shape() == [4, 4]


def test_predictor_replays_live_weights(twins):
    pm, _ = twins
    pred, _ = _predictors(*twins)
    x = _x(2, 8, seed=2)
    before = pred.run([x])[0]
    pm[2].bias.set_value(pm[2].bias.numpy() + 1.0)
    np.testing.assert_allclose(pred.run([x])[0], before + 1.0, rtol=1e-5)
    assert len(pred._program._cache) == 1


def test_mixed_precision_casts_once_and_follows_jax(twins):
    pred, jpred = _predictors(*twins, precision="bfloat16")
    assert all(p._data.dtype == torch.bfloat16
               for p in twins[0].parameters())
    x = _x(6, 8, seed=3)
    got = pred.run([x])[0]
    want = np.asarray(jpred.run([x])[0]).astype(np.float32)
    assert got.dtype == np.float32      # bf16 comes back as f32
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_float16_predictor_runs_float16(twins):
    pred, _ = _predictors(*twins, precision="float16")
    out = pred.run([_x(3, 8, seed=4)])[0]
    assert out.dtype == np.float16 and np.isfinite(out).all()


class _TwoFeeds(paddle.nn.Layer):
    def forward(self, a, b):
        return a * 2.0 - b


def test_feeds_bind_by_declared_name(tmp_path):
    m = _TwoFeeds()
    paddle.jit.save(m, str(tmp_path / "two"))
    pred = inference.create_predictor(inference.Config(str(tmp_path /
                                                           "two")))
    pred._inputs = [inference._IOHandle(n) for n in ("a", "b")]
    a, b = _x(3, seed=5), _x(3, seed=6)
    pred.get_input_handle("b").copy_from_cpu(b)
    pred.get_input_handle("a").copy_from_cpu(a)
    pred.run()
    np.testing.assert_allclose(pred.get_output_handle("out0")
                               .copy_to_cpu(), a * 2.0 - b, rtol=1e-6)
    pred._inputs[0]._host = None
    with pytest.raises(ValueError, match="no data"):
        pred.run()


def test_saved_model_serves_through_the_predictor(tmp_path, twins):
    pm, jm = twins
    paddle.jit.save(pm, str(tmp_path / "m"))
    pred = inference.create_predictor(inference.Config(str(tmp_path / "m")))
    x = _x(2, 8, seed=7)
    np.testing.assert_allclose(pred.run([x])[0], jm(J.to_tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_dist_inference_waits_for_distributed(twins):
    """``enable_dist_inference`` is ported (the batch split over two ranks
    is held in ``test_torch_ps.py``): it keeps the mesh and batch axis,
    and over a mesh whose batch axis has one rank the Predictor runs the
    whole batch, equal to the JAX Predictor's."""
    from paddle_tpu_torch.distributed.fleet import build_mesh

    pm, jm = twins
    cfg, jcfg = inference.Config(), jinf.Config()
    cfg.set_model_obj(pm)
    jcfg.set_model_obj(jm)
    mesh = build_mesh(dp=1)
    cfg.enable_dist_inference(mesh, batch_axis="dp")
    assert cfg._dist_mesh is mesh and cfg._dist_batch_axis == "dp"
    x = _x(4, 8, seed=9)
    got = inference.create_predictor(cfg).run([x])[0]
    want = jinf.create_predictor(jcfg).run([x])[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_predictor_server_round_trip(twins):
    pm, jm = twins
    pred, _ = _predictors(pm, jm)
    srv = PredictorServer(pred, host="127.0.0.1")
    try:
        x = _x(3, 8, seed=8)
        s = socket.create_connection(("127.0.0.1", srv.port))
        try:
            s.sendall(struct.pack("<I", 1))
            _send_tensor(s, x)
            status, n_out = struct.unpack("<BI", _recv_exact(s, 5))
            assert status == 0 and n_out == 1
            out = _recv_tensor(s)
        finally:
            s.close()
        np.testing.assert_allclose(out, jm(J.to_tensor(x)).numpy(),
                                   rtol=1e-5, atol=1e-6)
    finally:
        srv.stop()


ENGINE = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=16,
              device="cpu")


def _gen_request(port, ids, max_new):
    s = socket.create_connection(("127.0.0.1", port))
    try:
        s.sendall(struct.pack("<I", 2))
        _send_tensor(s, np.asarray(ids, np.int64))
        _send_tensor(s, np.asarray(max_new, np.int64))
        status, n_out = struct.unpack("<BI", _recv_exact(s, 5))
        assert status == 0
        return [_recv_tensor(s) for _ in range(n_out)][0]
    finally:
        s.close()


@pytest.mark.parametrize("backend", ["engine", "fleet"])
def test_generative_server_tokens_equal_generate(backend):
    """The reference's TestFleetServing on CPU-built port objects: the
    server's completions equal the same engine's direct ``generate``."""
    from paddle_tpu_torch.inference.llm import Fleet, LLMEngine
    from paddle_tpu_torch.models.gpt import gpt_tiny

    torch.manual_seed(0)
    m = gpt_tiny(device="cpu", num_layers=2).eval()
    ids = [3, 4, 5]
    ref = LLMEngine(m, **ENGINE).generate([np.asarray(ids)],
                                          max_new_tokens=4)[0]
    target = LLMEngine(m, **ENGINE) if backend == "engine" else \
        Fleet(m, replicas=2, **ENGINE)
    srv = PredictorServer(**{backend: target})
    try:
        out = _gen_request(srv.port, ids, 4)
    finally:
        srv.stop()
    assert out.shape == (1, 7)
    np.testing.assert_array_equal(out[0], np.asarray(ref))
    with pytest.raises(ValueError, match="exactly one"):
        PredictorServer()
    with pytest.raises(ValueError, match="exactly one"):
        PredictorServer(predictor=object(), fleet=target)
