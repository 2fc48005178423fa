"""The port's MoE (``incubate/distributed/models/moe``) against the JAX
package's.

With the same numpy logits and weights (carried by ``set_state_dict``):

- ``topk_gating`` equals the JAX gating (combine, dispatch, aux loss,
  probs; top-1, top-2 and a capacity that drops tokens);
- ``MoELayer`` (naive top-2 and GShard) equals the JAX layer, forward,
  aux loss and the gradients of every parameter and of x (1e-5);
- ``ClipGradForMOEByGlobalNorm`` clips the JAX way;
- over two gloo ranks (one module-scoped pool, ``torch_dist_pool``), an
  expert-parallel ``MoELayer`` (each rank two of four experts and its
  own tokens, the tokens out and back by ``all_to_all_single``) equals
  the one-process layer run on each rank's tokens: output, aux loss,
  dx, the gate's gradient of the rank's own tokens, each expert's
  gradient summed over both ranks' tokens, and the MoE clip's norm
  with the expert share summed over the group.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as J
from paddle_tpu.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm as JClip, MoELayer as JMoELayer)
from paddle_tpu.incubate.distributed.models.moe.gate import \
    topk_gating as jax_topk_gating

import paddle_tpu_torch as P
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm, MoELayer)
from paddle_tpu_torch.incubate.distributed.models.moe.gate import topk_gating
import torch_dist_pool as TP
import torch_parallel_tasks as T


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


@pytest.fixture(scope="module")
def pool():
    p = TP.RankPool(2)
    yield p
    p.close()


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("top_k,cf,logits", [
    (1, 8.0, "rand"), (2, 8.0, "rand"), (2, 0.5, "rand"), (1, 0.5, "zeros")])
def test_gating_matches_jax(top_k, cf, logits):
    x = _rand((64, 8), 0) if logits == "rand" else np.zeros((64, 4),
                                                              np.float32)
    got = topk_gating(torch.from_numpy(x), top_k, cf)
    want = jax_topk_gating(jnp.asarray(x), top_k, cf)
    for k in ("combine", "probs"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(got["dispatch"].numpy(),
                                  np.asarray(want["dispatch"]))
    np.testing.assert_allclose(float(got["aux_loss"]),
                               float(want["aux_loss"]), rtol=1e-6)


def _weights(d=16, f=32, e=4, seed=3):
    return {"gate_weight": _rand((d, e), seed, 0.5),
            "w1": _rand((e, d, f), seed + 1, 0.2),
            "b1": _rand((e, f), seed + 2, 0.1),
            "w2": _rand((e, f, d), seed + 3, 0.2),
            "b2": _rand((e, d), seed + 4, 0.1)}


def _jax_layer(sd, gate, top_k, cf):
    J.seed(0)
    e, d, f = sd["w1"].shape
    layer = JMoELayer(d_model=d, d_hidden=f, num_experts=e, gate=gate,
                      top_k=top_k, capacity_factor=cf)
    layer.set_state_dict({k: J.to_tensor(v) for k, v in sd.items()})
    layer.eval()
    return layer


def _port_layer(sd, gate, top_k, cf):
    P.seed(0)
    e, d, f = sd["w1"].shape
    layer = MoELayer(d_model=d, d_hidden=f, num_experts=e, gate=gate,
                     top_k=top_k, capacity_factor=cf)
    layer.set_state_dict({k: P.to_tensor(v) for k, v in sd.items()})
    layer.eval()
    return layer


def _run(layer, pkg, x, dy):
    xt = pkg.to_tensor(x, stop_gradient=False)
    out = layer(xt)
    (out * pkg.to_tensor(dy)).sum().backward()
    return (out.numpy(), float(layer.l_aux.numpy()), xt.grad.numpy(),
            {n: p.grad.numpy() for n, p in layer.named_parameters()})


@pytest.mark.parametrize("gate,top_k,cf", [("naive", 2, 8.0),
                                           ("gshard", None, None),
                                           ("gshard", 2, 0.5)])
def test_moe_layer_forward_and_grads_match_jax(gate, top_k, cf):
    sd = _weights()
    x, dy = _rand((2, 8, 16), 1), _rand((2, 8, 16), 2)
    got = _run(_port_layer(sd, gate, top_k, cf), P, x, dy)
    want = _run(_jax_layer(sd, gate, top_k, cf), J, x, dy)
    for a, b, what in zip(got[:3], want[:3], ("out", "aux", "dx")):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=what)
    for n in want[3]:
        np.testing.assert_allclose(got[3][n], want[3][n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_moe_clip_matches_jax():
    sd = _weights()
    x, dy = _rand((2, 8, 16), 1), _rand((2, 8, 16), 2)
    out = {}
    for pkg, make, clip in ((P, _port_layer, ClipGradForMOEByGlobalNorm),
                            (J, _jax_layer, JClip)):
        layer = make(sd, "gshard", None, None)
        opt = pkg.optimizer.SGD(learning_rate=1.0,
                                parameters=layer.parameters(),
                                grad_clip=clip(0.05))
        _run(layer, pkg, x, dy)
        opt.step()
        out[pkg] = {n: p.numpy() for n, p in layer.named_parameters()}
    for n in out[J]:
        np.testing.assert_allclose(out[P][n], out[J][n], rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_expert_parallel_over_two_ranks_equals_one_process(pool):
    sd = _weights()
    xs = np.stack([_rand((2, 8, 16), 11), _rand((2, 8, 16), 12)])
    dys = np.stack([_rand((2, 8, 16), 13), _rand((2, 8, 16), 14)])
    got = pool.run(T.moe_task, sd, xs, dys, "gshard", None, None)
    dense = [_run(_port_layer(sd, "gshard", None, None), P, xs[r], dys[r])
             for r in range(2)]
    expert_sum = {n: dense[0][3][n] + dense[1][3][n]
                  for n in ("w1", "b1", "w2", "b2")}
    sq_dense = [float(np.sum(d[3]["gate_weight"] ** 2)) for d in dense]
    for r, res in enumerate(got):
        out, aux, dx, grads = dense[r]
        np.testing.assert_allclose(res["out"], out, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["aux"], aux, rtol=1e-6)
        np.testing.assert_allclose(res["dx"], dx, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["grads"]["gate_weight"],
                                   grads["gate_weight"], rtol=1e-5,
                                   atol=1e-6)
        for n, g in expert_sum.items():
            np.testing.assert_allclose(res["grads"][n], g[2 * r:2 * r + 2],
                                       rtol=1e-5, atol=1e-6, err_msg=n)
        want_norm = np.sqrt(sq_dense[r] + sum(
            float(np.sum(g ** 2)) for g in expert_sum.values()))
        np.testing.assert_allclose(res["norm"], want_norm, rtol=1e-5)
