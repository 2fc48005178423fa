"""A ZeRO-3 parameter read at rest is the whole tensor (ROADMAP C21).

The JAX package's stage 3 is array placement: after
``group_sharded_parallel(level="p_g_os")`` every read of a parameter sees
the whole array.  The port frees each sliced parameter between steps and
keeps this rank's block, so each read must gather.  Held here, at world
size 1 against the JAX package and at world size 2 in a gloo pool:

- every read of a parameter at rest (``numpy()``, ``detach().clone()``,
  ``sum()``, ``torch.equal``, the inner ``state_dict()``, a
  ``paddle.save`` round trip, ``wrapped.parameters()``, the inner
  ``no_grad`` forward, a deep copy) equals the wrapper's gathered
  ``state_dict()`` and the unwrapped port model after the same step,
  bitwise, and the JAX package's values: the weights at 1e-6 (the two
  packages sum a step's products in different orders) and the forward
  at 1e-6 for the Linear net, 1e-4 for GPT (the tolerance of the port's
  GPT forward against JAX, ``test_torch_gpt.py``);
- the leaves hold 0 bytes before and after the reads;
- ``amp.decorate(models=wrapped, level="O2")``, ``jit.to_static(wrapped)``
  and the two in turn after the wrap give the JAX values;
- the inner forward with grad enabled gives the unwrapped model's
  gradients bitwise (and the JAX package's for the Linear net), and a
  write at rest, on the parameter or through a view of it, lands in the
  block (or raises where torch raises);
- at world size 2 a read that one rank makes alone raises within the
  wrapper's ``read_timeout``.

The JAX package steps through its ``TrainStep`` (one compiled program),
which keeps the file within its time: its eager step compiles op by op.
"""

import copy

import numpy as np
import pytest
import torch

import paddle_tpu as J
import torch_dist_pool as TP
from paddle_tpu.distributed.sharding import (
    group_sharded_parallel as jax_group_sharded)
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny

import paddle_tpu_torch as P
from paddle_tpu_torch import amp, jit
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.models.gpt import gpt_tiny

LR = 0.1
WEIGHT_TOL = 1e-6
FORWARD_TOL = {"layer": 1e-6, "gpt": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


def _linear_net(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))


def _layer_weights():
    rng = np.random.RandomState(5)
    return {"0.weight": rng.randn(8, 16).astype(np.float32) * 0.5,
            "0.bias": rng.randn(16).astype(np.float32) * 0.5,
            "2.weight": rng.randn(16, 4).astype(np.float32) * 0.5,
            "2.bias": rng.randn(4).astype(np.float32) * 0.5}


def _gpt_batch():
    rng = np.random.RandomState(1)
    return rng.randint(0, 128, (2, 16)), rng.randint(0, 128, (2, 16))


def _jax_model(kind):
    """(model, loss(out), input) of the JAX package on the shared
    weights."""
    J.seed(0)
    if kind == "layer":
        m = _linear_net(J)
        m.set_state_dict({k: J.to_tensor(v) for k, v in
                          _layer_weights().items()})
        return m, lambda out: out.sum(), \
            J.to_tensor(np.ones((2, 8), np.float32))
    m = jax_gpt_tiny(num_layers=2)
    ids, lab = _gpt_batch()
    lab = J.to_tensor(lab.astype(np.int32))
    return m, lambda out: m.loss(out, lab), J.to_tensor(ids.astype(np.int32))


def _port_model(kind, weights):
    if kind == "layer":
        m = _linear_net(P)
        m.set_state_dict({k: P.to_tensor(v) for k, v in weights.items()})
        return m, lambda out: out.sum(), \
            P.to_tensor(np.ones((2, 8), np.float32))
    m = gpt_tiny(device="cpu", num_layers=2)
    m.set_state_dict(weights)
    ids, lab = _gpt_batch()
    lab = torch.from_numpy(lab)
    return m, lambda out: m.loss(out, lab), torch.from_numpy(ids)


def _step(model, target, loss_of, x, pkg):
    """One SGD step of ``model`` (under p_g_os where ``target`` says so):
    the port's eager, the JAX package's its ``TrainStep`` (one compiled
    program; the eager JAX step compiles each op, ten times slower)."""
    opt = pkg.optimizer.SGD(learning_rate=LR,
                            parameters=model.parameters())
    if target == "p_g_os" and pkg is J:
        # world size 1: a group of one device, as the port's one rank
        wrapped, opt, _ = jax_group_sharded(
            model, opt, level="p_g_os", group=J.distributed.new_group([0]))
    elif target == "p_g_os":
        wrapped, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
    else:
        wrapped = model
    if pkg is J:
        J.jit.TrainStep(wrapped, loss_of, opt)(x)
        return wrapped
    loss_of(wrapped(x)).backward()
    opt.step()
    opt.clear_grad()
    return wrapped


def _np(v):
    v = getattr(v, "_data", v)
    if isinstance(v, torch.Tensor):
        return v.detach().clone().numpy()
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def _as(kind, v):
    """A numpy value as the model's own kind of tensor."""
    return P.to_tensor(v) if kind == "layer" else torch.from_numpy(v)


def _bytes_at_rest(model):
    return sum(getattr(p, "_data", p).untyped_storage().nbytes()
               for p in model.parameters())


_CACHE = {}


def _trained(kind):
    """The JAX and the port run of one SGD step under p_g_os from the
    same weights (the port's ``set_state_dict`` carries the JAX
    ``state_dict()``), and the unwrapped port model after the same
    step."""
    if kind not in _CACHE:
        jm, jloss, jx = _jax_model(kind)
        weights = {k: np.asarray(v.numpy()) for k, v in
                   jm.state_dict().items()}
        jw = _step(jm, "p_g_os", jloss, jx, J)
        jax_out = np.asarray(J.jit.to_static(jm)(jx).numpy())
        jax_w = {k: np.asarray(p.numpy()) for k, p in jm.named_parameters()}
        plain, ploss, px = _port_model(kind, weights)
        _step(plain, None, ploss, px, P)
        with torch.no_grad():
            plain_out = _np(plain(px))
        plain_w = {k: _np(p) for k, p in plain.named_parameters()}
        m, loss_of, x = _port_model(kind, weights)
        wrapped = _step(m, "p_g_os", loss_of, x, P)
        _CACHE[kind] = dict(model=m, wrapped=wrapped, x=x, jax_w=jax_w,
                            jax_out=jax_out, jax_wrapped=jw,
                            plain_w=plain_w, plain_out=plain_out,
                            loss_of=loss_of, weights=weights)
    return _CACHE[kind]


def _reads(kind, read, run, tmp_path):
    """name -> the numpy value that ``read`` gives at rest."""
    m, w = run["model"], run["wrapped"]
    if read == "elements":
        out = {}
        for k, p in m.named_parameters():
            if kind == "layer":
                out[k] = p.numpy()
                assert np.array_equal(p.detach().numpy(), out[k])
                assert np.array_equal(p.clone().numpy(), out[k])
            else:
                out[k] = p.detach().clone().numpy()
                assert torch.equal(p, torch.from_numpy(out[k]))
            assert p.sum().item() == _as(kind, out[k]).sum().item()
        return out
    if read == "parameters":
        out = {k: _np(p) for k, p in w.named_parameters()}
        assert [p.norm().item() for p in w.parameters()] == \
            [_as(kind, v).norm().item() for v in out.values()]
        return out
    if read == "state_dict":
        return {k: _np(v) for k, v in m.state_dict().items()}
    if read == "save":
        from paddle_tpu.framework_io import load as jax_load
        path = str(tmp_path / "inner.pdparams")
        P.save(m.state_dict(), path)
        back, jback = P.load(path), jax_load(path)
        assert back.keys() == jback.keys()
        for k in back:
            assert np.array_equal(_np(back[k]), np.asarray(jback[k]))
        return {k: _np(v) for k, v in back.items()}
    if read == "deepcopy":
        twin = copy.deepcopy(m)
        assert _bytes_at_rest(twin) > 0
        return {k: _np(p) for k, p in twin.named_parameters()}
    raise ValueError(read)


READS = ["elements", "parameters", "state_dict", "save", "deepcopy",
         "forward"]


@pytest.mark.parametrize("read", READS)
@pytest.mark.parametrize("kind", ["layer", "gpt"])
def test_a_read_at_rest_is_the_whole_tensor(kind, read, tmp_path):
    run = _trained(kind)
    m, w = run["model"], run["wrapped"]
    assert _bytes_at_rest(m) == 0
    gathered = {k: _np(v) for k, v in w.state_dict().items()}
    if read == "forward":
        with torch.no_grad():
            inner, outer = _np(m(run["x"])), _np(w(run["x"]))
        assert np.array_equal(inner, outer)
        assert np.array_equal(inner, run["plain_out"])
        np.testing.assert_allclose(inner, run["jax_out"],
                                   rtol=FORWARD_TOL[kind],
                                   atol=FORWARD_TOL[kind])
    else:
        got = _reads(kind, read, run, tmp_path)
        assert got.keys() == gathered.keys() == run["jax_w"].keys()
        for k, v in got.items():
            assert np.array_equal(v, gathered[k]), k
            assert np.array_equal(v, run["plain_w"][k]), k
            np.testing.assert_allclose(v, run["jax_w"][k], rtol=WEIGHT_TOL,
                                       atol=WEIGHT_TOL, err_msg=k)
    assert _bytes_at_rest(m) == 0
    for k, v in w.state_dict().items():
        assert np.array_equal(_np(v), gathered[k]), k


def _fresh_layer_pair():
    weights = _layer_weights()
    jm, jloss, jx = _jax_model("layer")
    jw = _step(jm, "p_g_os", jloss, jx, J)
    m, loss_of, x = _port_model("layer", weights)
    return jw, jx, m, _step(m, "p_g_os", loss_of, x, P), x


@pytest.mark.parametrize("calls", ["amp_decorate", "to_static",
                                   "to_static_then_amp_decorate",
                                   "functional_call"])
def test_calls_after_the_wrap_match_jax(calls):
    """Each call sequence on the wrapped Linear net after its step, in
    both packages on the same weights: the outputs agree at 1e-6 (the
    O2 weights are the same bf16 values; both promote the f32 input's
    product to f32), the port's leaves still hold 0 bytes."""
    jw, jx, m, w, x = _fresh_layer_pair()
    with torch.no_grad():
        eager = w(x).numpy()
    if calls == "functional_call":
        values = {"0.weight": np.full((8, 16), 0.5, np.float32)}
        got = jit.functional_call(w, values, x)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(J.jit.functional_call(jw, values, jx)),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(w(x).numpy(), eager)
    if calls.startswith("to_static"):
        jw, w = J.jit.to_static(jw), jit.to_static(w)
        got = w(x)
        np.testing.assert_allclose(got.numpy(), np.asarray(jw(jx).numpy()),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got.numpy(), eager)
    if calls.endswith("amp_decorate"):
        J.amp.decorate(models=jw, level="O2")
        amp.decorate(models=w, level="O2")
        assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
        for (k, p), (_, jp) in zip(m.named_parameters(),
                                   jw.named_parameters()):
            np.testing.assert_array_equal(
                p.astype("float32").numpy(),
                np.asarray(jp.astype("float32").numpy()), err_msg=k)
        got, want = w(x), jw(jx)
        assert got.dtype == torch.float32 and str(want.dtype) == "float32"
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   rtol=1e-6, atol=1e-6)
    assert _bytes_at_rest(m) == 0


@pytest.mark.parametrize("kind", ["layer", "gpt"])
def test_an_inner_forward_with_grad_gives_the_plain_gradients(kind):
    """After a step under the wrapper, the inner model's own loss and
    backward give each parameter the unwrapped port model's gradient,
    bitwise, and the Linear net the JAX package's eager one (GPT's are
    held against JAX in ``test_torch_train.py``)."""
    weights = _trained(kind)["weights"]
    plain, ploss, px = _port_model(kind, weights)
    _step(plain, None, ploss, px, P)
    ploss(plain(px)).backward()
    m, loss_of, x = _port_model(kind, weights)
    w = _step(m, "p_g_os", loss_of, x, P)
    loss_of(m(x)).backward()
    assert _bytes_at_rest(m) == 0
    want = dict(plain.named_parameters())
    for k, p in m.named_parameters():
        assert np.array_equal(_np(p.grad), _np(want[k].grad)), k
    if kind == "layer":
        jm, jloss, jx = _jax_model(kind)
        _step(jm, "p_g_os", jloss, jx, J)
        jloss(jm(jx)).backward()
        for k, p in jm.named_parameters():
            np.testing.assert_allclose(_np(want[k].grad),
                                       np.asarray(p.grad.numpy()),
                                       rtol=WEIGHT_TOL, atol=WEIGHT_TOL,
                                       err_msg=k)
    assert w is not m


def _torch_write(write, p, value):
    """The write ``write`` of a torch parameter ``p``: ``value`` (a
    numpy array of its shape) where the write takes one."""
    if write == "copy_":
        p.copy_(torch.from_numpy(value))
    elif write == "data":
        p.data = torch.from_numpy(value.copy())
    elif write == "setitem":
        p[1:] = torch.from_numpy(value[1:])
    elif write == "view_fill":
        p.view(-1)[5:].fill_(0.5)
    elif write == "relu_inplace":
        torch.nn.functional.relu(p, inplace=True)
    elif write == "orthogonal":
        # tensor.view_as(q).copy_(q), then tensor.mul_(gain)
        torch.nn.init.orthogonal_(p, gain=2.0)
    else:
        raise ValueError(write)


TORCH_WRITES = ["copy_", "data", "setitem", "view_fill", "relu_inplace",
                "orthogonal"]


@pytest.mark.parametrize("write", ["set_value", "set_state_dict"]
                         + TORCH_WRITES)
def test_a_write_at_rest_lands_in_the_block(write):
    """A write of a parameter at rest lands in its block: each leaves
    the parameter what the same write leaves in a plain torch parameter
    of the same value (or raises where that raises, with grad on)."""
    kind = "layer" if write in ("set_value", "set_state_dict") else "gpt"
    run = _trained(kind)
    weights = run["weights"]
    m, loss_of, x = _port_model(kind, weights)
    w = _step(m, "p_g_os", loss_of, x, P)
    new = {k: np.full_like(v, 0.25) + np.arange(v.size, dtype=v.dtype)
           .reshape(v.shape) * 1e-3 for k, v in weights.items()}
    params = dict(m.named_parameters())
    if write == "set_value":
        for k, v in new.items():
            params[k].set_value(v)
    elif write == "set_state_dict":
        m.set_state_dict({k: P.to_tensor(v) for k, v in new.items()})
    else:
        name = "gpt.embeddings.word_embeddings.weight"
        new = {k: _np(v) for k, v in w.state_dict().items()}
        value = np.full_like(new[name], 0.5)
        plain = torch.nn.Parameter(torch.from_numpy(new[name].copy()))
        for grad in (True, False):
            with torch.set_grad_enabled(grad):
                torch.manual_seed(0)
                try:
                    _torch_write(write, plain, value)
                except RuntimeError as e:
                    assert grad and "in-place" in str(e)
                    with pytest.raises(RuntimeError, match="in-place"):
                        _torch_write(write, params[name], value)
                    continue
                torch.manual_seed(0)
                _torch_write(write, params[name], value)
        new[name] = _np(plain)
    assert _bytes_at_rest(m) == 0
    for k, v in w.state_dict().items():
        assert np.array_equal(_np(v), new[k]), k
        assert np.array_equal(_np(params[k]), new[k]), k
    twin, _, _ = _port_model(kind, new)
    with torch.no_grad():
        assert np.array_equal(_np(w(x)), _np(twin(x)))


def test_a_view_at_rest_reads_and_writes_the_block():
    """A view taken at rest sees a later write of its parameter and
    writes into the block; an array read at rest is read-only."""
    run = _trained("gpt")
    m, loss_of, x = _port_model("gpt", run["weights"])
    w = _step(m, "p_g_os", loss_of, x, P)
    p = dict(m.named_parameters())["gpt.embeddings.word_embeddings.weight"]
    plain = torch.from_numpy(_np(w.state_dict()[
        "gpt.embeddings.word_embeddings.weight"]))
    view, want = p.T[3], plain.T[3]
    assert torch.equal(view, want)
    with torch.no_grad():
        p.mul_(0.5)
        plain.mul_(0.5)
        assert torch.equal(view, want)
        view[2:7] = 4.0
        want[2:7] = 4.0
    assert torch.equal(p, plain) and _bytes_at_rest(m) == 0
    array = p.detach().numpy()
    assert np.array_equal(array, plain.numpy())
    with pytest.raises(ValueError, match="read-only"):
        array[0, 0] = 1.0
    assert torch.equal(p, plain)


@pytest.fixture(scope="module")
def pool():
    p = TP.RankPool(2)
    yield p
    p.close()


def test_world_size_2_reads_at_rest(pool):
    _, weights, _ = TP.plain_sharded_reference()
    outs = pool.run(TP.zero3_reads_task)
    for out in outs:
        for stage in ("before", "after"):
            assert out[stage]["leaf_bytes"] == 0, stage
            # fc1.weight [16, 64] and fc2.weight [64, 16]: half the rows
            assert out[stage]["blocks"]["fc1.weight"] == (8, 64)
            assert out[stage]["blocks"]["fc2.weight"] == (32, 16)
        gathered = out["gathered"]
        for read in ("numpy", "detach_clone", "state_dict"):
            assert out[read].keys() == weights.keys()
            for k, v in out[read].items():
                assert np.array_equal(v, gathered[k]), (read, k)
                np.testing.assert_allclose(v, weights[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
        assert np.array_equal(out["forward"], out["wrapped_forward"])
    assert all(np.array_equal(outs[0]["numpy"][k], outs[1]["numpy"][k])
               for k in weights)
    # a read that rank 0 makes alone raises, naming the wrapper
    assert "GroupShardedStage3" in outs[0]["alone"]
    assert outs[1]["alone"] is None
