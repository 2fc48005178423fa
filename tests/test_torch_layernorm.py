"""The port's LayerNorm (B4) against the JAX package on the CPU.

On the CPU ``paddle_tpu_torch.nn.functional.layer_norm`` is the JAX
composition (the CUDA kernels' plain version), with autograd for the
gradients.  It is held to the Pallas kernel in interpret mode
(``layernorm_pallas(interpret=True)``) and to the JAX
``F.layer_norm`` on ``tests/test_pallas_kernels.py``'s case: forward at
1e-5, gradients at 2e-4.  The kernels' plain contracts
(``layernorm_fwd_plain`` with mu and rstd, ``layernorm_bwd_plain``) are
held to the Pallas ``_ln_fwd``/``_ln_bwd`` directly; the CUDA kernels
are held to them on the card by ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.pallas.layernorm_kernel import (
    _ln_bwd,
    _ln_fwd,
    layernorm_pallas,
)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import layernorm_kernel as lnk


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _case():
    x = _rand((4, 64, 128), 20)
    g = _rand((128,), 21) * 0.1 + 1.0
    b = _rand((128,), 22) * 0.1
    return x, g, b


def test_forward_matches_pallas_and_jax_layer_norm():
    x, g, b = _case()
    got = F.layer_norm(torch.from_numpy(x), 128, torch.from_numpy(g),
                       torch.from_numpy(b)).numpy()
    pallas = layernorm_pallas(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                              interpret=True)
    ref = JF.layer_norm(paddle.to_tensor(x), 128, paddle.to_tensor(g),
                        paddle.to_tensor(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_grads_match_pallas():
    x, g, b = _case()
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    torch.sin(F.layer_norm(tx, 128, tg, tb)).sum().backward()

    def loss(x, g, b):
        return jnp.sum(jnp.sin(layernorm_pallas(x, g, b, interpret=True)))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    for t, w, name in zip((tx, tg, tb), want, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_plain_contracts_match_pallas_fwd_and_bwd():
    """(y, mu, rstd) and (dx, dgamma, dbeta) of the kernels' plain
    versions against the Pallas ``_ln_fwd``/``_ln_bwd``."""
    x, g, b = _case()
    x2d = x.reshape(256, 128)
    dy = _rand((256, 128), 23)
    y, mu, rstd = lnk.layernorm_fwd_plain(
        torch.from_numpy(x2d), torch.from_numpy(g), torch.from_numpy(b), 1e-5)
    jy, jmu, jrstd = _ln_fwd(jnp.asarray(x2d), jnp.asarray(g), jnp.asarray(b),
                             1e-5, 64, True)
    for got, want in ((y, jy), (mu, jmu[:, 0]), (rstd, jrstd[:, 0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    dx, dg, db = lnk.layernorm_bwd_plain(
        torch.from_numpy(x2d), torch.from_numpy(g), mu, rstd,
        torch.from_numpy(dy))
    want = _ln_bwd(jnp.asarray(x2d), jnp.asarray(g), jmu, jrstd,
                   jnp.asarray(dy), 64, True)
    for got, w, name in zip((dx, dg, db), want, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_plain_contracts_are_the_cpu_composition():
    """One composition: in bf16 the kernels' plain versions give what
    ``F.layer_norm`` and its autograd give on the CPU, bitwise."""
    x, g, b = (torch.from_numpy(a).to(torch.bfloat16) for a in _case())
    x2d = x.reshape(256, 128)
    dy = torch.from_numpy(_rand((256, 128), 28)).to(torch.bfloat16)
    y, mu, rstd = lnk.layernorm_fwd_plain(x2d, g, b, 1e-5)
    assert y.dtype == torch.bfloat16 and mu.dtype == torch.float32
    torch.testing.assert_close(y, F.layer_norm(x2d, 128, g, b), rtol=0,
                               atol=0)
    dx, dg, db = lnk.layernorm_bwd_plain(x2d, g, mu, rstd, dy)
    tx, tg, tb = (t.detach().requires_grad_() for t in (x2d, g, b))
    F.layer_norm(tx, 128, tg, tb).backward(dy)
    torch.testing.assert_close(dx, tx.grad, rtol=0, atol=0)
    torch.testing.assert_close(dg, tg.grad.float(), rtol=0, atol=0)
    torch.testing.assert_close(db, tb.grad.float(), rtol=0, atol=0)


def test_row_count_no_block_divides():
    """21 rows: no TPU row block divides them; the port takes them."""
    x = _rand((3, 7, 128), 24)
    g = _rand((128,), 25) * 0.1 + 1.0
    b = _rand((128,), 26) * 0.1
    got = F.layer_norm(torch.from_numpy(x), [128], torch.from_numpy(g),
                       torch.from_numpy(b)).numpy()
    ref = JF.layer_norm(paddle.to_tensor(x), [128], paddle.to_tensor(g),
                        paddle.to_tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert lnk.supports(21, 128)


def test_plain_routes_without_weight_or_over_two_dims():
    x = _rand((2, 4, 8, 16), 27)
    ref = JF.layer_norm(paddle.to_tensor(x), [8, 16]).numpy()
    got = F.layer_norm(torch.from_numpy(x), [8, 16]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    ref = JF.layer_norm(paddle.to_tensor(x), 16).numpy()
    got = F.layer_norm(torch.from_numpy(x), 16).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_supports_and_backward_partials():
    assert lnk.supports(8192, 768, torch.bfloat16)
    assert lnk.supports(8193, 768)
    assert lnk.supports(256, 128)
    assert lnk.supports(7, 2048)
    assert not lnk.supports(256, 100)       # not a multiple of 8
    assert not lnk.supports(256, 4096)      # beyond the register rows
    assert not lnk.supports(256, 128, torch.float16)
    # the backward's plan: one wave of at most ``slots`` blocks (two on
    # each of an H100's 132 SMs here), each owning an even run of rows
    # and writing one partial row, then C / 4 reduce blocks
    slots = 2 * 132
    for rows in (1, 5, 21, 256, 8190, 8192, 8193, 10 ** 6):
        for c in (8, 128, 520, 768, 1024, 2048):
            grid, reduce_grid = lnk.bwd_plan(rows, c, slots)
            assert 1 <= grid <= min(slots, -(-rows // lnk.BWD_WARPS))
            bounds = np.arange(grid + 1, dtype=np.int64) * rows // grid
            owned = np.diff(bounds)
            assert owned.sum() == rows and owned.min() >= 1
            assert owned.max() - owned.min() <= 1
            assert reduce_grid * lnk.RED_COLS == 2 * c
    assert lnk.bwd_plan(8192, 768, slots) == (264, 192)   # >= 132 SMs
    assert lnk.bwd_plan(5, 768, slots) == (1, 192)        # rows < blocks
    assert lnk.bwd_plan(10 ** 6, 768, slots)[0] == slots
    assert lnk.bwd_plan(8192, 768, 132)[0] == 132     # one block an SM


def test_backward_plan_constants_are_the_kernel_constexprs():
    """The host's warps a block and columns a reduce block are the
    constexprs ``csrc/layernorm.cu`` launches with."""
    src = (Path(lnk.__file__).resolve().parents[2] / "csrc"
           / "layernorm.cu").read_text()

    def constexpr(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert constexpr("kBwdWarps") == lnk.BWD_WARPS
    assert constexpr("kRedCols") == lnk.RED_COLS
    assert constexpr("kRedThreads") % lnk.RED_COLS == 0


def test_cuda_wrappers_raise_on_cpu_tensors():
    x = torch.zeros(4, 128)
    g = torch.ones(128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lnk.layernorm_fwd_cuda(x, g, g, 1e-5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lnk.layernorm_cuda(x, g, g)
    stats = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lnk.layernorm_bwd_cuda(x, g, stats, stats, x)
