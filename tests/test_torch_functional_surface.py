"""The rest of the functional surface against the JAX package's.

``nn.functional``'s twelve late functions and the whole
``cross_entropy``, ``nn.Upsample``, the eight ``incubate.nn.functional``
fused functions, ``fft`` and ``signal``: each case takes the same seeded
numpy inputs through both packages; outputs agree at the case's
tolerance and so do the gradients of ``sum(out * w)`` (``w`` seeded)
for every float input marked for it.  The random functions
(``alpha_dropout``, ``gumbel_softmax``, the registry's random ops and
dropout-bearing fused functions) cannot repeat the JAX key stream: they
are held by shape, range, moments and seed repeatability.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.incubate.nn.functional as JIF
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.dispatch import enable_dispatch_cache

import paddle_tpu_torch as P
import paddle_tpu_torch.incubate.nn.functional as PIF
import paddle_tpu_torch.nn.functional as PF

R = np.random.RandomState(17)


def _u(*shape):
    return R.uniform(-1, 1, shape).astype(np.float32)


def _p(*shape):
    return R.uniform(0.05, 1, shape).astype(np.float32)


X4 = _u(2, 3, 6, 5)
LOGITS = _u(6, 5)
LBL = np.array([1, 4, 0, 2, -100, 3])
SOFT = _p(6, 5) / _p(6, 5).sum()
W5 = _p(5)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")
    enable_dispatch_cache(False)
    yield
    enable_dispatch_cache(True)


def _ns(m):
    return {"F": JF if m is J else PF, "IF": JIF if m is J else PIF, "m": m}


# name, fn(ns, *tensors), float inputs, indices graded, other inputs, tol
CASES = [
    ("interpolate_nearest",
     lambda n, x: n["F"].interpolate(x, size=[9, 4]), [X4], (), [], 1e-6),
    ("interpolate_bilinear_up",
     lambda n, x: n["F"].interpolate(x, scale_factor=2, mode="bilinear"),
     [X4], (0,), [], 1e-5),
    ("interpolate_bilinear_down",
     lambda n, x: n["F"].interpolate(x, size=[4, 3], mode="bilinear"),
     [X4], (0,), [], 1e-5),
    ("interpolate_bicubic",
     lambda n, x: n["F"].interpolate(x, size=[7, 8], mode="bicubic"),
     [X4], (0,), [], 1e-5),
    ("interpolate_area",
     lambda n, x: n["F"].interpolate(x, size=[3, 2], mode="area"),
     [X4], (0,), [], 1e-5),
    ("upsample", lambda n, x: n["F"].upsample(x, size=[8, 10],
                                              mode="bilinear"),
     [X4], (0,), [], 1e-5),
    ("Upsample", lambda n, x: n["m"].nn.Upsample(scale_factor=2)(x),
     [X4], (0,), [], 1e-6),
    ("sequence_mask", lambda n, lens: n["F"].sequence_mask(lens),
     [], (), [np.array([3, 0, 5, 1])], 0),
    ("sequence_mask_maxlen",
     lambda n, lens: n["F"].sequence_mask(lens, maxlen=7, dtype="float32"),
     [], (), [np.array([3, 0, 5, 1])], 0),
    ("softmax_with_cross_entropy",
     lambda n, x, lbl: n["F"].softmax_with_cross_entropy(
         x, lbl[:, None], return_softmax=True),
     [LOGITS], (0,), [np.abs(LBL) % 5], 1e-5),
    ("softmax_with_cross_entropy_soft",
     lambda n, x, s: n["F"].softmax_with_cross_entropy(x, s,
                                                       soft_label=True),
     [LOGITS], (0,), [SOFT], 1e-5),
    ("sigmoid_focal_loss",
     lambda n, x, y: n["F"].sigmoid_focal_loss(x, y),
     [LOGITS], (0,), [(R.rand(6, 5) > 0.5).astype(np.float32)], 1e-5),
    ("sigmoid_focal_loss_norm",
     lambda n, x, y, z: n["F"].sigmoid_focal_loss(x, y, normalizer=z,
                                                  reduction="mean"),
     [LOGITS], (0,), [(R.rand(6, 5) > 0.5).astype(np.float32),
                      np.array([3.0], np.float32)], 1e-5),
    ("square_error_cost", lambda n, x, y: n["F"].square_error_cost(x, y),
     [LOGITS, _u(6, 5)], (0, 1), [], 1e-6),
    ("cosine_embedding_loss",
     lambda n, a, b, lbl: n["F"].cosine_embedding_loss(a, b, lbl,
                                                       margin=0.1),
     [_u(6, 4), _u(6, 4)], (0, 1), [np.array([1, -1, 1, -1, -1, 1])], 1e-5),
    ("hinge_embedding_loss",
     lambda n, x, lbl: n["F"].hinge_embedding_loss(x, lbl, margin=0.5),
     [LOGITS], (0,), [np.where(R.rand(6, 5) > 0.5, 1.0, -1.0).astype(
         np.float32)], 1e-6),
    ("triplet_margin_loss",
     lambda n, a, p, q: n["F"].triplet_margin_loss(a, p, q, swap=True),
     [_u(5, 4), _u(5, 4), _u(5, 4)], (0, 1, 2), [], 1e-5),
    ("ctc_loss",
     lambda n, lp, lbl, il, ll: n["F"].ctc_loss(lp, lbl, il, ll),
     [_u(12, 3, 6)], (0,), [np.array([[1, 2, 2], [3, 1, 0], [5, 0, 0]],
                                     np.int32),
                            np.array([12, 9, 5], np.int32),
                            np.array([3, 2, 1], np.int32)], 1e-4),
    ("ctc_loss_sum_norm",
     lambda n, lp, lbl, il, ll: n["F"].ctc_loss(lp, lbl, il, ll,
                                                reduction="none",
                                                norm_by_times=True),
     [_u(12, 3, 6)], (0,), [np.array([[1, 2, 2], [3, 1, 0], [5, 0, 0]],
                                     np.int32),
                            np.array([12, 9, 2], np.int32),
                            np.array([3, 2, 1], np.int32)], 1e-4),
    # a repeated label needs a blank between: 2 frames cannot align it,
    # and optax's log(0) = -1e5 gives a large finite loss, not inf (its
    # gradient is f32 rounding of sums near -1e5 in both packages, so
    # the values are held, not the gradient)
    ("ctc_loss_impossible",
     lambda n, lp, lbl, il, ll: n["F"].ctc_loss(lp, lbl, il, ll,
                                                reduction="none"),
     [_u(4, 2, 5)], (), [np.array([[2, 2], [1, 3]], np.int32),
                           np.array([2, 4], np.int32),
                           np.array([2, 2], np.int32)], 1e-4),
    # the whole cross_entropy
    ("ce_hard", lambda n, x, lbl: n["F"].cross_entropy(x, lbl),
     [LOGITS], (0,), [LBL], 1e-6),
    ("ce_soft", lambda n, x, s: n["F"].cross_entropy(x, s, soft_label=True),
     [LOGITS], (0,), [SOFT], 1e-6),
    ("ce_soft_smooth",
     lambda n, x, s: n["F"].cross_entropy(x, s, soft_label=True,
                                          label_smoothing=0.2,
                                          reduction="sum"),
     [LOGITS], (0,), [SOFT], 1e-6),
    ("ce_weight", lambda n, x, lbl, w: n["F"].cross_entropy(x, lbl, weight=w),
     [LOGITS], (0,), [LBL, W5], 1e-6),
    ("ce_weight_none",
     lambda n, x, lbl, w: n["F"].cross_entropy(x, lbl, weight=w,
                                               reduction="none"),
     [LOGITS], (0,), [LBL, W5], 1e-6),
    ("ce_smoothing",
     lambda n, x, lbl: n["F"].cross_entropy(x, lbl, label_smoothing=0.1),
     [LOGITS], (0,), [LBL], 1e-6),
    ("ce_axis0",
     lambda n, x, lbl: n["F"].cross_entropy(x, lbl, axis=0,
                                            reduction="sum"),
     [LOGITS.T.copy()], (0,), [np.abs(LBL) % 5], 1e-6),
    ("ce_axis1_3d",
     lambda n, x, lbl: n["F"].cross_entropy(x, lbl, axis=1),
     [_u(2, 5, 3)], (0,), [np.array([[1, 0, 4], [2, 2, 3]])], 1e-6),
    ("ce_probabilities",
     lambda n, x, lbl: n["F"].cross_entropy(x, lbl, use_softmax=False),
     [_p(6, 5)], (0,), [np.abs(LBL) % 5], 1e-6),
    # incubate.nn.functional
    ("fused_matmul_bias",
     lambda n, x, y, b: n["IF"].fused_matmul_bias(x, y, b,
                                                  transpose_y=True),
     [_u(4, 6), _u(3, 6), _u(3)], (0, 1, 2), [], 1e-5),
    ("fused_linear", lambda n, x, w, b: n["IF"].fused_linear(x, w, b),
     [_u(2, 4, 6), _u(6, 3), _u(3)], (0, 1, 2), [], 1e-5),
    ("fused_feedforward",
     lambda n, x, w1, w2, b1, b2, s, c: n["IF"].fused_feedforward(
         x, w1, w2, b1, b2, ln1_scale=s, ln1_bias=c, pre_layer_norm=True,
         activation="gelu", training=False),
     [_u(2, 4, 8), _u(8, 16), _u(16, 8), _u(16), _u(8), _p(8), _u(8)],
     (0, 1, 2, 3, 4, 5, 6), [], 1e-5),
    ("fused_multi_head_attention",
     lambda n, x, qkv, lw, qb, lb, s, c: n["IF"].fused_multi_head_attention(
         x, qkv, lw, qkv_bias=qb, linear_bias=lb, ln_scale=s, ln_bias=c,
         num_heads=2, training=True, dropout_rate=0.0,
         attn_dropout_rate=0.0),
     [_u(2, 5, 8), _u(3, 2, 4, 8), _u(8, 8), _u(3, 2, 4), _u(8), _p(8),
      _u(8)], (0, 1, 2, 3, 4, 5, 6), [], 1e-5),
    ("fused_multi_head_attention_pre_ln_mask",
     lambda n, x, qkv, lw, s, c, mask: n["IF"].fused_multi_head_attention(
         x, qkv, lw, pre_layer_norm=True, pre_ln_scale=s, pre_ln_bias=c,
         attn_mask=mask, num_heads=2, training=False),
     [_u(2, 5, 8), _u(3, 2, 4, 8), _u(8, 8), _p(8), _u(8)], (0, 1, 2, 3, 4),
     [np.where(R.rand(2, 1, 5, 5) < 0.3, -1e4, 0.0).astype(np.float32)],
     1e-5),
    ("fused_dropout_add_eval",
     lambda n, x, y: n["IF"].fused_dropout_add(x, y, p=0.3, training=False),
     [_u(3, 4), _u(3, 4)], (0, 1), [], 1e-6),
    ("fused_bias_dropout_residual_layer_norm",
     lambda n, x, r, b, s, c: n["IF"].fused_bias_dropout_residual_layer_norm(
         x, r, b, s, c, dropout_rate=0.0),
     [_u(2, 3, 8), _u(2, 3, 8), _u(8), _p(8), _u(8)], (0, 1, 2, 3, 4), [],
     1e-5),
    ("fused_ec_moe",
     lambda n, x, gw, gb, w1, b1, w2, b2: n["IF"].fused_ec_moe(
         x, gw, gb, w1, b1, w2, b2),
     [_u(2, 3, 6), _u(6, 4), _u(4), _u(4, 6, 5), _u(4, 5), _u(4, 5, 6),
      _u(4, 6)], (0, 1, 2, 3, 4, 5, 6), [], 1e-5),
    ("fused_rope_neox",
     lambda n, q, k: n["IF"].fused_rotary_position_embedding(q, k)[:2],
     [_u(2, 5, 2, 8), _u(2, 5, 2, 8)], (0, 1), [], 1e-5),
    ("fused_rope_half_positions",
     lambda n, q, pos: n["IF"].fused_rotary_position_embedding(
         q, position_ids=pos, use_neox_rotary_style=False)[0],
     [_u(2, 5, 2, 8)], (0,), [np.array([[4, 3, 2, 1, 0], [0, 2, 4, 6, 8]])],
     1e-5),
    ("fused_rope_cache",
     lambda n, q, sn, cs: n["IF"].fused_rotary_position_embedding(
         q, sin=sn, cos=cs)[0],
     [_u(2, 5, 2, 8)], (0,), [_u(1, 9, 1, 8), _u(1, 9, 1, 8)], 1e-5),
    # fft / signal
    ("fft", lambda n, x: n["m"].fft.fft(x, n=10, norm="ortho"),
     [_u(3, 8)], (0,), [], 1e-5),
    ("ifft2", lambda n, x: n["m"].fft.ifft2(x),
     [_u(3, 4, 6)], (0,), [], 1e-5),
    ("rfftn", lambda n, x: n["m"].fft.rfftn(x, axes=[0, 2], norm="forward"),
     [_u(4, 3, 6)], (0,), [], 1e-5),
    ("irfft", lambda n, x: n["m"].fft.irfft(n["m"].fft.rfft(x), n=9),
     [_u(3, 9)], (0,), [], 1e-5),
    ("hfft_ihfft", lambda n, x: n["m"].fft.hfft(n["m"].fft.ihfft(x)),
     [_u(2, 8)], (0,), [], 1e-5),
    ("irfft2", lambda n, x: n["m"].fft.irfft2(n["m"].fft.rfft2(x)),
     [_u(2, 4, 6)], (0,), [], 1e-5),
    ("fftn_ifftn", lambda n, x: n["m"].fft.ifftn(n["m"].fft.fftn(x, s=[5, 7])),
     [_u(4, 6)], (0,), [], 1e-5),
    ("irfftn", lambda n, x: n["m"].fft.irfftn(n["m"].fft.rfftn(x)),
     [_u(4, 6)], (0,), [], 1e-5),
    ("fftshift", lambda n, x: n["m"].fft.ifftshift(
        n["m"].fft.fftshift(x, axes=[1]) * 2.0),
     [_u(3, 5)], (0,), [], 1e-6),
    ("frame", lambda n, x: n["m"].signal.frame(x, 4, 2), [_u(2, 11)], (0,),
     [], 1e-6),
    ("frame_axis0", lambda n, x: n["m"].signal.frame(x, 3, 2, axis=0),
     [_u(9, 2)], (0,), [], 1e-6),
    ("overlap_add", lambda n, x: n["m"].signal.overlap_add(x, 2),
     [_u(2, 4, 5)], (0,), [], 1e-6),
    ("overlap_add_axis0",
     lambda n, x: n["m"].signal.overlap_add(x, 3, axis=0),
     [_u(4, 5, 2)], (0,), [], 1e-6),
    ("stft", lambda n, x, w: n["m"].signal.stft(x, 16, window=w),
     [_u(2, 64), _p(16)], (0, 1), [], 1e-5),
    ("stft_short_window",
     lambda n, x, w: n["m"].signal.stft(x, 16, hop_length=5, win_length=8,
                                        window=w, normalized=True,
                                        center=False),
     [_u(2, 64), _p(8)], (0, 1), [], 1e-5),
    ("istft",
     lambda n, x, w: n["m"].signal.istft(
         n["m"].signal.stft(x, 16, window=w), 16, window=w, length=60),
     [_u(2, 64), _p(16) + 0.5], (0,), [], 1e-4),
]


def _run(m, fn, floats, graded, others):
    ts = [m.to_tensor(a, stop_gradient=i not in graded)
          for i, a in enumerate(floats)]
    out = fn(_ns(m), *ts, *[m.to_tensor(o) for o in others])
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    outs = [o for o in outs if o is not None]
    vals = [np.asarray(o.numpy()) for o in outs]
    grads = []
    if graded:
        rng = np.random.RandomState(3)
        loss = None
        for o, v in zip(outs, vals):
            parts = [m.real(o), m.imag(o)] if np.iscomplexobj(v) else [o]
            for part in parts:
                if not np.issubdtype(v.dtype, np.inexact):
                    continue
                w = m.to_tensor(rng.uniform(0.5, 1.5, v.shape).astype(
                    np.float32))
                term = m.sum(part * w)
                loss = term if loss is None else loss + term
        loss.backward()
        for i in graded:
            g = ts[i].grad
            grads.append(np.zeros_like(floats[i]) if g is None
                         else np.asarray(g.numpy()))
    return vals, grads


@pytest.mark.parametrize("name,fn,floats,graded,others,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_matches_jax(name, fn, floats, graded, others, tol):
    got_v, got_g = _run(P, fn, floats, graded, others)
    want_v, want_g = _run(J, fn, floats, graded, others)
    assert len(got_v) == len(want_v), name
    for g, w in zip(got_v, want_v):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.inexact):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), name)
    for g, w in zip(got_g, want_g):
        scale = max(np.abs(w).max(), 1e-3)
        assert np.abs(g - w).max() / scale < max(tol, 1e-5) * 10, name


@pytest.mark.parametrize("draw", ["alpha_dropout", "AlphaDropout",
                                  "gumbel_softmax", "gumbel_hard",
                                  "fused_dropout_add", "dirichlet",
                                  "exponential_", "truncated_gaussian_random",
                                  "rrelu", "uniform_inplace"])
def test_random_functions_by_moments_range_and_seed(draw):
    n = 20000
    ones = np.ones((n,), np.float32)
    fns = {
        "alpha_dropout": lambda: PF.alpha_dropout(P.to_tensor(ones), p=0.2),
        "AlphaDropout": lambda: P.nn.AlphaDropout(0.2)(P.to_tensor(ones)),
        "gumbel_softmax": lambda: PF.gumbel_softmax(
            P.to_tensor(np.zeros((n, 4), np.float32)))[:, 0],
        "gumbel_hard": lambda: PF.gumbel_softmax(
            P.to_tensor(np.zeros((n, 4), np.float32)), hard=True)[:, 0],
        "fused_dropout_add": lambda: PIF.fused_dropout_add(
            P.to_tensor(ones), P.to_tensor(ones), p=0.25),
        "dirichlet": lambda: P.dirichlet(P.to_tensor(
            np.full((n, 2), 2.0, np.float32)))[:, 0],
        "exponential_": lambda: P.exponential_(P.to_tensor(ones), lam=2.0),
        "truncated_gaussian_random": lambda:
            P.truncated_gaussian_random([n]),
        "rrelu": lambda: P.rrelu(P.to_tensor(-ones)),
        "uniform_inplace": lambda: P.uniform_inplace(P.to_tensor(ones)),
    }
    P.seed(11)
    a = fns[draw]().numpy()
    P.seed(11)
    np.testing.assert_array_equal(a, fns[draw]().numpy())
    lo, hi, mean, std = {
        # SELU-preserving: the moments of the input (1, 0) map to a
        # kept 1 or the dropped value, mean a*(1-p) + a*alpha_p*p + b
        "alpha_dropout": (-2.0, 2.0, None, None),
        "AlphaDropout": (-2.0, 2.0, None, None),
        "gumbel_softmax": (0.0, 1.0, 0.25, None),
        "gumbel_hard": (0.0, 1.0, 0.25, np.sqrt(0.1875)),
        "fused_dropout_add": (1.0, 1.0 + 4 / 3, 2.0, np.sqrt(1 / 3)),
        "dirichlet": (0.0, 1.0, 0.5, np.sqrt(0.25 / 5)),
        "exponential_": (0.0, np.inf, 0.5, 0.5),
        "truncated_gaussian_random": (-2.0, 2.0, 0.0, 0.8796),
        "rrelu": (-1 / 3, -1 / 8, -(1 / 8 + 1 / 3) / 2,
                  (1 / 3 - 1 / 8) / np.sqrt(12)),
        "uniform_inplace": (-1.0, 1.0, 0.0, 2 / np.sqrt(12)),
    }[draw]
    assert a.shape[0] == n
    assert a.min() >= lo - 1e-6 and a.max() <= hi + 1e-6, (a.min(), a.max())
    if draw in ("alpha_dropout", "AlphaDropout"):
        alpha_p = -1.6732632423543772 * 1.0507009873554805
        k = 1.0 / np.sqrt(0.8 * (1 + 0.2 * alpha_p ** 2))
        vals = np.unique(np.round(a, 5))
        np.testing.assert_allclose(
            sorted(vals), sorted(np.round([k * 1 - k * alpha_p * 0.2,
                                           k * alpha_p - k * alpha_p * 0.2],
                                          5)), rtol=1e-4)
        assert abs((a > 0).mean() - 0.8) < 0.02
        return
    tol = 4.0 / np.sqrt(n)
    assert abs(a.mean() - mean) < tol * max(std or 1.0, 0.3) * 2, a.mean()
    if std is not None:
        assert abs(a.std() - std) < 0.05 * std, (a.std(), std)


def test_alpha_dropout_eval_and_p0_are_identity():
    x = P.to_tensor(_u(3, 4))
    np.testing.assert_array_equal(PF.alpha_dropout(x, 0.5, training=False)
                                  .numpy(), x.numpy())
    layer = P.nn.AlphaDropout(0.5)
    layer.eval()
    np.testing.assert_array_equal(layer(x).numpy(), x.numpy())


def test_collectives_raise_until_distributed_is_ported():
    """The seven collective names resolve lazily against
    ``distributed.communication`` (ported with ROADMAP A23b-6a): in a
    job of one process each is the JAX module's identity, and the two
    ``p_recv`` names raise as ``recv`` does there (no peer)."""
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.ops.registry import OPS
    x = np.arange(4, dtype=np.float32)
    for name in ("all_reduce", "broadcast", "reduce"):
        t = P.to_tensor(x)
        assert OPS[name].user_fn(t) is t
        np.testing.assert_array_equal(t.numpy(), x)
    np.testing.assert_array_equal(
        OPS["all_gather"].user_fn(None, P.to_tensor(x)).numpy(), x)
    np.testing.assert_array_equal(
        OPS["reduce_scatter"].user_fn(None, P.to_tensor(x)).numpy(), x)
    for name in ("p_recv", "p_recv_array"):
        assert OPS[name].user_fn.__name__ == "recv"
        with pytest.raises(RuntimeError, match="needs a peer"):
            OPS[name].user_fn(P.to_tensor(x))
    assert OPS["all_reduce"].user_fn.__name__ == comm.all_reduce.__name__


def test_decode_jpeg_mirrors_the_jax_host_op():
    """``decode_jpeg`` needs Pillow, as the JAX op does: without it both
    raise NotImplementedError; with it both decode the same bytes."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        with pytest.raises(NotImplementedError):
            P.decode_jpeg(P.to_tensor(np.zeros(4, np.uint8)))
        return
    import io as _io

    from PIL import Image
    buf = _io.BytesIO()
    Image.fromarray((R.rand(6, 5, 3) * 255).astype(np.uint8)).save(
        buf, format="JPEG")
    raw = np.frombuffer(buf.getvalue(), np.uint8)
    np.testing.assert_array_equal(P.decode_jpeg(P.to_tensor(raw)).numpy(),
                                  J.decode_jpeg(J.to_tensor(raw)).numpy())
