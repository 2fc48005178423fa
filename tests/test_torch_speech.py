"""The port's speech path against the JAX package's: ``audio.functional``
and ``audio.features`` at 1e-5, then ``conformer_tiny`` and
``deepspeech2_tiny`` on one set of weights (the port's, loaded into the
JAX model by name, ``torch_ref_helpers``): logits, CTC loss and every
parameter's gradient at 1e-4, and the losses of three AdamW steps
(``epsilon=1e-3``, see ``test_torch_vision.py``) — the port's eager
steps against the JAX ``TrainStep`` — at 1e-4.  A Conformer at head_dim
36 (the default Conformer's: d_model 144 over 4 heads) runs its
attention on the plain route on the CPU, held to the JAX one.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.audio.features as JAF
import paddle_tpu.audio.functional as JA
import paddle_tpu.models.conformer as JC
import paddle_tpu.models.deepspeech as JD
from paddle_tpu.ops.dispatch import enable_dispatch_cache

import paddle_tpu_torch as P
import paddle_tpu_torch.audio.features as PAF
import paddle_tpu_torch.audio.functional as PA
import paddle_tpu_torch.models.conformer as PC
import paddle_tpu_torch.models.deepspeech as PD

from torch_ref_helpers import jax_forward, jax_twin, jax_value_and_grad

TOL5 = dict(rtol=1e-5, atol=1e-5)
TOL4 = dict(rtol=1e-4, atol=1e-4)
ADAMW = dict(learning_rate=1e-3, epsilon=1e-3)
WAVE = np.random.RandomState(3).uniform(-1, 1, (2, 4000)).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port on the CPU, torch on one thread (idle intra-op threads
    spinning beside the other test processes slow the JAX compiles), the
    JAX package without its dispatch cache's per-op compiles."""
    P.set_device("cpu")
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    enable_dispatch_cache(False)
    yield
    enable_dispatch_cache(True)
    torch.set_num_threads(saved)


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


# ------------------------------------------------------------- functional --
def test_mel_scale_and_filterbank_match_reference():
    freqs = np.array([0.0, 100.0, 440.0, 999.0, 1000.0, 4000.0, 7999.0],
                     np.float32)
    for htk in (False, True):
        np.testing.assert_allclose(_np(PA.hz_to_mel(freqs, htk=htk)),
                                   _np(JA.hz_to_mel(freqs, htk=htk)), **TOL5)
        mels = _np(JA.hz_to_mel(freqs, htk=htk))
        np.testing.assert_allclose(_np(PA.mel_to_hz(mels, htk=htk)),
                                   _np(JA.mel_to_hz(mels, htk=htk)),
                                   rtol=1e-5, atol=1e-3)
        assert PA.hz_to_mel(440.0, htk) == pytest.approx(
            JA.hz_to_mel(440.0, htk), rel=1e-6)
    kw = dict(sr=16000, n_fft=512, n_mels=80)
    np.testing.assert_allclose(_np(PA.compute_fbank_matrix(**kw)),
                               _np(JA.compute_fbank_matrix(**kw)), **TOL5)
    np.testing.assert_allclose(_np(PA.create_dct(13, 40)),
                               _np(JA.create_dct(13, 40)), **TOL5)
    for win, periodic in (("hann", True), ("blackman", False)):
        np.testing.assert_allclose(_np(PA.get_window(win, 400, periodic)),
                                   _np(JA.get_window(win, 400, periodic)),
                                   **TOL5)
    spec = np.abs(WAVE) ** 2 + 1e-12
    for top_db in (80.0, None):
        np.testing.assert_allclose(
            _np(PA.power_to_db(P.to_tensor(spec), top_db=top_db)),
            _np(JA.power_to_db(J.to_tensor(spec), top_db=top_db)), **TOL5)


FEATURES = [
    ("Spectrogram", dict(n_fft=512, win_length=400, hop_length=160)),
    ("MelSpectrogram", dict(sr=16000, n_fft=512, win_length=400,
                            hop_length=160, n_mels=80)),
    # the speech path's front end: 80 channels, 25 ms / 10 ms
    ("LogMelSpectrogram", dict(sr=16000, n_fft=512, win_length=400,
                               hop_length=160, n_mels=80)),
    ("MFCC", dict(sr=8000, n_mfcc=13, n_fft=256, n_mels=32, f_min=0.0,
                  top_db=80.0)),
]


@pytest.mark.parametrize("name,kw", FEATURES, ids=[f[0] for f in FEATURES])
def test_features_match_reference(name, kw):
    got = getattr(PAF, name)(**kw)(P.to_tensor(WAVE)).numpy()
    layer = getattr(JAF, name)(**kw)        # the JAX layer, jitted
    want = np.asarray(jax.jit(lambda w: layer(J.Tensor(w))._data)(WAVE))
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


# ----------------------------------------------------------------- models --
def _conformer(p, **kw):
    return (JC if p is J else PC).conformer_tiny(**kw)


def _deepspeech(p, **kw):
    return (JD if p is J else PD).deepspeech2_tiny(**kw)


FEATS = {"conformer": np.random.RandomState(0).rand(2, 32, 32)
         .astype(np.float32),
         "deepspeech": np.random.RandomState(1).randn(2, 32, 16)
         .astype(np.float32)}
LABELS = {"conformer": np.array([[1, 2, 3], [4, 5, 6]], np.int32),
          "deepspeech": np.array([[1, 5, 2, 7, 3], [4, 4, 9, 1, 0]],
                                 np.int32)}
LAB_LEN = {"conformer": None, "deepspeech": np.array([5, 4], np.int32)}
MODELS = {"conformer": _conformer, "deepspeech": _deepspeech}


def _port_model(which, **kw):
    P.seed(0)
    return MODELS[which](P, **kw)


def _loss(p, model, which):
    """The model's CTC loss on its batch, in package ``p``."""
    def loss(logits, labels, lengths=None):
        if isinstance(logits, tuple):
            logits = logits[0]
        logits = logits if isinstance(logits, p.Tensor) else p.Tensor(logits)
        labels = labels if isinstance(labels, p.Tensor) else p.Tensor(labels)
        if lengths is not None and not isinstance(lengths, p.Tensor):
            lengths = p.Tensor(lengths)
        return model.loss(logits, labels, label_lengths=lengths)
    return loss


@pytest.mark.parametrize("which", ["conformer", "deepspeech"])
def test_forward_loss_and_grads_match_reference(which):
    pm = _port_model(which)
    jm = jax_twin(lambda: MODELS[which](J), pm)
    feats, labels, lengths = FEATS[which], LABELS[which], LAB_LEN[which]
    pm.train()
    logits = pm(P.to_tensor(feats))
    loss = _loss(P, pm, which)(logits, P.to_tensor(labels),
                               None if lengths is None
                               else P.to_tensor(lengths))
    loss.backward()
    extra = (labels,) if lengths is None else (labels, lengths)
    want_logits, want_loss, grads, _ = jax_value_and_grad(
        jm, _loss(J, jm, which), [feats], extra)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL4)
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), want_loss, **TOL4)
    for name, prm in pm.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), grads[name], **TOL4,
                                   err_msg=name)


@pytest.mark.parametrize("which", ["conformer", "deepspeech"])
def test_three_adamw_steps_match_reference(which):
    # one Conformer block (as the JAX package's own overfit test takes
    # it): the gradients test above holds both
    kw = {"num_layers": 1} if which == "conformer" else {}
    pm = _port_model(which, **kw)
    jm = jax_twin(lambda: MODELS[which](J, **kw), pm)
    feats, labels, lengths = FEATS[which], LABELS[which], LAB_LEN[which]
    lab_args = (labels,) if lengths is None else (labels, lengths)
    opt = P.optimizer.AdamW(parameters=pm.parameters(), **ADAMW)
    got = []
    for _ in range(3):
        loss = _loss(P, pm, which)(pm(P.to_tensor(feats)),
                                   *(P.to_tensor(a) for a in lab_args))
        loss.backward()
        opt.step()
        opt.clear_grad()
        got.append(float(loss))
    step = J.jit.TrainStep(jm, _loss(J, jm, which), J.optimizer.AdamW(
        parameters=jm.parameters(), **ADAMW))
    want = [float(step(J.to_tensor(feats),
                       tuple(J.to_tensor(a) for a in lab_args)).numpy())
            for _ in range(3)]
    np.testing.assert_allclose(got, want, **TOL4)
    assert got[-1] < got[0]


def test_conformer_head_dim_36_plain_route_matches_reference():
    """d_model 72 over 2 heads: the default Conformer's head_dim of 36,
    which the flash kernels take on the card (C7); on the CPU the
    attention is the plain composition, held to the JAX one."""
    pm = _port_model("conformer", d_model=72, num_heads=2, num_layers=1)
    jm = jax_twin(lambda: _conformer(J, d_model=72, num_heads=2,
                                     num_layers=1), pm)
    attn = pm.blocks[0].mhsa.attn
    assert attn.head_dim == 36
    pm.eval()
    got = pm(P.to_tensor(FEATS["conformer"])).numpy()
    np.testing.assert_allclose(got, jax_forward(jm, FEATS["conformer"]),
                               **TOL4)


def test_carried_weights_load_both_ways():
    """The JAX model's state dict (numpy, by its keys) loads into a fresh
    port model bitwise, for both speech models."""
    for which in MODELS:
        pm = _port_model(which)
        jm = jax_twin(lambda: MODELS[which](J), pm)
        P.seed(5)
        fresh = MODELS[which](P)
        jsd = jm.state_dict()
        fresh.set_state_dict({k: np.asarray(v.numpy())
                              for k, v in jsd.items()})
        for k, v in fresh.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jsd[k]
                                                                .numpy()))
