"""``text`` and ``vision.datasets`` on the port against the JAX package.

``text.viterbi_decode`` / ``ViterbiDecoder``: scores exactly and paths
equal to the JAX module's on seeded potentials, with and without the
BOS/EOS tags, lengths from 1 to T.  ``vision.datasets`` is the JAX
module verbatim (``test_torch_engine.py::
test_host_modules_are_verbatim_copies``); here the port's parsers read
the files this test writes — MNIST idx, a CIFAR-10 tarball, a
class-per-folder tree — into the same arrays as the JAX module's, and a
download raises.  The gated corpora of both raise alike.
"""

import gzip
import io
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.text as JT
import paddle_tpu.vision.datasets as JDS

import paddle_tpu_torch as P
import paddle_tpu_torch.text as PT
import paddle_tpu_torch.vision.datasets as PDS


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


@pytest.mark.parametrize("bos_eos", [False, True])
def test_viterbi_matches_reference(bos_eos):
    rng = np.random.RandomState(4)
    b, t, n = 5, 7, 6
    pot = rng.randn(b, t, n).astype(np.float32)
    trans = rng.randn(n, n).astype(np.float32)
    lens = np.array([7, 1, 4, 6, 2], np.int64)
    ps, pp = PT.viterbi_decode(P.to_tensor(pot), P.to_tensor(trans),
                               P.to_tensor(lens), include_bos_eos_tag=bos_eos)
    js, jp = JT.viterbi_decode(J.to_tensor(pot), J.to_tensor(trans),
                               J.to_tensor(lens), include_bos_eos_tag=bos_eos)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js.numpy()),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp.numpy()))
    assert pp.numpy().dtype == np.int64
    dec = PT.ViterbiDecoder(P.to_tensor(trans), include_bos_eos_tag=bos_eos)
    ds, dp = dec(P.to_tensor(pot), P.to_tensor(lens))
    np.testing.assert_array_equal(dp.numpy(), pp.numpy())
    np.testing.assert_array_equal(ds.numpy(), ps.numpy())


def test_gated_text_corpora_raise():
    for name in ("Imdb", "Conll05st", "Movielens", "UCIHousing", "WMT14",
                 "WMT16"):
        with pytest.raises(RuntimeError):
            getattr(PT, name)()
    assert set(JT.__all__) == set(PT.__all__)


def _write_idx(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 + arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


def test_dataset_parsers_read_what_the_reference_reads(tmp_path):
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 256, (6, 28, 28), dtype=np.uint8)
    labels = rng.randint(0, 10, (6,), dtype=np.uint8)
    ip, lp = str(tmp_path / "i.gz"), str(tmp_path / "l.gz")
    _write_idx(ip, imgs)
    _write_idx(lp, labels)
    tar = str(tmp_path / "cifar-10-python.tar.gz")
    with tarfile.open(tar, "w:gz") as tf:
        for name, n in (("data_batch_1", 5), ("test_batch", 3)):
            blob = pickle.dumps({b"data": rng.randint(0, 256, (n, 3072),
                                                      dtype=np.uint8),
                                 b"labels": list(rng.randint(0, 10, n))})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    root = tmp_path / "tree"
    for cls in ("a", "b"):
        os.makedirs(root / cls)
        for i in range(2):
            np.save(root / cls / f"{i}.npy", np.full((3, 3), i, np.float32))
    for make in (lambda m: m.MNIST(image_path=ip, label_path=lp),
                 lambda m: m.Cifar10(data_file=tar, mode="train"),
                 lambda m: m.Cifar10(data_file=tar, mode="test"),
                 lambda m: m.DatasetFolder(str(root))):
        got, want = make(PDS), make(JDS)
        assert len(got) == len(want)
        for i in range(len(got)):
            for g, w in zip(got[i], want[i]):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises((RuntimeError, ValueError)):
        PDS.MNIST(download=True)
