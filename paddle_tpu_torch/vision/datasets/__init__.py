"""paddle.vision.datasets parity — MNIST/FashionMNIST/Cifar/ImageFolder.

Reference: python/paddle/vision/datasets/{mnist,cifar,folder}.py.  Those
download from Baidu mirrors; this environment has no egress, so
``download=True`` raises with instructions and the parsers consume local
files in the standard formats (idx-ubyte for MNIST, the python-pickle
batch tarball for CIFAR, class-per-directory trees for ImageFolder).
"""

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ...io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "DatasetFolder",
           "ImageFolder", "Flowers", "VOC2012"]


def _no_download(name):
    raise RuntimeError(
        f"{name}: automatic download is unavailable in this environment "
        "(no network egress). Place the standard dataset files locally and "
        "pass their paths (image_path/label_path or data_file).")


def _read_idx(path):
    """Parse an idx-ubyte file (optionally .gz): the MNIST wire format."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


class MNIST(Dataset):
    """MNIST from local idx files (reference mnist.py API).

    >>> ds = MNIST(image_path="train-images-idx3-ubyte.gz",
    ...            label_path="train-labels-idx1-ubyte.gz")
    >>> img, label = ds[0]    # img: float32 [28, 28] in [0, 1]
    """

    NAME = "MNIST"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        if image_path is None or label_path is None:
            if download:
                _no_download(self.NAME)
            raise ValueError(
                f"{self.NAME} requires image_path and label_path "
                "(no download available)")
        self.mode = mode
        self.transform = transform
        self.images = _read_idx(image_path)
        self.labels = _read_idx(label_path)
        if len(self.images) != len(self.labels):
            raise ValueError("image/label count mismatch")

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(self.labels[idx])


class FashionMNIST(MNIST):
    NAME = "FashionMNIST"


class _CifarBase(Dataset):
    """CIFAR from the standard python-version tarball."""

    MODE_TRAIN_FILES = ()
    MODE_TEST_FILES = ()
    LABEL_KEY = b"labels"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if data_file is None:
            if download:
                _no_download(type(self).__name__)
            raise ValueError(f"{type(self).__name__} requires data_file "
                             "(no download available)")
        self.mode = mode
        self.transform = transform
        wanted = (self.MODE_TRAIN_FILES if mode == "train"
                  else self.MODE_TEST_FILES)
        data, labels = [], []
        with tarfile.open(data_file) as tf:
            for member in tf.getmembers():
                base = os.path.basename(member.name)
                if base in wanted:
                    d = pickle.load(tf.extractfile(member),
                                    encoding="bytes")
                    data.append(np.asarray(d[b"data"], np.uint8))
                    labels.extend(d[self.LABEL_KEY])
        if not data:
            raise ValueError(f"no {mode} batches found in {data_file}")
        self.data = np.concatenate(data).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(labels, np.int64)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        img = self.data[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]


class Cifar10(_CifarBase):
    MODE_TRAIN_FILES = tuple(f"data_batch_{i}" for i in range(1, 6))
    MODE_TEST_FILES = ("test_batch",)
    LABEL_KEY = b"labels"


class Cifar100(_CifarBase):
    MODE_TRAIN_FILES = ("train",)
    MODE_TEST_FILES = ("test",)
    LABEL_KEY = b"fine_labels"


_IMG_EXTS = (".png", ".npy", ".npz")


def _load_image(path):
    """Local image loader: .npy/.npz arrays always; .png via PIL when
    available (PIL ships with many images; gated, not required)."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        return np.load(path)["arr_0"]
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"loading {path} requires Pillow; use .npy files instead") from e
    return np.asarray(Image.open(path))


class DatasetFolder(Dataset):
    """class-per-subdirectory tree (reference folder.py semantics)."""

    def __init__(self, root, loader=None, extensions=_IMG_EXTS,
                 transform=None, is_valid_file=None):
        self.root = root
        self.loader = loader or _load_image
        self.transform = transform
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise ValueError(f"no class directories under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                p = os.path.join(cdir, fn)
                ok = (is_valid_file(p) if is_valid_file
                      else fn.lower().endswith(tuple(extensions)))
                if ok:
                    self.samples.append((p, self.class_to_idx[c]))
        if not self.samples:
            raise ValueError(f"no samples found under {root}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(target)


class ImageFolder(Dataset):
    """flat/unlabeled folder of images (reference folder.py ImageFolder)."""

    def __init__(self, root, loader=None, extensions=_IMG_EXTS,
                 transform=None, is_valid_file=None):
        self.loader = loader or _load_image
        self.transform = transform
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fn in sorted(files):
                p = os.path.join(dirpath, fn)
                ok = (is_valid_file(p) if is_valid_file
                      else fn.lower().endswith(tuple(extensions)))
                if ok:
                    self.samples.append(p)
        if not self.samples:
            raise ValueError(f"no images found under {root}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]



class _PerPidTar:
    """One TarFile handle per process: a fork-inherited handle shares its
    file offset across DataLoader workers (corrupted concurrent reads)."""

    def __init__(self, path):
        self.path = path
        self._tars = {}

    def get(self):
        pid = os.getpid()
        t = self._tars.get(pid)
        if t is None:
            t = tarfile.open(self.path)
            self._tars[pid] = t
        return t


def _decode_member_bytes(name, raw):
    """Decode one archive member: .npy natively, images via Pillow."""
    import io as _io

    if name.endswith(".npy"):
        return np.load(_io.BytesIO(raw))
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"decoding {name} requires Pillow; use .npy "
                           "archives instead") from e
    return np.asarray(Image.open(_io.BytesIO(raw)))


class Flowers(Dataset):
    """Flowers-102 from local files (reference flowers.py): images tarball
    + scipy-format .mat label/setid files.  scipy isn't guaranteed, so
    labels may also be a .npz with 'labels' and 'setids' arrays."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False, backend=None):
        if data_file is None:
            if download:
                _no_download("Flowers")
            raise ValueError("Flowers requires data_file (no download)")
        self.transform = transform
        self.mode = mode
        self._tarsrc = _PerPidTar(data_file)
        labels, setids = self._load_labels(label_file, setid_file, mode)
        members = {os.path.basename(m.name): m.name
                   for m in self._tarsrc.get().getmembers()
                   if m.name.endswith(".jpg") or m.name.endswith(".npy")}
        self.samples = []
        for idx in setids:
            for ext in (".jpg", ".npy"):
                name = f"image_{int(idx):05d}{ext}"
                if name in members:
                    self.samples.append((members[name],
                                         int(labels[int(idx) - 1]) - 1))
                    break

    @staticmethod
    def _load_labels(label_file, setid_file, mode):
        key = {"train": "trnid", "valid": "valid", "test": "tstid"}[mode]
        if label_file and label_file.endswith(".npz"):
            d = np.load(label_file)
            return d["labels"].reshape(-1), d[key].reshape(-1)
        try:
            from scipy.io import loadmat
        except ImportError as e:
            raise RuntimeError(
                "Flowers .mat labels need scipy; convert to .npz with "
                "arrays 'labels' and 'trnid'/'valid'/'tstid'") from e
        labels = loadmat(label_file)["labels"].reshape(-1)
        setids = loadmat(setid_file)[key].reshape(-1)
        return labels, setids

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        member, label = self.samples[idx]
        raw = self._tarsrc.get().extractfile(member).read()
        img = _decode_member_bytes(member, raw)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(label)


class VOC2012(Dataset):
    """VOC2012 segmentation pairs from the standard devkit tarball
    (reference voc2012.py): JPEGImages/*.jpg + SegmentationClass/*.png
    listed by ImageSets/Segmentation/{train,val,trainval}.txt."""

    _LIST = {"train": "train.txt", "valid": "val.txt",
             "test": "val.txt", "trainval": "trainval.txt"}

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if data_file is None:
            if download:
                _no_download("VOC2012")
            raise ValueError("VOC2012 requires data_file (no download)")
        self.transform = transform
        self._tarsrc = _PerPidTar(data_file)
        # one pass over the members: index by dir/basename suffix
        by_suffix = {}
        for m in self._tarsrc.get().getmembers():
            parts = m.name.rsplit("/", 2)
            by_suffix["/".join(parts[-2:])] = m.name
        list_name = self._LIST[mode]
        list_member = by_suffix.get(f"Segmentation/{list_name}")
        if list_member is None:
            raise ValueError(f"no {list_name} index in {data_file}")
        ids = self._tarsrc.get().extractfile(list_member) \
            .read().decode().split()
        self.pairs = []
        for i in ids:
            img = (by_suffix.get(f"JPEGImages/{i}.jpg")
                   or by_suffix.get(f"JPEGImages/{i}.npy"))
            lab = (by_suffix.get(f"SegmentationClass/{i}.png")
                   or by_suffix.get(f"SegmentationClass/{i}.npy"))
            if img is not None and lab is not None:
                self.pairs.append((img, lab))

    def __len__(self):
        return len(self.pairs)

    def _decode(self, member):
        raw = self._tarsrc.get().extractfile(member).read()
        return _decode_member_bytes(member, raw)

    def __getitem__(self, idx):
        img_m, lab_m = self.pairs[idx]
        img, label = self._decode(img_m), self._decode(lab_m)
        if self.transform is not None:
            img = self.transform(img)
        return img, label
