"""StringTensor + string kernels (reference phi StringTensor at
paddle/phi/core/string_tensor.h and the strings kernel family at
paddle/phi/kernels/strings/ — empty/copy/lower/upper over pstring arrays,
the substrate for the faster-tokenizer path).

TPU redesign: strings never reach the chip (XLA has no string type) — the
reference keeps them on host too.  StringTensor wraps a numpy object
array; kernels are vectorized host ops with the same names
(empty/lower/upper) plus the accessors tokenization pipelines need.
UTF-8 handling comes from Python's str (the reference carries its own
unicode tables, paddle/phi/kernels/strings/unicode.cc).
"""

import numpy as np

__all__ = ["StringTensor", "empty", "lower", "upper", "to_string_tensor"]


class StringTensor:
    """Host-resident tensor of variable-length UTF-8 strings."""

    def __init__(self, data, name=None):
        arr = np.asarray(data, dtype=object)
        self._data = arr
        self.name = name or "string_tensor"

    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def size(self):
        return int(self._data.size)

    def numpy(self):
        return self._data

    def tolist(self):
        return self._data.tolist()

    def __getitem__(self, idx):
        out = self._data[idx]
        return out if isinstance(out, str) else StringTensor(out)

    def __len__(self):
        return len(self._data)

    def __eq__(self, other):
        other_arr = other._data if isinstance(other, StringTensor) \
            else np.asarray(other, dtype=object)
        return self._data == other_arr

    def __repr__(self):
        return f"StringTensor(shape={self.shape}, {self._data!r})"

    # ------------------------------------------------- kernel-like methods --
    def lower(self):
        return _map(self, str.lower)

    def upper(self):
        return _map(self, str.upper)

    def str_len(self):
        """Per-element length in unicode code points -> int32 ndarray."""
        return np.vectorize(len, otypes=[np.int32])(self._data)

    def byte_len(self):
        return np.vectorize(lambda s: len(s.encode("utf-8")),
                            otypes=[np.int32])(self._data)


def _map(st, fn):
    return StringTensor(np.vectorize(fn, otypes=[object])(st._data))


def empty(shape, name=None):
    """strings_empty_kernel parity: StringTensor of empty strings."""
    arr = np.full(tuple(shape), "", dtype=object)
    return StringTensor(arr, name=name)


def lower(x, use_utf8_encoding=True, name=None):
    """strings_lower_upper_kernel parity."""
    return _map(x if isinstance(x, StringTensor) else StringTensor(x),
                str.lower)


def upper(x, use_utf8_encoding=True, name=None):
    return _map(x if isinstance(x, StringTensor) else StringTensor(x),
                str.upper)


def to_string_tensor(data, name=None):
    return StringTensor(data, name=name)
