"""TensorArray (port of ``paddle_tpu/tensor_array.py``; reference
phi::TensorArray + paddle.tensor.array_*).

The reference's TensorArray is a runtime vector<DenseTensor> used by
static-graph control flow (while loops writing per-step outputs).  The
port runs eagerly, so it is the JAX package's thin list container with
the reference's function surface (create_array / array_write /
array_read / array_length).  An index may be a Python int or a
one-element Tensor or torch tensor, read on the host.
"""

import torch

from .core.tensor import Tensor

__all__ = ["TensorArray", "create_array", "array_write", "array_read",
           "array_length"]


class TensorArray(list):
    """list of Tensors with the reference's access semantics."""

    def write(self, index, value):
        index = _static_index(index)
        if index < len(self):
            self[index] = value
        else:
            while len(self) < index:
                self.append(None)
            self.append(value)
        return self

    def read(self, index):
        return self[_static_index(index)]


def _static_index(i):
    if isinstance(i, Tensor):
        i = i._data
    if isinstance(i, torch.Tensor):
        i = i.item()
    return int(i)


def create_array(dtype=None, initialized_list=None):
    arr = TensorArray()
    if initialized_list:
        arr.extend(initialized_list)
    return arr


def array_write(x, i, array=None):
    if array is None:
        array = TensorArray()
    array.write(i, x)
    return array


def array_read(array, i):
    return array.read(i)


def array_length(array):
    return len(array)
