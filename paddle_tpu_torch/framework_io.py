"""paddle.save / paddle.load parity (port of ``paddle_tpu/framework_io.py``).

The format is the JAX package's: the object pickled with every Tensor
replaced by ``("__tensor__", numpy array)``, so a state dict saved by
either package loads into the other.  Loaded Tensors land on the
current device (``framework.device.set_device``).  A bfloat16 payload
raises: numpy has no bfloat16 of its own (the JAX package pickles one
as an ``ml_dtypes`` dtype), and this port's checkpoints are f32.
"""

import os
import pickle

import numpy as np


def _bf16_error():
    return TypeError(
        "bfloat16 tensors have no portable numpy payload (the JAX package "
        "pickles them as ml_dtypes arrays); save and load float32")


def _to_serializable(obj):
    from .core.tensor import Tensor
    if isinstance(obj, Tensor):
        if str(obj.dtype) == "torch.bfloat16":
            raise _bf16_error()
        return ("__tensor__", obj.numpy())
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_serializable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _from_serializable(obj):
    from .core.tensor import Tensor
    if isinstance(obj, tuple) and len(obj) == 2 and obj[0] == "__tensor__":
        if np.asarray(obj[1]).dtype.name == "bfloat16":
            raise _bf16_error()
        return Tensor(obj[1])
    if isinstance(obj, dict):
        return {k: _from_serializable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_serializable(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_from_serializable(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_serializable(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, "rb") as f:
        try:
            payload = pickle.load(f)
        except ModuleNotFoundError as e:
            if e.name == "ml_dtypes":
                raise _bf16_error() from e
            raise
    return _from_serializable(payload)
