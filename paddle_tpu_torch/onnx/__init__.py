"""paddle.onnx parity — native ONNX export (+ a numpy mini-runtime);
port of ``paddle_tpu/onnx/__init__.py``.

Reference: python/paddle/onnx/export.py (thin wrapper over the external
paddle2onnx).  Here export is native: see export.py.  The ONNX messages
are the port's own codec (``onnx_subset_pb2``); nothing here needs a
protobuf runtime.
"""

from . import onnx_subset_pb2  # noqa: F401
from . import runtime  # noqa: F401
from .export import export  # noqa: F401
