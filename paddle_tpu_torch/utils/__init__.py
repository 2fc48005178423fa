"""paddle.utils parity: custom-op registration + C++ extension loading
(port of ``paddle_tpu/utils/__init__.py``).

Reference: python/paddle/utils/ (cpp_extension JIT build at
python/paddle/utils/cpp_extension/, runtime op registration at
paddle/fluid/framework/custom_operator.cc).
"""

from . import cpp_extension  # noqa: F401
from .custom_op import register_custom_op, register_pallas_op  # noqa: F401
