"""paddle_tpu_torch.vision (port of ``paddle_tpu/vision``; reference
python/paddle/vision/).

The model zoo, the numpy transforms and the datasets (a verbatim copy of
the JAX module: host parsers of the standard files, downloads gated).
"""

from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import transforms  # noqa: F401
