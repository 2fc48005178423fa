"""paddle_tpu_torch.vision (port of ``paddle_tpu/vision``; reference
python/paddle/vision/).

The ResNet and ViT models and the numpy transforms.  ``datasets``
reads files that are not in the repo and waits for A23b.
"""

from . import models  # noqa: F401
from . import transforms  # noqa: F401
