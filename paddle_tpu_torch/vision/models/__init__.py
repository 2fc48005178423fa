"""Vision model zoo (port of ``paddle_tpu/vision/models``; reference
python/paddle/vision/models/).  ResNet and ViT are verbatim copies of
the JAX modules; the rest of the zoo differs only where the JAX module
imports the top-level ``paddle_tpu``, which here is the port's own
package."""

from .resnet import (  # noqa: F401
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
from .vit import (  # noqa: F401
    VisionTransformer,
    vit_base_patch16_224,
    vit_large_patch16_224,
    vit_tiny,
)
from .densenet import (  # noqa: F401
    DenseNet,
    densenet121,
    densenet161,
    densenet169,
    densenet201,
    densenet264,
)
from .squeezenet import (  # noqa: F401
    SqueezeNet,
    squeezenet1_0,
    squeezenet1_1,
)
from .shufflenetv2 import (  # noqa: F401
    ShuffleNetV2,
    shufflenet_v2_x0_25,
    shufflenet_v2_x0_33,
    shufflenet_v2_x0_5,
    shufflenet_v2_x1_0,
    shufflenet_v2_x1_5,
    shufflenet_v2_x2_0,
)
from .inception import InceptionV3, inception_v3  # noqa: F401
