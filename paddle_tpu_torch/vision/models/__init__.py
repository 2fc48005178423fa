"""Vision model zoo (port of ``paddle_tpu/vision/models``; reference
python/paddle/vision/models/).  ResNet and ViT are ported; VGG,
MobileNetV2, DenseNet, SqueezeNet, ShuffleNetV2 and Inception wait for
A23b."""

from .resnet import (  # noqa: F401
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from .vit import (  # noqa: F401
    VisionTransformer,
    vit_base_patch16_224,
    vit_large_patch16_224,
    vit_tiny,
)
