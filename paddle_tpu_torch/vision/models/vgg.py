"""VGG (reference python/paddle/vision/models/vgg.py)."""

from ... import nn

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _features(cfg, batch_norm):
    layers = []
    in_ch = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(kernel_size=2, stride=2))
        else:
            layers.append(nn.Conv2D(in_ch, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_ch = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes))
        self.num_classes = num_classes

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.reshape([x.shape[0], -1])
            x = self.classifier(x)
        return x


def _vgg(cfg, batch_norm=False, **kwargs):
    return VGG(_features(_CFGS[cfg], batch_norm), **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, **kwargs)
