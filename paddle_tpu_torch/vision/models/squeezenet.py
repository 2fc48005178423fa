"""SqueezeNet (reference python/paddle/vision/models/squeezenet.py;
Iandola et al. 2016).  Fire modules: squeeze 1x1 then parallel
expand 1x1/3x3 concatenated."""

from ... import nn


class _Fire(nn.Layer):
    def __init__(self, in_ch, squeeze, expand1x1, expand3x3):
        super().__init__()
        self.squeeze = nn.Conv2D(in_ch, squeeze, 1)
        self.relu = nn.ReLU()
        self.expand1x1 = nn.Conv2D(squeeze, expand1x1, 1)
        self.expand3x3 = nn.Conv2D(squeeze, expand3x3, 3, padding=1)

    def forward(self, x):
        import paddle_tpu_torch as paddle

        x = self.relu(self.squeeze(x))
        return paddle.concat([self.relu(self.expand1x1(x)),
                              self.relu(self.expand3x3(x))], axis=1)


class SqueezeNet(nn.Layer):
    def __init__(self, version="1.1", num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128),
                nn.MaxPool2D(3, stride=2),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, stride=2),
                _Fire(512, 64, 256, 256))
        elif version == "1.1":
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, stride=2),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, stride=2),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
        else:
            raise ValueError(f"unknown SqueezeNet version {version!r}")
        self.classifier = nn.Sequential(
            nn.Dropout(0.5),
            nn.Conv2D(512, num_classes, 1),
            nn.ReLU(),
            nn.AdaptiveAvgPool2D(1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
            x = x.reshape([x.shape[0], -1])
        elif self.with_pool:
            x = nn.AdaptiveAvgPool2D(1)(x)
        return x


def squeezenet1_0(**kwargs):
    return SqueezeNet(version="1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return SqueezeNet(version="1.1", **kwargs)
