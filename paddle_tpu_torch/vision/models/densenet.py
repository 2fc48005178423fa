"""DenseNet (reference python/paddle/vision/models/densenet.py;
Huang et al. 2017).  Dense blocks concatenate every preceding feature
map — on TPU the concats fuse into the following conv's input gather,
so the architecture maps cleanly onto the MXU."""

from ... import nn


class _DenseLayer(nn.Layer):
    def __init__(self, num_input_features, growth_rate, bn_size,
                 dropout):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(num_input_features)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(num_input_features, bn_size * growth_rate,
                               1, bias_attr=False)
        self.norm2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        import paddle_tpu_torch as paddle

        return paddle.concat([x, out], axis=1)


class _DenseBlock(nn.Layer):
    def __init__(self, num_layers, num_input_features, bn_size,
                 growth_rate, dropout):
        super().__init__()
        self.layers = nn.LayerList([
            _DenseLayer(num_input_features + i * growth_rate,
                        growth_rate, bn_size, dropout)
            for i in range(num_layers)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class _Transition(nn.Sequential):
    def __init__(self, num_input_features, num_output_features):
        super().__init__(
            nn.BatchNorm2D(num_input_features),
            nn.ReLU(),
            nn.Conv2D(num_input_features, num_output_features, 1,
                      bias_attr=False),
            nn.AvgPool2D(2, stride=2))


_CONFIGS = {
    121: (6, 12, 24, 16),
    161: (6, 12, 36, 24),
    169: (6, 12, 32, 32),
    201: (6, 12, 48, 32),
    264: (6, 12, 64, 48),
}


class DenseNet(nn.Layer):
    def __init__(self, layers=121, growth_rate=None, bn_size=4,
                 dropout=0.0, num_classes=1000, with_pool=True):
        super().__init__()
        block_cfg = _CONFIGS[layers]
        if growth_rate is None:   # 161 is the wide variant (k=48)
            growth_rate = 48 if layers == 161 else 32
        num_init = 2 * growth_rate
        self.features = [nn.Sequential(
            nn.Conv2D(3, num_init, 7, stride=2, padding=3,
                      bias_attr=False),
            nn.BatchNorm2D(num_init),
            nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1))]
        self.add_sublayer("stem", self.features[0])
        ch = num_init
        for i, n in enumerate(block_cfg):
            block = _DenseBlock(n, ch, bn_size, growth_rate, dropout)
            self.add_sublayer(f"block{i}", block)
            self.features.append(block)
            ch += n * growth_rate
            if i != len(block_cfg) - 1:
                tr = _Transition(ch, ch // 2)
                self.add_sublayer(f"transition{i}", tr)
                self.features.append(tr)
                ch //= 2
        tail = nn.Sequential(nn.BatchNorm2D(ch), nn.ReLU())
        self.add_sublayer("tail", tail)
        self.features.append(tail)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        for f in self.features:
            x = f(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.reshape([x.shape[0], -1])
            x = self.classifier(x)
        return x


def densenet121(**kwargs):
    return DenseNet(layers=121, **kwargs)


def densenet161(**kwargs):
    return DenseNet(layers=161, **kwargs)


def densenet169(**kwargs):
    return DenseNet(layers=169, **kwargs)


def densenet201(**kwargs):
    return DenseNet(layers=201, **kwargs)


def densenet264(**kwargs):
    return DenseNet(layers=264, **kwargs)
