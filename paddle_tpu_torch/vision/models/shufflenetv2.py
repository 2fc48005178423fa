"""ShuffleNetV2 (reference python/paddle/vision/models/shufflenetv2.py;
Ma et al. 2018).  Channel split + shuffle: the shuffle is a pure
reshape/transpose, which XLA folds into the surrounding layout — free
on TPU."""

from ... import nn


def _channel_shuffle(x, groups):
    b, c, h, w = x.shape
    x = x.reshape([b, groups, c // groups, h, w])
    x = x.transpose([0, 2, 1, 3, 4])
    return x.reshape([b, c, h, w])


def _act_layer(act):
    if act == "relu":
        return nn.ReLU()
    if act == "swish":
        return nn.Swish()
    raise ValueError(f"unsupported activation {act!r} (relu|swish)")


def _conv_bn(in_ch, out_ch, k, stride=1, groups=1, act="relu"):
    layers = [nn.Conv2D(in_ch, out_ch, k, stride=stride,
                        padding=(k - 1) // 2, groups=groups,
                        bias_attr=False),
              nn.BatchNorm2D(out_ch)]
    if act is not None:
        layers.append(_act_layer(act))
    return nn.Sequential(*layers)


class _InvertedResidual(nn.Layer):
    def __init__(self, in_ch, out_ch, stride, act="relu"):
        super().__init__()
        self.stride = stride
        branch_ch = out_ch // 2
        if stride == 1:
            self.branch2 = nn.Sequential(
                _conv_bn(branch_ch, branch_ch, 1, act=act),
                _conv_bn(branch_ch, branch_ch, 3, stride=1,
                         groups=branch_ch, act=None),
                _conv_bn(branch_ch, branch_ch, 1, act=act))
        else:
            self.branch1 = nn.Sequential(
                _conv_bn(in_ch, in_ch, 3, stride=stride, groups=in_ch,
                         act=None),
                _conv_bn(in_ch, branch_ch, 1, act=act))
            self.branch2 = nn.Sequential(
                _conv_bn(in_ch, branch_ch, 1, act=act),
                _conv_bn(branch_ch, branch_ch, 3, stride=stride,
                         groups=branch_ch, act=None),
                _conv_bn(branch_ch, branch_ch, 1, act=act))

    def forward(self, x):
        import paddle_tpu_torch as paddle

        if self.stride == 1:
            half = x.shape[1] // 2
            x1 = x[:, :half]
            x2 = x[:, half:]
            out = paddle.concat([x1, self.branch2(x2)], axis=1)
        else:
            out = paddle.concat([self.branch1(x), self.branch2(x)],
                                axis=1)
        return _channel_shuffle(out, 2)


_STAGE_OUT = {
    0.25: (24, 24, 48, 96, 512),
    0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        if scale not in _STAGE_OUT:
            raise ValueError(f"unsupported scale {scale}")
        stage_repeats = (4, 8, 4)
        out_ch = _STAGE_OUT[scale]
        self.conv1 = _conv_bn(3, out_ch[0], 3, stride=2, act=act)
        self.max_pool = nn.MaxPool2D(3, stride=2, padding=1)
        self.stages = nn.LayerList()
        in_ch = out_ch[0]
        for i, reps in enumerate(stage_repeats):
            oc = out_ch[i + 1]
            blocks = [_InvertedResidual(in_ch, oc, stride=2, act=act)]
            blocks += [_InvertedResidual(oc, oc, stride=1, act=act)
                       for _ in range(reps - 1)]
            self.stages.append(nn.Sequential(*blocks))
            in_ch = oc
        self.conv_last = _conv_bn(in_ch, out_ch[-1], 1, act=act)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(out_ch[-1], num_classes)

    def forward(self, x):
        x = self.max_pool(self.conv1(x))
        for stage in self.stages:
            x = stage(x)
        x = self.conv_last(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.reshape([x.shape[0], -1])
            x = self.fc(x)
        return x


def shufflenet_v2_x0_25(**kw):
    return ShuffleNetV2(scale=0.25, **kw)


def shufflenet_v2_x0_33(**kw):
    return ShuffleNetV2(scale=0.33, **kw)


def shufflenet_v2_x0_5(**kw):
    return ShuffleNetV2(scale=0.5, **kw)


def shufflenet_v2_x1_0(**kw):
    return ShuffleNetV2(scale=1.0, **kw)


def shufflenet_v2_x1_5(**kw):
    return ShuffleNetV2(scale=1.5, **kw)


def shufflenet_v2_x2_0(**kw):
    return ShuffleNetV2(scale=2.0, **kw)
