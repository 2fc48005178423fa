"""paddle_tpu_torch.nn — layers, functional, initializers (port of
``paddle_tpu/nn``)."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer_base import Layer, ParamAttr, Parameter  # noqa: F401
from .common import (  # noqa: F401
    AlphaDropout,
    Bilinear,
    CosineSimilarity,
    Dropout,
    Dropout2D,
    Embedding,
    Flatten,
    Identity,
    Linear,
    Pad1D,
    Pad2D,
    PixelShuffle,
    Upsample,
)
from .container import (  # noqa: F401
    LayerDict,
    LayerList,
    ParameterList,
    Sequential,
)
from .conv import Conv1D, Conv2D, Conv2DTranspose, Conv3D  # noqa: F401
from .rnn import GRU, LSTM, SimpleRNN  # noqa: F401
from .pooling import (  # noqa: F401
    AdaptiveAvgPool1D,
    AdaptiveAvgPool2D,
    AdaptiveMaxPool2D,
    AvgPool1D,
    AvgPool2D,
    MaxPool1D,
    MaxPool2D,
)
from .norm import (  # noqa: F401
    BatchNorm,
    BatchNorm1D,
    BatchNorm2D,
    BatchNorm3D,
    GroupNorm,
    InstanceNorm1D,
    InstanceNorm2D,
    InstanceNorm3D,
    LayerNorm,
    LocalResponseNorm,
    RMSNorm,
    SpectralNorm,
    SyncBatchNorm,
)
from .activation import (  # noqa: F401
    CELU,
    ELU,
    GELU,
    Hardshrink,
    Hardsigmoid,
    Hardswish,
    Hardtanh,
    LeakyReLU,
    LogSigmoid,
    LogSoftmax,
    Maxout,
    Mish,
    PReLU,
    ReLU,
    ReLU6,
    SELU,
    Sigmoid,
    SiLU,
    Silu,
    Softmax,
    Softplus,
    Softshrink,
    Softsign,
    Swish,
    Tanh,
    Tanhshrink,
)
from .transformer import (  # noqa: F401
    MultiHeadAttention,
    Transformer,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)
from .loss import (  # noqa: F401
    BCELoss,
    BCEWithLogitsLoss,
    CrossEntropyLoss,
    KLDivLoss,
    L1Loss,
    MarginRankingLoss,
    MSELoss,
    NLLLoss,
    SmoothL1Loss,
)
