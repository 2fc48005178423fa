"""paddle_tpu_torch.nn — layers, functional, initializers (port of
``paddle_tpu/nn``).  The layers whose module waits (``conv``,
``pooling``, ``rnn`` and the norms other than LayerNorm) come with A23b;
``RMSNorm`` is the ``torch.nn.Module`` the port's Llama uses."""

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
from .norm import LayerNorm, RMSNorm  # noqa: F401
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
