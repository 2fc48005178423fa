from .callbacks import (  # noqa: F401
    Callback,
    EarlyStopping,
    LRScheduler,
    ModelCheckpoint,
    ProgBarLogger,
    ReduceLROnPlateau,
    ThroughputMonitor,
    VisualDL,
)
from .flops import flops  # noqa: F401
from .model import Model, summary  # noqa: F401
