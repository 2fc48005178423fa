from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .grad_clip import ClipGradForMOEByGlobalNorm  # noqa: F401
from .moe_layer import MoELayer, global_gather, global_scatter  # noqa: F401
