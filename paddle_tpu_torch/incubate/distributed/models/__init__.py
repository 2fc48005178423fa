from . import moe  # noqa: F401
