from . import models  # noqa: F401
