from .main import launch  # noqa: F401
