from .device import resolve_device

__all__ = ["resolve_device"]
