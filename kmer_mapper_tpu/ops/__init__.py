"""Device ops. ``probe`` is imported lazily by its users
(they depend on ``index.layout``, which itself uses ``ops.u32hash`` — eager
imports here would cycle)."""
from . import encode, hashing, u32hash

__all__ = ["encode", "hashing", "u32hash", "probe"]


def __getattr__(name):
    if name == "probe":
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
