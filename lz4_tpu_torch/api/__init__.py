"""The ``cuda`` tier behind ``Lz4Factory`` and ``XXHashFactory``."""

from .factory import Lz4Factory, XXHashFactory

__all__ = ["Lz4Factory", "XXHashFactory"]
