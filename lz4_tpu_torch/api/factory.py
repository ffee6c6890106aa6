"""Factories of the ``cuda`` tier: caching, self-test and the fastest
instance.

Counterpart of ``lz4_tpu/api/factory.py:44-292``, which mirrors the
reference entry points (``LZ4Factory.java:91-220``,
``XXHashFactory.java:80-242``):

- factory instances are cached singletons, here keyed by
  ``(impl, device)``;
- HC compressors are built for every level 1..17 at construction
  (``LZ4Factory.java:189-202``);
- every construction runs the compress/decompress round-trip self-test
  (``LZ4Factory.java:204-220``) or the one-shot-against-streaming hash
  self-test (``XXHashFactory.java:184-203``); a factory that fails it is
  never returned.

The port has one tier, ``cuda`` (``api/cuda_instances.py``), loaded by
import rather than by the JAX package's module-name convention
(``lz4_tpu/api/factory.py:52``). ``fastest_instance`` returns it or raises:
there is no fallback to the CPU. ``device="cpu"`` runs the tier's card roles
through the kernels' plain versions, for tests.
"""

from __future__ import annotations

import random
import threading

import torch

from ..core.constants import DEFAULT_COMPRESSION_LEVEL, MAX_COMPRESSION_LEVEL
from ..core.device import resolve_device
from ..core.errors import Lz4Error
from . import cuda_instances
from .abstract import (
    Lz4Compressor, Lz4FastDecompressor, Lz4SafeDecompressor,
    StreamingXXHash32, StreamingXXHash64, XXHash32, XXHash64,
)

_SELF_TEST_DATA = (b"12345345234572" * 9)[:100]  # arbitrary, compressible


def _cached(cls, device):
    """The cached instance of factory class ``cls`` on ``device``, built
    (and self-tested) on first use."""
    dev = resolve_device(device)
    with cls._lock:
        key = (cls.impl, str(dev))
        inst = cls._instances.get(key)
        if inst is None:
            inst = cls(dev)
            cls._instances[key] = inst
        return inst


class Lz4Factory:
    """Entry point: compressors and decompressors of the ``cuda`` tier on
    one device."""

    impl = "cuda"
    _instances: dict[tuple[str, str], "Lz4Factory"] = {}
    _lock = threading.RLock()

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._fast_compressor: Lz4Compressor = \
            cuda_instances.FastCompressor(self.device)
        self._fast_decompressor: Lz4FastDecompressor = \
            cuda_instances.FastDecompressor(self.device)
        self._safe_decompressor: Lz4SafeDecompressor = \
            cuda_instances.SafeDecompressor(self.device)
        self._high_compressors: dict[int, Lz4Compressor] = {
            level: cuda_instances.HighCompressor(level, self.device)
            for level in range(1, MAX_COMPRESSION_LEVEL + 1)
        }
        self._self_test()

    # -- singleton accessors -------------------------------------------------

    @classmethod
    def cuda_instance(cls, device: str | torch.device = "cuda") -> "Lz4Factory":
        """The ``cuda`` tier on ``device``; raises when it names a card and
        none is present."""
        return _cached(cls, device)

    @classmethod
    def fastest_instance(cls, device: str | torch.device = "cuda") -> "Lz4Factory":
        """The port's only tier: :meth:`cuda_instance`, or its error."""
        return cls.cuda_instance(device)

    # -- instance accessors --------------------------------------------------

    def fast_compressor(self) -> Lz4Compressor:
        return self._fast_compressor

    def high_compressor(self, level: int | None = None) -> Lz4Compressor:
        """HC compressor; the level defaults to 9 and is clamped to 1..17
        (``LZ4Factory.java:263-270``)."""
        if level is None:
            level = DEFAULT_COMPRESSION_LEVEL
        level = min(max(level, 1), MAX_COMPRESSION_LEVEL)
        return self._high_compressors[level]

    def fast_decompressor(self) -> Lz4FastDecompressor:
        return self._fast_decompressor

    def safe_decompressor(self) -> Lz4SafeDecompressor:
        return self._safe_decompressor

    # deprecated aliases kept for API parity with the reference
    # (LZ4Factory.java:299-311)
    def decompressor(self) -> Lz4FastDecompressor:
        """Deprecated: use :meth:`fast_decompressor`."""
        return self._fast_decompressor

    def unknown_size_decompressor(self) -> Lz4SafeDecompressor:
        """Deprecated: use :meth:`safe_decompressor`."""
        return self._safe_decompressor

    # -- self-test (LZ4Factory.java:204-220) ---------------------------------

    def _self_test(self) -> None:
        data = _SELF_TEST_DATA
        for compressor in (self._fast_compressor, self._high_compressors[9]):
            compressed = bytearray(compressor.max_compressed_length(len(data)))
            compressed_len = compressor.compress(
                data, 0, len(data), compressed, 0, len(compressed))
            restored = bytearray(len(data))
            n_read = self._fast_decompressor.decompress(
                compressed, 0, restored, 0, len(data))
            if n_read != compressed_len or bytes(restored) != data:
                raise Lz4Error(f"{self.impl} instance is broken (fast decompressor)")
            restored = bytearray(len(data))
            n_written = self._safe_decompressor.decompress(
                compressed, 0, compressed_len, restored, 0, len(data))
            if n_written != len(data) or bytes(restored) != data:
                raise Lz4Error(f"{self.impl} instance is broken (safe decompressor)")

    def __repr__(self):
        return f"Lz4Factory(impl={self.impl!r}, device={str(self.device)!r})"


class XXHashFactory:
    """Entry point for the ``cuda`` tier's xxHash32/64, one-shot and
    streaming."""

    impl = "cuda"
    _instances: dict[tuple[str, str], "XXHashFactory"] = {}
    _lock = threading.RLock()

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._hash32: XXHash32 = cuda_instances.XXH32(self.device)
        self._hash64: XXHash64 = cuda_instances.XXH64(self.device)
        self._streaming32_cls = cuda_instances.StreamingXXH32
        self._streaming64_cls = cuda_instances.StreamingXXH64
        self._self_test()

    @classmethod
    def cuda_instance(cls, device: str | torch.device = "cuda") -> "XXHashFactory":
        return _cached(cls, device)

    @classmethod
    def fastest_instance(cls, device: str | torch.device = "cuda") -> "XXHashFactory":
        return cls.cuda_instance(device)

    def hash32(self) -> XXHash32:
        return self._hash32

    def hash64(self) -> XXHash64:
        return self._hash64

    def new_streaming_hash32(self, seed: int = 0) -> StreamingXXHash32:
        return self._streaming32_cls(seed, self.device)

    def new_streaming_hash64(self, seed: int = 0) -> StreamingXXHash64:
        return self._streaming64_cls(seed, self.device)

    # one-shot against streaming (XXHashFactory.java:184-203)
    def _self_test(self) -> None:
        rng = random.Random(0xCAFEBABE)
        data = bytes(rng.randrange(256) for _ in range(100))
        seed = rng.randrange(-1 << 31, 1 << 31)
        h1 = self._hash32.hash(data, 0, len(data), seed)
        s32 = self.new_streaming_hash32(seed)
        s32.update(data, 0, len(data))
        if h1 != s32.get_value():
            raise Lz4Error(f"{self.impl} xxhash32 instance is broken")
        h2 = self._hash64.hash(data, 0, len(data), seed)
        s64 = self.new_streaming_hash64(seed)
        s64.update(data, 0, len(data))
        if h2 != s64.get_value():
            raise Lz4Error(f"{self.impl} xxhash64 instance is broken")

    def __repr__(self):
        return f"XXHashFactory(impl={self.impl!r}, device={str(self.device)!r})"
