"""Abstract codec API: the factory-dispatched operation contracts.

Mirrors the reference's public abstract types and their exact operation
semantics (``LZ4Compressor.java``, ``LZ4FastDecompressor.java:37-48``,
``LZ4SafeDecompressor.java:32-45``, ``XXHash32.java``, ``XXHash64.java``,
``StreamingXXHash32/64.java``):

- a *compressor* writes into ``dest`` and returns the compressed length;
- a *fast decompressor* requires the exact decompressed size and returns the
  number of bytes **read** from ``src``;
- a *safe decompressor* requires the exact compressed size and returns the
  number of bytes **written** to ``dest``.

All implementations are stateless and thread-safe; streaming hashes are the
only stateful objects.

The port's own copy of ``lz4_tpu/api/abstract.py``.
"""

from __future__ import annotations

import abc

from ..core.constants import max_compressed_length
from ..core.errors import Lz4Error


class Lz4Compressor(abc.ABC):
    """Abstract LZ4 block compressor (thread-safe, stateless)."""

    @abc.abstractmethod
    def compress(self, src, src_off: int, src_len: int, dest, dest_off: int,
                 max_dest_len: int) -> int:
        """Compress ``src[src_off:src_off+src_len]`` into ``dest``.

        Returns the compressed length; raises :class:`Lz4Error` if ``dest``
        is too small.
        """

    def max_compressed_length(self, length: int) -> int:
        return max_compressed_length(length)

    def compress_alloc(self, src, src_off: int = 0, src_len: int | None = None) -> bytes:
        """Convenience overload returning a right-sized ``bytes``.

        Equivalent to ``LZ4Compressor.compress(byte[])`` (LZ4Compressor.java:96-149).
        """
        if src_len is None:
            src_len = len(src) - src_off
        dest = bytearray(self.max_compressed_length(src_len))
        n = self.compress(src, src_off, src_len, dest, 0, len(dest))
        return bytes(dest[:n])

    def __repr__(self):
        return type(self).__name__


class Lz4FastDecompressor(abc.ABC):
    """Decompressor that needs the exact *decompressed* size.

    ``decompress`` returns the number of compressed bytes read
    (LZ4FastDecompressor.java:37-48).
    """

    @abc.abstractmethod
    def decompress(self, src, src_off: int, dest, dest_off: int, dest_len: int) -> int:
        ...

    def decompress_alloc(self, src, src_off: int, dest_len: int) -> bytes:
        dest = bytearray(dest_len)
        self.decompress(src, src_off, dest, 0, dest_len)
        return bytes(dest)

    def __repr__(self):
        return type(self).__name__


class Lz4SafeDecompressor(abc.ABC):
    """Decompressor that needs the exact *compressed* size.

    ``decompress`` returns the number of bytes written
    (LZ4SafeDecompressor.java:32-45).
    """

    @abc.abstractmethod
    def decompress(self, src, src_off: int, src_len: int, dest, dest_off: int,
                   max_dest_len: int) -> int:
        ...

    def decompress_alloc(self, src, src_off: int, src_len: int,
                         max_dest_len: int) -> bytes:
        dest = bytearray(max_dest_len)
        n = self.decompress(src, src_off, src_len, dest, 0, max_dest_len)
        return bytes(dest[:n])

    def __repr__(self):
        return type(self).__name__


class XXHash32(abc.ABC):
    """One-shot 32-bit hash. Returns a signed int32 like the Java API."""

    @abc.abstractmethod
    def hash(self, buf, off: int, length: int, seed: int) -> int:
        ...

    def __repr__(self):
        return type(self).__name__


class XXHash64(abc.ABC):
    """One-shot 64-bit hash. Returns a signed int64 like the Java API."""

    @abc.abstractmethod
    def hash(self, buf, off: int, length: int, seed: int) -> int:
        ...

    def __repr__(self):
        return type(self).__name__


class StreamingXXHash32(abc.ABC):
    """Incremental 32-bit hash; closeable for API parity with the native tier."""

    def __init__(self, seed: int):
        self.seed = seed

    @abc.abstractmethod
    def update(self, buf, off: int = 0, length: int | None = None) -> None:
        ...

    @abc.abstractmethod
    def get_value(self) -> int:
        """Current hash of all bytes seen; non-destructive."""

    @abc.abstractmethod
    def reset(self) -> None:
        ...

    def as_checksum_value(self) -> int:
        """Checksum-adapter view of the value.

        Reproduces the reference quirk of masking to 28 bits — seven F's, not
        eight (StreamingXXHash32.java:101-107).
        """
        return self.get_value() & 0xFFFFFFF

    def as_checksum(self) -> "ChecksumAdapter":
        """Checksum-object view (the reference's ``asChecksum()`` returning a
        ``java.util.zip.Checksum``, StreamingXXHash32.java:95-131), with the
        same 28-bit getValue quirk."""
        return ChecksumAdapter(self)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __repr__(self):
        return f"{type(self).__name__}(seed={self.seed})"


class StreamingXXHash64(abc.ABC):
    """Incremental 64-bit hash."""

    def __init__(self, seed: int):
        self.seed = seed

    @abc.abstractmethod
    def update(self, buf, off: int = 0, length: int | None = None) -> None:
        ...

    @abc.abstractmethod
    def get_value(self) -> int:
        ...

    @abc.abstractmethod
    def reset(self) -> None:
        ...

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __repr__(self):
        return f"{type(self).__name__}(seed={self.seed})"


class ChecksumAdapter:
    """``java.util.zip.Checksum``-shaped adapter over a streaming hash.

    ``get_value`` masks to 28 bits exactly like the reference adapter
    (StreamingXXHash32.java:101-107); ``update`` accepts a single int byte
    or a bytes-like slice, mirroring the two Checksum.update overloads.
    """

    def __init__(self, stream):
        self._stream = stream

    def update(self, data, off: int = 0, length: int | None = None) -> None:
        if isinstance(data, int):
            self._stream.update(bytes([data & 0xFF]))
            return
        self._stream.update(data, off, length)

    def get_value(self) -> int:
        return self._stream.get_value() & 0xFFFFFFF

    def reset(self) -> None:
        self._stream.reset()
