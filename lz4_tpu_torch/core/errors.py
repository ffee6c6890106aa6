"""Exception types for the framework.

``Lz4Error`` mirrors the reference's ``LZ4Exception`` (a RuntimeException raised
on malformed input or undersized destination buffers, ``LZ4Exception.java``).
The port's own copy of ``lz4_tpu/core/errors.py``.
"""


class Lz4Error(RuntimeError):
    """Raised on malformed compressed input or an undersized destination."""


class Lz4FrameError(Lz4Error):
    """Raised on malformed LZ4 Frame / LZ4Block container data."""
