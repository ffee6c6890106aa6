"""Buffer helpers shared by the host data plane (``lz4_tpu/utils/
buffers.py``)."""

from __future__ import annotations


def as_bytes(buf) -> bytes:
    """Any bytes-like object as bytes (no copy when it already is)."""
    if isinstance(buf, bytes):
        return buf
    if isinstance(buf, (bytearray, memoryview)):
        return bytes(buf)
    raise TypeError(f"expected bytes-like, got {type(buf).__name__}")


def chunk_bytes(data: bytes, chunk_size: int) -> list[bytes]:
    """Pieces of ``chunk_size`` bytes, the last possibly short; ``[]`` for
    empty input."""
    if chunk_size <= 0:
        raise ValueError("chunk_size must be positive")
    return [data[i:i + chunk_size] for i in range(0, len(data), chunk_size)]


def read_into(src, buf) -> int:
    """Fill ``buf`` (a writable bytes-like, e.g. a numpy view of a pinned
    staging buffer) from the binary stream ``src``; fewer bytes only at
    the end of ``src``. Uses ``src.readinto`` where ``src`` has it, so the
    bytes are copied once; otherwise ``read`` and one copy. Returns the
    bytes read."""
    mv = memoryview(buf).cast("B")
    want = len(mv)
    got = 0
    readinto = getattr(src, "readinto", None)
    while got < want:
        if readinto is not None:
            n = readinto(mv[got:])
        else:
            data = src.read(want - got)
            n = len(data) if data else 0
            mv[got:got + n] = data or b""
        if not n:
            break
        got += n
    return got
