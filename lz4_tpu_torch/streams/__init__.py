"""The stream pipeline: LZ4 frames in and out of binary streams, with the
blocks of each batch compressed and decoded on the card."""

from .pipeline import (
    BatchEngine, compress_stream, decompress_stream, get_engine,
)

__all__ = ["BatchEngine", "compress_stream", "decompress_stream", "get_engine"]
