"""Container formats on the card: LZ4 Frame v1.5.1 (with linked-block and
dictionary frames), the LZ4Block stream, and the length-prefixed codec;
the 14 names of ``lz4_tpu.formats``."""

from .block_stream import (
    Lz4BlockInputStream, Lz4BlockOutputStream, compress_block_stream,
    decompress_block_stream,
)
from .frame import (
    BlockSize, FrameFlag, Lz4FrameInputStream, Lz4FrameOutputStream,
    compress_frame, decompress_frame, make_skippable_frame,
)
from .with_length import (
    Lz4CompressorWithLength, Lz4DecompressorWithLength, get_decompressed_length,
)

__all__ = [
    "BlockSize", "FrameFlag", "Lz4FrameInputStream", "Lz4FrameOutputStream",
    "compress_frame", "decompress_frame", "make_skippable_frame",
    "Lz4BlockInputStream", "Lz4BlockOutputStream",
    "compress_block_stream", "decompress_block_stream",
    "Lz4CompressorWithLength", "Lz4DecompressorWithLength",
    "get_decompressed_length",
]
