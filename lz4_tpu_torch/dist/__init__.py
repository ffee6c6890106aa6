"""Data parallelism over independent blocks: ``lz4_tpu.dist`` over
``torch.distributed``, one rank a process and a device."""

from .mesh import block_mesh, device_count
from .multihost import (
    compress_blocks_multihost, initialize as initialize_multihost,
    process_block_range,
)
from .recovery import BlockVerificationError, compress_blocks_verified
from .sharded import (
    compress_frame_sharded, compress_frame_sharded_packed, pack_offsets,
    shard_compress_blocks, shard_decompress_blocks, shard_xxh32,
    sharded_roundtrip_step,
)

__all__ = [
    "block_mesh", "device_count",
    "shard_compress_blocks", "shard_decompress_blocks", "shard_xxh32",
    "sharded_roundtrip_step", "compress_frame_sharded",
    "compress_frame_sharded_packed", "pack_offsets",
    "compress_blocks_multihost", "initialize_multihost", "process_block_range",
    "BlockVerificationError", "compress_blocks_verified",
]
