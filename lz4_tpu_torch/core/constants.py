"""Format and tuning constants for the LZ4 block format and xxHash.

Kept numerically identical to the reference implementation so that compressed
output is bit-compatible (reference: ``src/java/net/jpountz/lz4/LZ4Constants.java:23-53``
and ``src/java/net/jpountz/xxhash/XXHashConstants.java:22-32``).

The port's own copy of ``lz4_tpu/core/constants.py``: ``lz4_tpu_torch``
imports nothing from the JAX package.
"""

# ---------------------------------------------------------------------------
# LZ4 block format constants
# ---------------------------------------------------------------------------

DEFAULT_COMPRESSION_LEVEL = 9
MAX_COMPRESSION_LEVEL = 17

MEMORY_USAGE = 14
NOT_COMPRESSIBLE_DETECTION_LEVEL = 6

MIN_MATCH = 4

HASH_LOG = MEMORY_USAGE - 2          # 12
HASH_TABLE_SIZE = 1 << HASH_LOG      # 4096

SKIP_STRENGTH = max(NOT_COMPRESSIBLE_DETECTION_LEVEL, 2)  # 6
COPY_LENGTH = 8
LAST_LITERALS = 5
MF_LIMIT = COPY_LENGTH + MIN_MATCH   # 12
MIN_LENGTH = MF_LIMIT + 1            # 13

MAX_DISTANCE = 1 << 16               # 65536

ML_BITS = 4
ML_MASK = (1 << ML_BITS) - 1         # 15
RUN_BITS = 8 - ML_BITS
RUN_MASK = (1 << RUN_BITS) - 1       # 15

LZ4_64K_LIMIT = (1 << 16) + (MF_LIMIT - 1)  # 65547
HASH_LOG_64K = HASH_LOG + 1          # 13
HASH_TABLE_SIZE_64K = 1 << HASH_LOG_64K  # 8192

HASH_LOG_HC = 15
HASH_TABLE_SIZE_HC = 1 << HASH_LOG_HC  # 32768
OPTIMAL_ML = ML_MASK - 1 + MIN_MATCH   # 18

# Maximum input size accepted by max_compressed_length
# (reference: LZ4Utils.java:32)
MAX_INPUT_SIZE = 0x7E000000

# Fibonacci-style hash multiplier, as unsigned 32-bit
# (reference: LZ4Utils.java:43-53 uses -1640531535 == 2654435761 unsigned)
HASH_MULTIPLIER = 2654435761

# ---------------------------------------------------------------------------
# xxHash constants (unsigned representations)
# ---------------------------------------------------------------------------

PRIME1 = 2654435761   # == -1640531535 as signed int32
PRIME2 = 2246822519   # == -2048144777
PRIME3 = 3266489917   # == -1028477379
PRIME4 = 668265263
PRIME5 = 374761393

PRIME64_1 = 11400714785074694791
PRIME64_2 = 14029467366897019727
PRIME64_3 = 1609587929392839161
PRIME64_4 = 9650029242287828579
PRIME64_5 = 2870177450012600261

U32 = 0xFFFFFFFF
U64 = 0xFFFFFFFFFFFFFFFF


def max_compressed_length(length: int) -> int:
    """Worst-case compressed size bound; identical to LZ4_compressBound.

    Reference: ``LZ4Utils.java:32-41``.
    """
    if length < 0:
        raise ValueError(f"length must be >= 0, got {length}")
    if length >= MAX_INPUT_SIZE:
        raise ValueError(f"length must be < {MAX_INPUT_SIZE}")
    return length + length // 255 + 16


def hash_general(v: int) -> int:
    """Hash a 32-bit value into HASH_LOG bits (general path)."""
    return ((v * HASH_MULTIPLIER) & U32) >> (32 - HASH_LOG)


def hash_64k(v: int) -> int:
    """Hash a 32-bit value into HASH_LOG_64K bits (<64KB path)."""
    return ((v * HASH_MULTIPLIER) & U32) >> (32 - HASH_LOG_64K)


def hash_hc(v: int) -> int:
    """Hash a 32-bit value into HASH_LOG_HC bits (HC match finder)."""
    return ((v * HASH_MULTIPLIER) & U32) >> (32 - HASH_LOG_HC)
