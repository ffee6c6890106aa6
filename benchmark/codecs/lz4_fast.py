"""LZ4 fast at acceleration 1, as lz4-java's ``fastCompressor()`` writes a
block: the port's ``compress_fast_batch`` (K2)."""

ENTRY = "compress_fast_batch"


def program(config: dict):
    from lz4_tpu_torch import compress_fast_batch

    return compress_fast_batch


def reference(raw: bytes, config: dict) -> bytes:
    from benchmark.reference import compress_fast

    return compress_fast(raw)
