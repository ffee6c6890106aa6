"""LZ4 HC at the configuration's ``level``, as lz4-java's
``highCompressor(level)`` writes a block: the port's ``compress_hc_batch``
(K6)."""

ENTRY = "compress_hc_batch"


def program(config: dict):
    from lz4_tpu_torch.kernels.hc import compress_hc_batch

    level = config["level"]
    return lambda src, lens, cap: compress_hc_batch(src, lens, cap, level)


def reference(raw: bytes, config: dict) -> bytes:
    from benchmark.reference_hc import compress_hc_block

    return compress_hc_block(raw, config["level"])
