"""The port's parallel compressor (K7, ``compress_parallel_batch``): valid
LZ4, but not the bytes of the fast scan. No configuration states it; it is
``block64k_fast``'s control, the program's own path that gives up the
byte identity the configuration states. It has no reference."""

ENTRY = "compress_parallel_batch"


def program(config: dict):
    from lz4_tpu_torch.kernels.parallel_compress import compress_parallel_batch

    def compress(src, lens, cap):
        dest, comp_lens = compress_parallel_batch(src, lens, cap)
        return dest, comp_lens, (comp_lens < 0).to(comp_lens.dtype)

    return compress
