"""The port's LZ4Block stream calls, for the ``lz4block_*`` pipelines:
``block_stream_body_packed``, ``block_stream_index`` and
``decompress_block_stream_batch``.

They are taken from the module of the program that ``system.Port``
imported (``lz4_tpu_torch/dist/sharded.py``, where the frame body's call
lives too), so that ``system.py`` stays the one module of the benchmark
that imports the program. A program without them (one older than the
calls) fails the run at once, before any work. Each call carries the name
of the program's function it calls, which the benchmark's spans take.
"""

from __future__ import annotations

PACK = "block_stream_body_packed"
INDEX = "block_stream_index"
DECODE = "decompress_block_stream_batch"


class BlockStream:
    """The stream calls of ``port`` (a ``system.Port``)."""

    def __init__(self, port):
        sharded = port._sharded
        missing = [n for n in (PACK, INDEX, DECODE) if not hasattr(sharded, n)]
        if missing:
            raise RuntimeError("the program has no LZ4Block stream calls: "
                               + ", ".join(missing))
        self._pack = getattr(sharded, PACK)
        self._index = getattr(sharded, INDEX)
        self._decode = getattr(sharded, DECODE)

    def body(self, src, lens, comp, comp_lens, block_size: int):
        """(stream, total): the batch as one stream; the host holds
        ``total``."""
        return self._pack(src, lens, comp, comp_lens, block_size)

    def index(self, stream, stream_len: int, max_blocks: int):
        """The stream's records, on the card."""
        return self._index(stream, stream_len, max_blocks)

    def decode(self, stream, index, block_size: int):
        """(out, out_lens, err): every record decoded and checked."""
        return self._decode(stream, index, block_size)


def of(port) -> BlockStream:
    """``port.block_stream`` where a test planted faults in the calls, else
    the calls of ``port``."""
    return getattr(port, "block_stream", None) or BlockStream(port)
