"""The port's container formats (``lz4_tpu_torch.formats``) on the CPU,
where every codec runs its kernels' plain versions, against the JAX
package's (``lz4_tpu.formats``) on the same seeded inputs: the frame, the
LZ4Block stream and the length-prefixed codec. Mirrors
``tests/test_formats.py`` case for case; bytes must be equal, each package
must read the other's output, and errors must be of the same class."""

import io
import struct

import pytest

import lz4_tpu.formats as jfmt
from lz4_tpu.api.factory import Lz4Factory as JaxLz4Factory
from lz4_tpu_torch import formats as fmt
from lz4_tpu_torch.api.factory import Lz4Factory
from lz4_tpu_torch.core.errors import Lz4Error, Lz4FrameError
from lz4_tpu_torch.formats import (
    BlockSize, FrameFlag, Lz4BlockInputStream, Lz4BlockOutputStream,
    Lz4CompressorWithLength, Lz4DecompressorWithLength, Lz4FrameInputStream,
    Lz4FrameOutputStream, compress_block_stream, compress_frame,
    decompress_block_stream, decompress_frame, get_decompressed_length,
    make_skippable_frame,
)

from conftest import random_bytes

CPU = "cpu"
CHECKSUMS = (FrameFlag.BLOCK_INDEPENDENCE, FrameFlag.CONTENT_CHECKSUM,
             FrameFlag.BLOCK_CHECKSUM)


class ShortReadStream(io.RawIOBase):
    """Short reads (LZ4BlockStreamingTest.java:42-125)."""

    def __init__(self, data, max_chunk=3):
        self._data = data
        self._pos = 0
        self._max_chunk = max_chunk

    def read(self, n=-1):
        if self._pos >= len(self._data):
            return b""
        take = min(n if n >= 0 else self._max_chunk, self._max_chunk,
                   len(self._data) - self._pos)
        out = self._data[self._pos:self._pos + take]
        self._pos += take
        return out


def _jax_flags(features):
    return tuple(jfmt.FrameFlag(int(f)) for f in features)


def _jax_frame(data, block_size=BlockSize.SIZE_4MB, features=None, **kw):
    if features is not None:
        kw["features"] = _jax_flags(features)
    return jfmt.compress_frame(data, block_size=jfmt.BlockSize(int(block_size)),
                               **kw)


def _port_frame(data, **kw):
    return compress_frame(data, device=CPU, **kw)


def _raises_as_jax(port_fn, jax_fn):
    """Both raise, the port an Lz4Error of the JAX error's class name."""
    with pytest.raises(Exception) as jax_err:
        jax_fn()
    with pytest.raises(Lz4Error) as port_err:
        port_fn()
    assert type(port_err.value).__name__ == type(jax_err.value).__name__
    return port_err.value, jax_err.value


def test_formats_export_the_jax_names():
    assert sorted(fmt.__all__) == sorted(jfmt.__all__)
    assert len(fmt.__all__) == 14
    for name in fmt.__all__:
        assert hasattr(fmt, name)


FRAME_SIZES = [0, 1, 1023, 1024, 1025, 65536, 131072]


@pytest.mark.parametrize("size", FRAME_SIZES)
def test_frame_roundtrip(size, rng):
    data = random_bytes(rng, size, 32)
    framed = _port_frame(data)
    assert framed[:4] == struct.pack("<I", 0x184D2204)
    assert framed == _jax_frame(data)
    assert decompress_frame(framed, device=CPU) == data
    assert jfmt.decompress_frame(framed) == data


@pytest.mark.parametrize("block_size", list(BlockSize))
def test_frame_block_sizes(block_size, rng):
    data = random_bytes(rng, 200000, 16)
    framed = _port_frame(data, block_size=block_size)
    assert framed == _jax_frame(data, block_size)
    assert decompress_frame(framed, device=CPU) == data


@pytest.mark.parametrize("known_size", [False, True])
@pytest.mark.parametrize("dict_case", ["none", "dict", "dict_id"])
@pytest.mark.parametrize("block_size", [BlockSize.SIZE_64KB,
                                        BlockSize.SIZE_256KB])
@pytest.mark.parametrize("features", [
    (FrameFlag.BLOCK_INDEPENDENCE,),
    (FrameFlag.BLOCK_INDEPENDENCE, FrameFlag.CONTENT_CHECKSUM),
    CHECKSUMS,
], ids=["plain", "content", "content_block"])
def test_frame_bytes_equal_jax(features, block_size, dict_case, known_size,
                               rng):
    """compress_frame on the CPU equals the JAX package's, byte for byte,
    for every features x block size x dictionary/dict_id case; each
    package reads the other's frame."""
    dictionary = random_bytes(rng, 40_000, 64)
    data = (dictionary[5_000:30_000] + random_bytes(rng, 150_000, 8)
            + dictionary[:20_000] + random_bytes(rng, 70_000, 256))
    kw = dict(features=features, known_size=known_size)
    if dict_case != "none":
        kw["dictionary"] = dictionary
    if dict_case == "dict_id":
        kw["dict_id"] = 0xC0FFEE
    port = _port_frame(data, block_size=block_size, **kw)
    assert port == _jax_frame(data, block_size, **kw)
    read = dict(dictionary=kw.get("dictionary"))
    assert decompress_frame(port, device=CPU, **read) == data
    assert jfmt.decompress_frame(port, **read) == data
    stream = Lz4FrameInputStream(io.BytesIO(port), device=CPU, **read)
    assert stream.read() == data
    assert stream.dict_id == kw.get("dict_id")
    assert stream.expected_content_size == (len(data) if known_size else -1)


def test_frame_content_size_from_features(rng):
    """CONTENT_SIZE named in features declares the size, as the JAX
    package's one-call codec declares it; DICT_ID without a dictionary is
    dropped there, as the JAX one-call codec drops it."""
    data = random_bytes(rng, 5000, 8)
    feats = (FrameFlag.BLOCK_INDEPENDENCE, FrameFlag.CONTENT_SIZE)
    assert _port_frame(data, features=feats) == _jax_frame(data,
                                                           features=feats)
    feats = (FrameFlag.BLOCK_INDEPENDENCE, FrameFlag.DICT_ID)
    assert _port_frame(data, features=feats) == _jax_frame(data,
                                                           features=feats)


def test_frame_all_features(rng):
    data = random_bytes(rng, 100000, 8)
    framed = _port_frame(data, features=CHECKSUMS, known_size=True)
    assert framed == _jax_frame(data, features=CHECKSUMS, known_size=True)
    assert decompress_frame(framed, device=CPU) == data


def test_frame_content_size_accessor(rng):
    data = random_bytes(rng, 5000, 8)
    framed = _jax_frame(data, known_size=True)
    stream = Lz4FrameInputStream(io.BytesIO(framed), device=CPU)
    assert stream.read() == data
    assert stream.expected_content_size == len(data)


@pytest.mark.parametrize("case", ["content", "block", "header"])
def test_frame_corruption_detected(case, rng):
    data = random_bytes(rng, 50000, 4)
    if case == "header":
        framed = bytearray(_jax_frame(b"hello world"))
        framed[5] ^= 0x10
    else:
        feats = (FrameFlag.BLOCK_INDEPENDENCE,
                 FrameFlag.CONTENT_CHECKSUM if case == "content"
                 else FrameFlag.BLOCK_CHECKSUM)
        framed = bytearray(_jax_frame(data, features=feats))
        framed[100 if case == "content" else 200] ^= \
            0x01 if case == "content" else 0xFF
    framed = bytes(framed)
    _raises_as_jax(lambda: decompress_frame(framed, device=CPU),
                   lambda: jfmt.decompress_frame(framed))
    _raises_as_jax(
        lambda: Lz4FrameInputStream(io.BytesIO(framed), device=CPU).read(),
        lambda: jfmt.Lz4FrameInputStream(io.BytesIO(framed)).read())


def test_frame_incompressible_stored_raw(rng):
    data = random_bytes(rng, 70000, 256)
    framed = _port_frame(data, block_size=BlockSize.SIZE_64KB)
    assert framed == _jax_frame(data, BlockSize.SIZE_64KB)
    assert struct.unpack_from("<I", framed, 7)[0] & 0x80000000
    assert decompress_frame(framed, device=CPU) == data


def test_concatenated_frames(rng):
    a = random_bytes(rng, 3000, 8)
    b = random_bytes(rng, 4000, 8)
    blob = _port_frame(a) + _jax_frame(b)
    assert decompress_frame(blob, device=CPU) == a + b
    assert decompress_frame(blob, read_single_frame=True, device=CPU) == a
    stream = Lz4FrameInputStream(io.BytesIO(blob), read_single_frame=True,
                                 device=CPU)
    assert stream.read() == a


def test_skippable_frames(rng):
    data = random_bytes(rng, 2000, 8)
    blob = (make_skippable_frame(b"metadata" * 10, subtype=3)
            + _port_frame(data) + make_skippable_frame(b"trailer")
            + _port_frame(data))
    assert make_skippable_frame(b"x", 5) == jfmt.make_skippable_frame(b"x", 5)
    assert decompress_frame(blob, device=CPU) == data + data
    assert decompress_frame(blob, read_single_frame=True, device=CPU) == data
    assert Lz4FrameInputStream(io.BytesIO(blob), device=CPU).read() == \
        data + data


@pytest.mark.parametrize("blob", [
    b"\x00\x01\x02\x03garbagegarbage",   # not a frame
    b"",                                 # nothing at all
    b"\x04\x22\x4d\x18\x00\x40",         # version 0
    b"\x04\x22\x4d\x18\x62\x40\x00",     # reserved bit 1
    b"\x04\x22\x4d\x18\x61\x40\x00",     # DictID, no dictionary
    b"\x04\x22\x4d\x18\x40\x40\x00",     # linked blocks, not allowed
    b"\x04\x22\x4d\x18\x60\x30\x00",     # block size indicator 3
    b"\x04\x22\x4d\x18\x60\xc0\x00",     # reserved BD bit
], ids=["magic", "empty", "version", "reserved", "dict_id", "dependent",
        "bd", "bd_reserved"])
def test_frame_header_errors_match_jax(blob):
    """Malformed headers raise the JAX reader's class and message."""
    port, jax = _raises_as_jax(
        lambda: Lz4FrameInputStream(io.BytesIO(blob), device=CPU).read(),
        lambda: jfmt.Lz4FrameInputStream(io.BytesIO(blob)).read())
    assert str(port) == str(jax)
    if blob:    # the one-call codecs decode empty input to nothing
        _raises_as_jax(lambda: decompress_frame(blob, device=CPU),
                       lambda: jfmt.decompress_frame(blob))
    else:
        assert decompress_frame(blob, device=CPU) == \
            jfmt.decompress_frame(blob) == b""


def test_frame_block_too_big_refused_before_payload():
    """A size word above the frame's block size is refused before its
    payload is read, as in the JAX reader."""
    desc = bytes([0x60, 0x40])
    head = (struct.pack("<I", 0x184D2204) + desc
            + bytes([(fmt.frame.xxh32_bytes(desc) >> 8) & 0xFF]))
    blob = head + struct.pack("<I", (1 << 16) + 1)
    port, jax = _raises_as_jax(
        lambda: Lz4FrameInputStream(io.BytesIO(blob), device=CPU).read(),
        lambda: jfmt.Lz4FrameInputStream(io.BytesIO(blob)).read())
    assert str(port) == str(jax)


def test_frame_short_reads(rng):
    data = random_bytes(rng, 30000, 8)
    framed = _jax_frame(data, features=(FrameFlag.BLOCK_INDEPENDENCE,
                                        FrameFlag.CONTENT_CHECKSUM))
    stream = Lz4FrameInputStream(ShortReadStream(framed), device=CPU)
    out = bytearray()
    while chunk := stream.read(7):
        out.extend(chunk)
    assert bytes(out) == data


def test_frame_per_byte_write_and_flush(rng):
    """Writes of a byte and a flush in the middle (a short block there):
    the same frame as the JAX writer's."""
    data = random_bytes(rng, 5000, 8)
    frames = []
    for cls, kw in ((Lz4FrameOutputStream,
                     dict(block_size=BlockSize.SIZE_64KB, device=CPU)),
                    (jfmt.Lz4FrameOutputStream,
                     dict(block_size=jfmt.BlockSize.SIZE_64KB))):
        out = io.BytesIO()
        stream = cls(out, **kw)
        for i in range(len(data)):
            stream.write(data[i:i + 1])
            if i == 2000:
                stream.flush()
        stream.close_keep_underlying()
        frames.append(out.getvalue())
    assert frames[0] == frames[1]
    assert decompress_frame(frames[0], device=CPU) == data


def test_frame_writer_with_hc_compressor(rng):
    """An HC compressor in the writer (the cuda tier's, K6's plain
    version here) gives the JAX writer's bytes with the JAX HC."""
    data = random_bytes(rng, 20000, 16)
    outs = []
    for cls, comp, kw in (
            (Lz4FrameOutputStream,
             Lz4Factory.cuda_instance(CPU).high_compressor(1),
             dict(device=CPU)),
            (jfmt.Lz4FrameOutputStream,
             JaxLz4Factory.safe_instance().high_compressor(1), {})):
        out = io.BytesIO()
        stream = cls(out, compressor=comp, **kw)
        stream.write(data)
        stream.close_keep_underlying()
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert decompress_frame(outs[0], device=CPU) == data


def test_frame_empty_content():
    framed = _port_frame(b"")
    assert len(framed) == 4 + 1 + 1 + 1 + 4
    assert framed == _jax_frame(b"")
    assert decompress_frame(framed, device=CPU) == b""


def test_frame_truncated_raises(rng):
    data = random_bytes(rng, 10000, 8)
    framed = _port_frame(data)[:len(_port_frame(data)) // 2]
    _raises_as_jax(lambda: decompress_frame(framed, device=CPU),
                   lambda: jfmt.decompress_frame(framed))
    _raises_as_jax(
        lambda: Lz4FrameInputStream(io.BytesIO(framed), device=CPU).read(),
        lambda: jfmt.Lz4FrameInputStream(io.BytesIO(framed)).read())


# ---------------------------------------------------------------------------
# LZ4Block stream
# ---------------------------------------------------------------------------

def _block_stream(data, cls, block_size=1 << 16, **kw):
    out = io.BytesIO()
    s = cls(out, block_size=block_size, **kw)
    s.write(data)
    s.finish()
    return out.getvalue()


@pytest.mark.parametrize("size", [0, 1, 100, 65535, 65536, 65537, 200000])
def test_block_stream_roundtrip(size, rng):
    data = random_bytes(rng, size, 16)
    blob = _block_stream(data, Lz4BlockOutputStream, device=CPU)
    assert blob[:8] == b"LZ4Block"
    assert blob == _block_stream(data, jfmt.Lz4BlockOutputStream)
    assert compress_block_stream(data, device=CPU) == blob
    assert jfmt.compress_block_stream(data) == blob
    assert Lz4BlockInputStream(io.BytesIO(blob), device=CPU).read() == data
    assert decompress_block_stream(blob, device=CPU) == data
    assert jfmt.decompress_block_stream(blob) == data


@pytest.mark.parametrize("block_size", [64, 1024, 1 << 16, 1 << 20])
def test_block_stream_block_sizes(block_size, rng):
    data = random_bytes(rng, 150000, 8)
    blob = compress_block_stream(data, block_size, device=CPU)
    assert blob == _block_stream(data, jfmt.Lz4BlockOutputStream, block_size)
    assert decompress_block_stream(blob, device=CPU) == data
    assert Lz4BlockInputStream(io.BytesIO(blob), device=CPU).read() == data


def test_block_stream_concatenated(rng):
    """stop_on_empty_block=False reads across stream boundaries
    (LZ4BlockStreamingTest.java:309-348)."""
    a = random_bytes(rng, 5000, 8)
    b = random_bytes(rng, 6000, 8)
    blob = compress_block_stream(a, device=CPU) + \
        jfmt.compress_block_stream(b)
    assert Lz4BlockInputStream(io.BytesIO(blob), device=CPU).read() == a
    assert decompress_block_stream(blob, device=CPU) == a
    r = Lz4BlockInputStream(io.BytesIO(blob), stop_on_empty_block=False,
                            device=CPU)
    assert r.read() == a + b
    assert decompress_block_stream(blob, stop_on_empty_block=False,
                                   device=CPU) == a + b


@pytest.mark.parametrize("case", ["payload", "magic", "truncated",
                                  "no_end"])
def test_block_stream_corruption_detected(case, rng):
    data = random_bytes(rng, 10000, 8)
    blob = bytearray(compress_block_stream(data, 4096, device=CPU))
    if case == "payload":
        blob[30] ^= 0xFF
    elif case == "magic":
        blob[0] = 0x58
    elif case == "truncated":
        blob = blob[:len(blob) // 2]
    else:
        blob = blob[:-21]
    blob = bytes(blob)
    _raises_as_jax(
        lambda: Lz4BlockInputStream(io.BytesIO(blob), device=CPU).read(),
        lambda: jfmt.Lz4BlockInputStream(io.BytesIO(blob)).read())
    _raises_as_jax(lambda: decompress_block_stream(blob, device=CPU),
                   lambda: jfmt.Lz4BlockInputStream(io.BytesIO(blob)).read())


def test_block_stream_length_refused_before_payload():
    """A compressed length past the bound of its block size is refused
    before anything of the payload is read, as the JAX reader refuses it
    (``lz4_tpu/formats/block_stream.py:195-200``)."""
    header = struct.pack("<8sBIII", b"LZ4Block", 0x26, 0xFFFFFFF0, 1000, 0)
    port, jax = _raises_as_jax(
        lambda: Lz4BlockInputStream(io.BytesIO(header), device=CPU).read(),
        lambda: jfmt.Lz4BlockInputStream(io.BytesIO(header)).read())
    assert str(port) == str(jax) == "Stream is corrupted"
    with pytest.raises(Lz4FrameError, match="corrupted"):
        decompress_block_stream(header, device=CPU)


def test_block_stream_short_reads(rng):
    data = random_bytes(rng, 20000, 8)
    blob = _block_stream(data, Lz4BlockOutputStream, 4096, device=CPU)
    r = Lz4BlockInputStream(ShortReadStream(blob, max_chunk=5), device=CPU)
    got = bytearray()
    while chunk := r.read(11):
        got.extend(chunk)
    assert bytes(got) == data


def test_block_stream_sync_flush(rng):
    data = random_bytes(rng, 100, 8)
    out = io.BytesIO()
    s = Lz4BlockOutputStream(out, block_size=1 << 16, sync_flush=True,
                             device=CPU)
    s.write(data)
    s.flush()
    assert len(out.getvalue()) > 0
    s.finish()
    assert Lz4BlockInputStream(io.BytesIO(out.getvalue()),
                               device=CPU).read() == data


def test_block_stream_hc_compressor(rng):
    data = random_bytes(rng, 20000, 4)
    blob = _block_stream(data, Lz4BlockOutputStream, device=CPU,
                         compressor=Lz4Factory.cuda_instance(CPU)
                         .high_compressor(1))
    assert blob == _block_stream(
        data, jfmt.Lz4BlockOutputStream,
        compressor=JaxLz4Factory.safe_instance().high_compressor(1))
    assert Lz4BlockInputStream(io.BytesIO(blob), device=CPU).read() == data


# ---------------------------------------------------------------------------
# with-length codec
# ---------------------------------------------------------------------------

def test_with_length_roundtrip(rng):
    f = Lz4Factory.cuda_instance(CPU)
    data = random_bytes(rng, 12345, 8)
    comp = Lz4CompressorWithLength(f.fast_compressor())
    blob = comp.compress_alloc(data)
    assert get_decompressed_length(blob) == len(data)
    jf = JaxLz4Factory.safe_instance()
    assert blob == jfmt.Lz4CompressorWithLength(
        jf.fast_compressor()).compress_alloc(data)
    for decomp in (Lz4DecompressorWithLength(f.fast_decompressor()),
                   Lz4DecompressorWithLength(f.safe_decompressor())):
        assert decomp.decompress_alloc(blob) == data
    with pytest.raises(TypeError):
        Lz4DecompressorWithLength(f.fast_compressor())


def test_with_length_offsets(rng):
    f = Lz4Factory.cuda_instance(CPU)
    data = random_bytes(rng, 999, 8)
    comp = Lz4CompressorWithLength(f.fast_compressor())
    dest = bytearray(50 + comp.max_compressed_length(len(data)))
    n = comp.compress(data, 0, len(data), dest, 50, len(dest) - 50)
    decomp = Lz4DecompressorWithLength(f.safe_decompressor())
    restored = bytearray(len(data))
    assert decomp.decompress(dest, 50, restored, 0, n) == len(data)
    assert bytes(restored) == data
    with pytest.raises(Lz4Error, match="too small"):
        comp.compress(data, 0, len(data), dest, 0, 3)
    with pytest.raises(Lz4Error, match="too small"):
        decomp.decompress(dest, 50, bytearray(10), 0, n)
