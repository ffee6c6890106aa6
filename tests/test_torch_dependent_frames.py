"""Linked-block (``lz4 -BD``) and dictionary (``lz4 -D``, LZ4F usingDict)
frames in the port, on the CPU (the kernels' plain versions), against the
JAX package and upstream LZ4F. Mirrors ``tests/test_dependent_frames.py``:
frames from the system ``liblz4.so.1`` (those cases skip without it), the
port's window codecs against ``native_instances``' at every history
length of ``testing.HIST_LENS``, and each package reading the other's
frames."""

import ctypes
import io
import struct

import numpy as np
import pytest
import torch

import lz4_tpu.formats as jfmt
from lz4_tpu.formats import frame as jframe
from lz4_tpu_torch import testing
from lz4_tpu_torch.__main__ import main as cli_main
from lz4_tpu_torch.api import cuda_instances as ci
from lz4_tpu_torch.api.factory import Lz4Factory
from lz4_tpu_torch.core.errors import Lz4Error, Lz4FrameError
from lz4_tpu_torch.formats import frame as frame_mod
from lz4_tpu_torch.kernels import codec, layout
from lz4_tpu_torch.streams import decompress_stream

from conftest import random_bytes

ni = pytest.importorskip("lz4_tpu.api.native_instances")

CPU = "cpu"

try:
    _LIB = ctypes.CDLL("liblz4.so.1")
    _LIB.LZ4F_compressFrameBound.restype = ctypes.c_size_t
    _LIB.LZ4F_compressFrameBound.argtypes = [ctypes.c_size_t, ctypes.c_void_p]
    _LIB.LZ4F_compressFrame.restype = ctypes.c_size_t
    _LIB.LZ4F_isError.restype = ctypes.c_uint
    _LIB.LZ4F_isError.argtypes = [ctypes.c_size_t]
except OSError:
    _LIB = None

needs_liblz4 = pytest.mark.skipif(_LIB is None, reason="liblz4 unavailable")


class _FrameInfo(ctypes.Structure):
    _fields_ = [("blockSizeID", ctypes.c_int),
                ("blockMode", ctypes.c_int),
                ("contentChecksumFlag", ctypes.c_int),
                ("frameType", ctypes.c_int),
                ("contentSize", ctypes.c_ulonglong),
                ("dictID", ctypes.c_uint),
                ("blockChecksumFlag", ctypes.c_int)]


class _Preferences(ctypes.Structure):
    _fields_ = [("frameInfo", _FrameInfo),
                ("compressionLevel", ctypes.c_int),
                ("autoFlush", ctypes.c_uint),
                ("favorDecSpeed", ctypes.c_uint),
                ("reserved", ctypes.c_uint * 3)]


def _upstream_linked_frame(data: bytes, content_checksum=True,
                           block_size_id=4, block_checksum=False,
                           content_size=False) -> bytes:
    """A linked-block frame from upstream LZ4F (blockMode 0)."""
    prefs = _Preferences()
    prefs.frameInfo.blockSizeID = block_size_id
    prefs.frameInfo.blockMode = 0
    prefs.frameInfo.contentChecksumFlag = 1 if content_checksum else 0
    prefs.frameInfo.blockChecksumFlag = 1 if block_checksum else 0
    if content_size:
        prefs.frameInfo.contentSize = len(data)
    bound = _LIB.LZ4F_compressFrameBound(len(data), ctypes.byref(prefs))
    dst = ctypes.create_string_buffer(bound)
    n = _LIB.LZ4F_compressFrame(dst, bound, data, len(data),
                                ctypes.byref(prefs))
    assert not _LIB.LZ4F_isError(n)
    return dst.raw[:n]


def _upstream_dict_frame(data: bytes, dictionary: bytes, block_mode: int,
                         dict_id: int = 0) -> bytes:
    """A frame compressed against a dictionary by upstream LZ4F."""
    _LIB.LZ4F_createCDict.restype = ctypes.c_void_p
    _LIB.LZ4F_createCDict.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    _LIB.LZ4F_compressFrame_usingCDict.restype = ctypes.c_size_t
    cdict = _LIB.LZ4F_createCDict(dictionary, len(dictionary))
    cctx = ctypes.c_void_p()
    assert not _LIB.LZ4F_isError(
        _LIB.LZ4F_createCompressionContext(ctypes.byref(cctx), 100))
    try:
        prefs = _Preferences()
        prefs.frameInfo.blockSizeID = 4
        prefs.frameInfo.blockMode = block_mode
        prefs.frameInfo.contentChecksumFlag = 1
        prefs.frameInfo.dictID = dict_id
        bound = _LIB.LZ4F_compressFrameBound(len(data), ctypes.byref(prefs))
        dst = ctypes.create_string_buffer(bound)
        n = _LIB.LZ4F_compressFrame_usingCDict(
            cctx, dst, bound, data, len(data), ctypes.c_void_p(cdict),
            ctypes.byref(prefs))
        assert not _LIB.LZ4F_isError(n)
        return dst.raw[:n]
    finally:
        _LIB.LZ4F_freeCompressionContext(cctx)
        _LIB.LZ4F_freeCDict(ctypes.c_void_p(cdict))


def _upstream_decompress_with_dict(comp: bytes, dictionary: bytes) -> bytes:
    """A frame decoded by upstream LZ4F_decompress_usingDict."""
    _LIB.LZ4F_decompress_usingDict.restype = ctypes.c_size_t
    _LIB.LZ4F_decompress_usingDict.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
        ctypes.c_size_t, ctypes.c_void_p]
    ctx = ctypes.c_void_p()
    assert not _LIB.LZ4F_isError(
        _LIB.LZ4F_createDecompressionContext(ctypes.byref(ctx), 100))
    try:
        out = bytearray()
        cap = 1 << 18
        dst = ctypes.create_string_buffer(cap)
        pos = 0
        while pos < len(comp):
            dst_size = ctypes.c_size_t(cap)
            src_size = ctypes.c_size_t(len(comp) - pos)
            r = _LIB.LZ4F_decompress_usingDict(
                ctx, dst, ctypes.byref(dst_size), comp[pos:],
                ctypes.byref(src_size), dictionary, len(dictionary), None)
            assert not _LIB.LZ4F_isError(r)
            out += dst.raw[:dst_size.value]
            pos += src_size.value
            if r == 0 and pos >= len(comp):
                break
        return bytes(out)
    finally:
        _LIB.LZ4F_freeDecompressionContext(ctx)


def _linked_corpus(rng, n=300_000):
    """Matches that cross 64 KiB block boundaries: a period of 40,000."""
    pat = random_bytes(rng, 40_000, 32)
    return (pat * (n // len(pat) + 1))[:n]


def _port_linked_frame(data: bytes, bd: int = 4, **kw) -> bytes:
    """A linked frame of the port's own making (``testing.linked_blocks``:
    each block against the content before it)."""
    bs = 1 << (2 * bd + 8)
    raws = [data[i:i + bs] for i in range(0, len(data), bs)]
    return testing.build_frame(raws, testing.linked_blocks(data, bs, CPU),
                               bd=bd, independent=False, **kw)


def _read_all(fr, **kw):
    return frame_mod.Lz4FrameInputStream(io.BytesIO(fr), device=CPU,
                                         **kw).read()


# ---------------------------------------------------------------------------
# the window codecs against the native ones
# ---------------------------------------------------------------------------

def _native_hist_decode(comp: bytes, out_max: int, hist: bytes):
    """(code, bytes) of ``tpulz4_decompress_safe_ext``: 0 and the output,
    or the native error code."""
    buf = bytearray(len(hist) + out_max)
    buf[:len(hist)] = hist
    arr = (ctypes.c_uint8 * len(buf)).from_buffer(buf)
    src = ctypes.create_string_buffer(comp, len(comp) or 1)
    n = ni._lib.tpulz4_decompress_safe_ext(
        ctypes.cast(src, ni._U8P), len(comp),
        ctypes.cast(ctypes.addressof(arr) + len(hist), ni._U8P), out_max,
        len(hist))
    del arr
    return (0, bytes(buf[len(hist):len(hist) + n])) if n >= 0 else (n, None)


# the native codes beside the port's
_CODES = {0: codec.OK, -1: codec.ERR_DEST_TOO_SMALL, -2: codec.ERR_MALFORMED}


@pytest.mark.parametrize("hist_len", testing.HIST_LENS)
def test_history_decode_matches_native(hist_len):
    """The history decode (plain version and the tier's entry point)
    equals ``decompress_block_with_history`` and the native decoder's
    codes, on the history cases, blocks that reach before the history,
    fuzz, and tight caps."""
    rng = np.random.default_rng(hist_len)
    cases = [c for c in testing.history_blocks(rng) if len(c[0]) == hist_len]
    blocks = [testing.encode_block(s, t) for _, s, t in cases]
    hist = cases[0][0] if cases else rng.integers(0, 8, hist_len,
                                                  dtype=np.uint8).tobytes()
    blocks += [b for h, b in testing.overreach_blocks(rng)
               if len(h) == hist_len]
    blocks += testing.fuzz_blocks(rng, blocks, 40)
    hist_t = torch.frombuffer(bytearray(hist + b"\0"),
                              dtype=torch.uint8)[:max(1, hist_len)].view(1, -1)
    for out_max in (70000, 100, 17):
        c, cl = layout.to_device_layout(blocks, device=CPU)
        out, out_lens, err = codec.decompress_safe_hist_batch(
            c, cl, out_max, hist_t,
            torch.full((len(blocks),), hist_len, dtype=torch.int32))
        for i, blk in enumerate(blocks):
            code, want = _native_hist_decode(blk, out_max, hist)
            assert _CODES[code] == int(err[i]), i
            if code == 0:
                assert out[i, :int(out_lens[i])].numpy().tobytes() == want
                assert ci.decompress_blocks_with_history(
                    [blk], out_max, hist, CPU) == [want] == \
                    [ni.decompress_block_with_history(blk, out_max, hist)]
            else:
                with pytest.raises(Lz4Error):
                    ci.decompress_blocks_with_history([blk], out_max, hist,
                                                      CPU)


@pytest.mark.parametrize("hist_len", testing.HIST_LENS)
def test_dictionary_compress_matches_native(hist_len):
    """The dictionary compress (plain version, the tier's batch of one
    shared dictionary) equals ``compress_block_with_dict`` byte for byte,
    on blocks that share content with the dictionary, of sizes around the
    format's limits; tight caps give the native code."""
    rng = np.random.default_rng(100 + hist_len)
    d = testing.block_of(rng, "text", hist_len)
    blocks = []
    for size in (0, 5, 12, 13, 1000, 65536, 70000):
        for kind in ("alphabet4", "text", "incompressible"):
            b = testing.block_of(rng, kind, size)
            blocks.append((d[-2000:] + b)[:size])
    got = ci.compress_blocks_with_dict(blocks, d, CPU)
    assert got == [ni.compress_block_with_dict(b, d) for b in blocks]
    # tight caps: the native function's code at a cap below the length
    for b, full in zip(blocks, got):
        if len(full) < 20:
            continue
        cap = len(full) - 1
        src, lens = layout.to_device_layout([b], device=CPU)
        win = torch.frombuffer(bytearray(d + b"\0"),
                               dtype=torch.uint8)[:max(1, hist_len)].view(1, -1)
        _, _, err = codec.compress_dict_batch(
            src, lens, cap, win, torch.tensor([hist_len], dtype=torch.int32))
        buf = (ctypes.c_uint8 * (hist_len + len(b) + 1))()
        ctypes.memmove(buf, d + b, hist_len + len(b))
        dest = (ctypes.c_uint8 * cap)()
        n = ni._lib.tpulz4_compress_fast_ext(
            ctypes.cast(ctypes.addressof(buf) + hist_len, ni._U8P), len(b),
            hist_len, ctypes.cast(dest, ni._U8P), cap)
        assert n == ni.bindings.E_DEST_TOO_SMALL
        assert int(err[0]) == codec.ERR_DEST_TOO_SMALL


def test_malformed_overlong_history_reference_rejected():
    """A block whose match reaches past the history is MALFORMED, not a
    read of other memory: 1000 bytes back with 10 of history."""
    blk = bytes([0x40]) + b"abcd" + bytes([0xE8, 0x03]) + bytes([0]) + \
        b"endlit"
    with pytest.raises(Lz4Error):
        ci.decompress_blocks_with_history([blk], 65536, b"0123456789", CPU)
    with pytest.raises(Exception):
        ni.decompress_block_with_history(blk, 65536, b"0123456789")
    c, cl = layout.to_device_layout([blk], device=CPU)
    h = torch.frombuffer(bytearray(b"0123456789"), dtype=torch.uint8)
    err = codec.decompress_safe_hist_batch(
        c, cl, 65536, h.view(1, -1), torch.tensor([10], dtype=torch.int32))[2]
    assert err.tolist() == [codec.ERR_MALFORMED]


# ---------------------------------------------------------------------------
# linked frames
# ---------------------------------------------------------------------------

@needs_liblz4
def test_default_refuses_dependent(rng):
    fr = _upstream_linked_frame(_linked_corpus(rng))
    with pytest.raises(Lz4FrameError, match="Dependent block"):
        frame_mod.decompress_frame(fr, device=CPU)
    with pytest.raises(Lz4FrameError, match="Dependent block"):
        _read_all(fr)


@needs_liblz4
@pytest.mark.parametrize("flags", [
    dict(content_checksum=True),
    dict(content_checksum=False),
    dict(content_checksum=True, block_checksum=True),
    dict(content_checksum=True, content_size=True),
])
def test_optin_decodes_upstream_linked_frames(rng, flags):
    data = _linked_corpus(rng)
    fr = _upstream_linked_frame(data, **flags)
    assert not fr[4] & 0x20
    assert frame_mod.decompress_frame(fr, allow_dependent_blocks=True,
                                      device=CPU) == data
    assert _read_all(fr, allow_dependent_blocks=True) == data


@needs_liblz4
@pytest.mark.parametrize("size", [0, 1, 100, 65536, 65537, 200_000])
def test_optin_size_sweep(rng, size):
    data = _linked_corpus(rng, size) if size else b""
    fr = _upstream_linked_frame(data)
    assert frame_mod.decompress_frame(fr, allow_dependent_blocks=True,
                                      device=CPU) == data


@needs_liblz4
def test_optin_incompressible_blocks(rng):
    """Blocks stored raw between compressed ones: the window moves over
    them too."""
    pat = random_bytes(rng, 30_000, 16)
    data = random_bytes(rng, 70_000, 256) + pat * 6 + \
        random_bytes(rng, 70_000, 256) + pat * 2
    fr = _upstream_linked_frame(data)
    assert _read_all(fr, allow_dependent_blocks=True) == data
    assert frame_mod.decompress_frame(fr, allow_dependent_blocks=True,
                                      device=CPU) == data


@needs_liblz4
def test_optin_concatenated_frames_reset_window(rng):
    a = _linked_corpus(rng, 150_000)
    b = _linked_corpus(rng, 90_000)
    fr = _upstream_linked_frame(a) + _upstream_linked_frame(b)
    assert frame_mod.decompress_frame(fr, allow_dependent_blocks=True,
                                      device=CPU) == a + b
    assert _read_all(fr, allow_dependent_blocks=True) == a + b
    assert frame_mod.decompress_frame(fr, allow_dependent_blocks=True,
                                      read_single_frame=True,
                                      device=CPU) == a


@needs_liblz4
def test_optin_highly_compressible():
    data = bytes(3 << 20)
    fr = _upstream_linked_frame(data, block_size_id=7)
    assert len(fr) * 4 < len(data)
    assert frame_mod.decompress_frame(fr, allow_dependent_blocks=True,
                                      device=CPU) == data


@needs_liblz4
def test_optin_corruption_detected(rng):
    data = _linked_corpus(rng)
    fr = bytearray(_upstream_linked_frame(data, content_checksum=True))
    fr[len(fr) // 2] ^= 0x5A
    with pytest.raises(Lz4Error):
        frame_mod.decompress_frame(bytes(fr), allow_dependent_blocks=True,
                                   device=CPU)


@pytest.mark.parametrize("bd", [4, 5])
@pytest.mark.parametrize("checksums", [False, True])
def test_port_linked_frames_read_by_both(rng, bd, checksums):
    """Linked frames made by the port's helper (each block compressed
    against the content before it) read back by both packages."""
    data = _linked_corpus(rng, 400_000)
    fr = _port_linked_frame(data, bd, block_checksum=checksums,
                            content_checksum=checksums)
    assert len(fr) < len(data) // 4
    assert jfmt.decompress_frame(fr, allow_dependent_blocks=True) == data
    assert frame_mod.decompress_frame(fr, allow_dependent_blocks=True,
                                      device=CPU) == data
    assert _read_all(fr, allow_dependent_blocks=True) == data


def test_large_skippable_frames_not_buffered(rng):
    """Skippable payloads are read in 1 MiB pieces, never whole: a 96 MiB
    skippable frame between two frames streams through the reader and the
    pipeline."""
    import tracemalloc

    data = random_bytes(rng, 50_000, 16)
    body = frame_mod.compress_frame(data, device=CPU)
    big_skip = (b"\x50\x2a\x4d\x18" + (96 << 20).to_bytes(4, "little")
                + bytes(96 << 20))
    stream_bytes = body + big_skip + body
    tracemalloc.start()
    got = _read_all(stream_bytes)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert got == data + data
    assert peak < 32 << 20, f"the reader buffered the skippable frame: {peak}"
    tracemalloc.start()
    out = io.BytesIO()
    n = decompress_stream(io.BytesIO(stream_bytes), out, device=CPU)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert n == 2 * len(data) and out.getvalue() == data + data
    assert peak < 32 << 20, f"the pipeline buffered it: {peak}"


def _oversized_block_frame(dependent: bool) -> bytes:
    """A frame of 64 KiB blocks whose one block decodes to 65,542 bytes."""
    ml = 65536 - 4 - 15
    block = (bytes([0x1F, ord("A"), 0x01, 0x00])
             + b"\xff" * (ml // 255) + bytes([ml % 255])
             + bytes([0x50]) + b"BBBBB")
    desc = bytes([0x40 | (0 if dependent else 0x20), 0x40])
    hc = (frame_mod.xxh32_bytes(desc) >> 8) & 0xFF
    return (struct.pack("<I", 0x184D2204) + desc + bytes([hc])
            + struct.pack("<I", len(block)) + block + struct.pack("<I", 0))


@pytest.mark.parametrize("dependent", [False, True])
def test_oversized_block_decode_rejected_fast(dependent):
    """A block that decodes past the frame's block size raises at once, in
    both packages, one-call and stream."""
    import time

    fr = _oversized_block_frame(dependent)
    t0 = time.perf_counter()
    with pytest.raises(Lz4Error):
        frame_mod.decompress_frame(fr, allow_dependent_blocks=dependent,
                                   device=CPU)
    with pytest.raises(Lz4Error):
        _read_all(fr, allow_dependent_blocks=dependent)
    assert time.perf_counter() - t0 < 10
    with pytest.raises(Exception):
        jfmt.decompress_frame(fr, allow_dependent_blocks=dependent)


def test_pipeline_and_cli_dependent_paths(rng, tmp_path, capsys):
    """decompress_stream and the CLI refuse linked frames by default and
    read them with the opt-in."""
    data = _linked_corpus(rng, 200_000)
    fr = _port_linked_frame(data, block_checksum=True)
    with pytest.raises(Lz4FrameError, match="Dependent block"):
        decompress_stream(io.BytesIO(fr), io.BytesIO(), device=CPU)
    out = io.BytesIO()
    n = decompress_stream(io.BytesIO(fr), out, allow_dependent=True,
                          device=CPU)
    assert n == len(data) and out.getvalue() == data
    # a linked frame between two frames of independent blocks
    plain = frame_mod.compress_frame(data[:5000], device=CPU)
    out = io.BytesIO()
    decompress_stream(io.BytesIO(plain + fr + plain), out,
                      allow_dependent=True, device=CPU)
    assert out.getvalue() == data[:5000] + data + data[:5000]
    src, dst = tmp_path / "in.lz4", tmp_path / "out.bin"
    src.write_bytes(fr)
    assert cli_main(["decompress", str(src), str(dst)], device=CPU) == 1
    assert cli_main(["decompress", "--allow-dependent", str(src), str(dst)],
                    device=CPU) == 0
    assert dst.read_bytes() == data
    capsys.readouterr()


def test_reader_keeps_the_jax_routing_of_a_decompressor(rng):
    """In linked and dictionary frames the reader decodes with the history
    kernel, not with a decompressor it was given, as the JAX reader does
    (``lz4_tpu/formats/frame.py:423-431``); independent blocks of a frame
    without a dictionary go to it."""
    calls = []
    safe = Lz4Factory.cuda_instance(CPU).safe_decompressor()

    class Counting(type(safe)):
        def decompress(self, *a, **kw):
            calls.append(1)
            return super().decompress(*a, **kw)

    data = _linked_corpus(rng, 150_000)
    fr = _port_linked_frame(data)
    dec = Counting(CPU)
    assert frame_mod.Lz4FrameInputStream(
        io.BytesIO(fr), decompressor=dec, allow_dependent_blocks=True,
        device=CPU).read() == data
    assert not calls
    fr = frame_mod.compress_frame(data, device=CPU)
    assert frame_mod.Lz4FrameInputStream(io.BytesIO(fr), decompressor=dec,
                                         device=CPU).read() == data
    assert calls


# ---------------------------------------------------------------------------
# dictionary frames
# ---------------------------------------------------------------------------

@needs_liblz4
@pytest.mark.parametrize("block_mode", [0, 1])  # linked, independent
def test_dictionary_frames_decode(rng, block_mode):
    dictionary = random_bytes(rng, 50_000, 64)
    data = dictionary[:30_000] + random_bytes(rng, 5_000, 64) + \
        dictionary[10_000:40_000] + dictionary[:20_000]
    fr = _upstream_dict_frame(data, dictionary, block_mode, dict_id=1234)
    assert fr[4] & 0x01
    kw = dict(dictionary=dictionary, allow_dependent_blocks=block_mode == 0)
    assert frame_mod.decompress_frame(fr, device=CPU, **kw) == data
    st = frame_mod.Lz4FrameInputStream(io.BytesIO(fr), device=CPU, **kw)
    assert st.read() == data and st.dict_id == 1234


@needs_liblz4
def test_dictionary_frame_without_dict_refused(rng):
    dictionary = random_bytes(rng, 30_000, 64)
    fr = _upstream_dict_frame(dictionary + dictionary[:10_000], dictionary, 1,
                              dict_id=7)
    with pytest.raises(Lz4FrameError, match="DictID"):
        frame_mod.decompress_frame(fr, device=CPU)
    with pytest.raises(Lz4FrameError, match="DictID"):
        _read_all(fr)


@needs_liblz4
def test_dictionary_wrong_dict_detected(rng):
    dictionary = random_bytes(rng, 30_000, 64)
    fr = _upstream_dict_frame(dictionary + dictionary[:10_000], dictionary, 1)
    wrong = random_bytes(rng, 30_000, 64)
    with pytest.raises(Lz4Error):
        frame_mod.decompress_frame(fr, dictionary=wrong, device=CPU)
    with pytest.raises(Lz4Error):
        _read_all(fr, dictionary=wrong)


def test_dictionary_writer_refusals():
    """The JAX writer's refusals: DICT_ID or dict_id without a dictionary,
    a custom compressor with one."""
    for kw in (dict(features=(frame_mod.FrameFlag.DICT_ID,)),
               dict(dict_id=7),
               dict(dictionary=b"x" * 100,
                    compressor=Lz4Factory.cuda_instance(CPU)
                    .high_compressor(9))):
        with pytest.raises(Lz4FrameError) as port:
            frame_mod.Lz4FrameOutputStream(io.BytesIO(), device=CPU, **kw)
        jkw = dict(kw)
        if "features" in jkw:
            jkw["features"] = (jframe.FrameFlag.DICT_ID,)
        if "compressor" in jkw:
            from lz4_tpu.api.factory import Lz4Factory as JaxLz4Factory
            jkw["compressor"] = JaxLz4Factory.safe_instance() \
                .high_compressor(9)
        with pytest.raises(Exception) as jax:
            jframe.Lz4FrameOutputStream(io.BytesIO(), **jkw)
        assert str(port.value) == str(jax.value)


def test_dictionary_dict_id_feature_without_value(rng):
    dictionary = random_bytes(rng, 20_000, 64)
    data = dictionary[:15_000]
    out = io.BytesIO()
    st = frame_mod.Lz4FrameOutputStream(
        out, features=(frame_mod.FrameFlag.BLOCK_INDEPENDENCE,
                       frame_mod.FrameFlag.DICT_ID),
        dictionary=dictionary, device=CPU)
    st.write(data)
    st.close_keep_underlying()
    fr = out.getvalue()
    assert fr[4] & 0x01
    rd = frame_mod.Lz4FrameInputStream(io.BytesIO(fr), dictionary=dictionary,
                                       device=CPU)
    assert rd.read() == data and rd.dict_id == 0
    assert fr == jframe.compress_frame(
        data, features=(jframe.FrameFlag.BLOCK_INDEPENDENCE,
                        jframe.FrameFlag.DICT_ID),
        dictionary=dictionary)


@needs_liblz4
def test_dictionary_write_side_upstream_interop(rng):
    """The port's dictionary frames decode with upstream
    LZ4F_decompress_usingDict and with both readers, and equal the JAX
    writer's bytes."""
    dictionary = random_bytes(rng, 30_000, 256)
    data = dictionary + random_bytes(rng, 4_000, 256) + dictionary[:20_000]
    kw = dict(block_size=frame_mod.BlockSize.SIZE_64KB, dictionary=dictionary,
              dict_id=99)
    fr = frame_mod.compress_frame(data, device=CPU, **kw)
    assert fr[4] & 0x01
    assert fr == jframe.compress_frame(
        data, block_size=jframe.BlockSize.SIZE_64KB, dictionary=dictionary,
        dict_id=99)
    assert _upstream_decompress_with_dict(fr, dictionary) == data
    assert frame_mod.decompress_frame(fr, dictionary=dictionary,
                                      device=CPU) == data
    assert jframe.decompress_frame(fr, dictionary=dictionary) == data
    plain = frame_mod.compress_frame(
        data, block_size=frame_mod.BlockSize.SIZE_64KB, device=CPU)
    assert len(fr) < len(plain) // 3


@needs_liblz4
def test_dictionary_write_no_dict_id_field(rng):
    dictionary = random_bytes(rng, 40_000, 256)
    data = dictionary[:35_000]
    fr = frame_mod.compress_frame(
        data, block_size=frame_mod.BlockSize.SIZE_64KB,
        features=(frame_mod.FrameFlag.BLOCK_INDEPENDENCE,
                  frame_mod.FrameFlag.CONTENT_CHECKSUM),
        dictionary=dictionary, device=CPU)
    assert not (fr[4] & 0x01)
    assert frame_mod.decompress_frame(fr, dictionary=dictionary,
                                      device=CPU) == data
    assert _upstream_decompress_with_dict(fr, dictionary) == data
    with pytest.raises(Lz4Error):
        frame_mod.decompress_frame(fr, device=CPU)


def test_dictionary_incompressible_blocks_match_jax(rng):
    """Blocks the dictionary does not shrink are compressed again without
    it (K2 on those blocks only) and stored raw when that fails too: the
    JAX writer's bytes."""
    dictionary = random_bytes(rng, 30_000, 256)
    data = (random_bytes(rng, 70_000, 256) + random_bytes(rng, 60_000, 4)
            + dictionary[:20_000])
    for feats in ((frame_mod.FrameFlag.BLOCK_INDEPENDENCE,),
                  (frame_mod.FrameFlag.BLOCK_INDEPENDENCE,
                   frame_mod.FrameFlag.BLOCK_CHECKSUM)):
        fr = frame_mod.compress_frame(
            data, block_size=frame_mod.BlockSize.SIZE_64KB, features=feats,
            dictionary=dictionary, device=CPU)
        assert fr == jframe.compress_frame(
            data, block_size=jframe.BlockSize.SIZE_64KB,
            features=tuple(jframe.FrameFlag(int(f)) for f in feats),
            dictionary=dictionary)
        assert frame_mod.decompress_frame(fr, dictionary=dictionary,
                                          device=CPU) == data


def test_writer_keeps_reference_parity():
    out = io.BytesIO()
    st = frame_mod.Lz4FrameOutputStream(out, device=CPU)
    st.write(b"hello world" * 100)
    st.close_keep_underlying()
    assert out.getvalue()[4] & 0x20


# ---------------------------------------------------------------------------
# the command line's dictionary options
# ---------------------------------------------------------------------------

def test_dictionary_cli_roundtrip(rng, tmp_path, capsys):
    """compress -D (and --dict-id) and decompress -D round-trip, with the
    JAX writer's bytes."""
    dictionary = random_bytes(rng, 30_000, 256)
    data = dictionary[:25_000] + dictionary[5_000:25_000]
    raw, dfile = tmp_path / "in.bin", tmp_path / "dict.bin"
    comp, back = tmp_path / "out.lz4", tmp_path / "back.bin"
    raw.write_bytes(data)
    dfile.write_bytes(dictionary)
    assert cli_main(["compress", "-D", str(dfile), "--dict-id", "11",
                     str(raw), str(comp)], device=CPU) == 0
    fr = comp.read_bytes()
    assert len(fr) < len(data) // 3
    assert fr == jframe.compress_frame(
        data, block_size=jframe.BlockSize.SIZE_64KB,
        features=(jframe.FrameFlag.BLOCK_INDEPENDENCE,
                  jframe.FrameFlag.CONTENT_CHECKSUM),
        dictionary=dictionary, dict_id=11)
    assert cli_main(["decompress", "-D", str(dfile), str(comp), str(back)],
                    device=CPU) == 0
    assert back.read_bytes() == data
    assert cli_main(["decompress", str(comp), str(back)], device=CPU) == 1
    capsys.readouterr()


@needs_liblz4
def test_dictionary_cli_reads_upstream(rng, tmp_path, capsys):
    dictionary = random_bytes(rng, 30_000, 64)
    data = dictionary + dictionary[:10_000]
    fr = _upstream_dict_frame(data, dictionary, 0, dict_id=3)
    src, dfile, dst = (tmp_path / "in.lz4", tmp_path / "dict.bin",
                       tmp_path / "out.bin")
    src.write_bytes(fr)
    dfile.write_bytes(dictionary)
    assert cli_main(["decompress", "-D", str(dfile), "--allow-dependent",
                     str(src), str(dst)], device=CPU) == 0
    assert dst.read_bytes() == data
    capsys.readouterr()


@pytest.mark.parametrize("argv, message", [
    (["--dict-id", "5"], "--dict-id requires -D"),
    (["-D", "{dict}", "-l", "9"], "-D supports the default fast level only"),
])
def test_cli_dictionary_refusals(tmp_path, argv, message):
    raw, dfile = tmp_path / "in.bin", tmp_path / "dict.bin"
    raw.write_bytes(b"hello" * 100)
    dfile.write_bytes(b"hello")
    argv = [a.replace("{dict}", str(dfile)) for a in argv]
    with pytest.raises(SystemExit, match=message):
        cli_main(["compress", *argv, str(raw), str(tmp_path / "o.lz4")],
                 device=CPU)
