"""The frozen reference agrees with the program's plain versions, byte for
byte, on the benchmark's own data mix, and walks a frame body back to its
blocks; and the data is made from the seed alone."""

import pytest
import torch

from benchmark import data, reference
from benchmark.reference_hc import compress_hc_block
from lz4_tpu_torch.dist.sharded import frame_body_packed_plain
from lz4_tpu_torch.kernels.codec import compress_fast_plain
from lz4_tpu_torch.kernels.hc import compress_hc_plain
from lz4_tpu_torch.kernels.layout import row_stride


@pytest.fixture(scope="module")
def mix():
    """Eight 4 KiB blocks of the mix and two edge rows, in the port's
    layout."""
    L = 4096
    src, kinds = data.make_batch(8, L, row_stride(L),
                                 data.generator(2 ** 31 + 3, "cpu"), "cpu")
    return src, kinds, L


def test_fast_compress_and_decode(mix):
    src, kinds, L = mix
    cap = reference.max_compressed_length(L)
    lens = torch.full((src.shape[0],), L, dtype=torch.int32)
    dest, clens, err = compress_fast_plain(src, lens, cap)
    for i in range(src.shape[0]):
        raw = src[i, :L].numpy().tobytes()
        c = reference.compress_fast(raw)
        assert c == dest[i, :int(clens[i])].numpy().tobytes(), int(kinds[i])
        assert reference.decompress_safe(c, L) == raw
        with pytest.raises(reference.MalformedBlock):
            reference.decompress_safe(c, L - 1)


@pytest.mark.parametrize("raw", [b"", b"a", b"abcabcabcabcabcabcabc" * 3,
                                 bytes(300), bytes(range(256)) * 2])
def test_edge_blocks_round_trip(raw):
    c = reference.compress_fast(raw)
    assert reference.decompress_safe(c, len(raw)) == raw
    assert reference.decompress_safe(compress_hc_block(raw, 9), len(raw)) == raw


def test_hc_equals_the_programs(mix):
    src, kinds, L = mix
    lens = torch.full((4,), L, dtype=torch.int32)
    dest, clens, _ = compress_hc_plain(src[:4], lens, reference.max_compressed_length(L), 9)
    for i in range(4):
        raw = src[i, :L].numpy().tobytes()
        assert compress_hc_block(raw, 9) == \
            dest[i, :int(clens[i])].numpy().tobytes()


def test_frame_body_equals_the_programs(mix):
    src, _, L = mix
    n = src.shape[0]
    lens = torch.tensor([L, L, 0, 5, L, L, 17, L], dtype=torch.int32)
    cap = reference.max_compressed_length(L)
    dest, clens, _ = compress_fast_plain(src, lens, cap)
    body, total = frame_body_packed_plain(src, lens, dest, clens)
    raws = [src[i, :int(lens[i])].numpy().tobytes() for i in range(n)]
    comps = [dest[i, :int(clens[i])].numpy().tobytes() for i in range(n)]
    ref = reference.frame_body(raws, comps)
    assert len(ref) == total and ref == body.numpy().tobytes()
    # a frame reader walks it back to every non-empty block
    walked = reference.read_frame_body(ref)
    kept = [i for i in range(n) if raws[i]]
    assert len(walked) == len(kept)
    for (stored_raw, payload), i in zip(walked, kept):
        if stored_raw:
            assert payload == raws[i]
        else:
            assert reference.decompress_safe(payload, L) == raws[i]


@pytest.mark.parametrize("body", [b"\x00\x00\x00\x00", b"\x05\x00\x00",
                                  b"\x09\x00\x00\x00abc"])
def test_a_broken_frame_body_is_malformed(body):
    with pytest.raises(reference.MalformedBlock):
        reference.read_frame_body(body)


def test_data_is_the_seeds_alone():
    def make(seed):
        return data.make_batch(16, 1024, 1040, data.generator(seed, "cpu"),
                               "cpu")

    (a, ka), (b, kb), (c, _) = make(2 ** 33 + 1), make(2 ** 33 + 1), make(7)
    assert torch.equal(a, b) and torch.equal(ka, kb)
    assert not torch.equal(a, c)
    assert [int((ka == k).sum()) for k in (0, 1, 2)] == [8, 4, 4]
    assert int(a[ka == data.A4, :1024].max()) < 4
    assert int(a[:, 1024:].abs().sum()) == 0
    text = a[ka == data.TEXT, :1024]
    printable = ((text >= 32) & (text < 127)).float().mean().item()
    assert 0.97 < printable < 1.0       # about one byte in 64 replaced
