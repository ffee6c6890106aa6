"""The port's slice as a whole (``lz4_tpu_torch.dist.sharded``, ``entry``)
against the JAX package: the roundtrip step of ``sharded_roundtrip_step``
on a one-device mesh, the packed frame body, and whole frames against
``lz4_tpu.formats.frame``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4_tpu.core.constants import max_compressed_length
from lz4_tpu.dist import block_mesh
from lz4_tpu.dist import sharded as jax_sharded
from lz4_tpu.formats.frame import (
    BlockSize, FrameFlag, compress_frame, decompress_frame)
from lz4_tpu.kernels import jax_codec
from lz4_tpu_torch import (
    compress_frame_packed, entry, roundtrip_step, xxh32_batch)
from lz4_tpu_torch.dist import sharded
from lz4_tpu_torch.entry import example_blocks
from lz4_tpu_torch.kernels import codec, layout


def _jax_step(data: np.ndarray, mesh):
    """The step body of ``sharded_roundtrip_step`` (sharded.py:392-406) on
    the given blocks."""
    n, block_len = data.shape
    arr, lens = jax_codec.to_device_layout([r.tobytes() for r in data],
                                           block_len)
    comp, comp_lens, cerr = jax_sharded._compress_sharded(
        arr, lens, max_compressed_length(block_len), mesh)
    offsets = jax_sharded.pack_offsets(comp_lens)
    hashes = jax_sharded._xxh32_sharded(jnp.asarray(arr).astype(jnp.uint8),
                                        lens, 0, mesh)
    out, out_lens, derr = jax_sharded._decompress_sharded(
        comp, comp_lens, block_len, mesh)
    body, total = jax_sharded._frame_body_packed(arr, lens, comp, comp_lens,
                                                 block_len)
    ok = ((cerr == 0) & (derr == 0) & (out_lens == lens)
          & jnp.all(out[:, :block_len] == arr[:, :block_len], axis=1))
    return (np.asarray(ok), int(comp_lens.sum()), np.asarray(offsets),
            np.asarray(hashes), np.asarray(body)[:int(total)].tobytes())


def test_roundtrip_step_matches_jax_step():
    st = roundtrip_step(8, 1024, seed=3, device="cpu")
    ok, total, offsets, hashes, body = _jax_step(
        sharded.make_blocks(8, 1024, 3), block_mesh(1))
    assert ok.all() and bool(st.ok.all())
    assert st.compressed_total == total
    assert st.offsets.tolist() == offsets.tolist()
    assert st.hashes.tolist() == hashes.tolist()
    assert st.body[:st.body_total].numpy().tobytes() == body
    assert st.phase_ms == {}


def test_make_blocks_kinds():
    data = sharded.make_blocks(8, 4096, 0)
    assert data.shape == (8, 4096) and data.dtype == np.uint8
    assert (data.max(1) < 4).sum() == 4             # half alphabet-4
    comp = codec.compress_fast_batch(
        *sharded.upload_blocks(data, torch.device("cpu")),
        max_compressed_length(4096))[1]
    assert (comp >= 4096).sum() == 2                # a quarter incompressible
    np.testing.assert_array_equal(data, sharded.make_blocks(8, 4096, 0))
    kinds = sharded.block_kinds(8, 0)
    assert ((data.max(1) < 4) == (kinds == 0)).all()
    assert ((comp >= 4096) == torch.from_numpy(kinds == 2)).all()


def test_frame_body_packed_matches_jax_in_chunks(monkeypatch):
    """Empty (padding) blocks, raw and compressed blocks, packed in several
    chunks, against the JAX packer."""
    rng = np.random.default_rng(2)
    blocks = [rng.integers(0, 4, 700, dtype=np.uint8).tobytes(), b"",
              rng.integers(0, 256, 500, dtype=np.uint8).tobytes(),
              bytes(900), b"", b"xyz"]
    src, lens = layout.to_device_layout(blocks, 900, device="cpu")
    comp, comp_lens, err = codec.compress_fast_batch(
        src, lens, max_compressed_length(900))
    arr, jlens = layout.to_jax_layout(src, lens, jax_codec.PAD)
    jcomp, jcomp_lens = layout.to_jax_layout(comp, comp_lens, jax_codec.PAD)
    body, total = jax_sharded._frame_body_packed(arr, jlens, jcomp,
                                                 jcomp_lens, 900)
    want = np.asarray(body)[:int(total)].tobytes()
    monkeypatch.setattr(sharded, "_PACK_CHUNK", 300)
    got, got_total = sharded.frame_body_packed(src, lens, comp, comp_lens)
    assert got_total == int(total) and got.numpy().tobytes() == want
    assert sharded.pack_offsets(comp_lens).tolist() == \
        np.asarray(jax_sharded.pack_offsets(comp_lens.numpy())).tolist()


@pytest.mark.parametrize("size, checksum", [(200_000, True), (200_000, False),
                                            (0, True), (65536, True)])
def test_compress_frame_packed_is_byte_identical(size, checksum):
    data = sharded.make_blocks(4, 65536, 7).tobytes()[:size]
    features = (FrameFlag.BLOCK_INDEPENDENCE,) + (
        (FrameFlag.CONTENT_CHECKSUM,) if checksum else ())
    frame = compress_frame_packed(data, 65536, checksum, device="cpu")
    assert frame == compress_frame(data, BlockSize.SIZE_64KB, features)
    assert decompress_frame(frame) == data


def test_entry_decodes_example_blocks():
    fn, (comp, comp_lens) = entry(device="cpu")
    out, out_lens, err = fn(comp, comp_lens)
    assert not err.any()
    assert layout.from_device_layout(out, out_lens) == example_blocks()


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: entry(),
             lambda: roundtrip_step(1, 64),
             lambda: compress_frame_packed(b"abc"),
             lambda: layout.to_device_layout([b"abc"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(ValueError):
        roundtrip_step(1, 64, device="meta")
    t, n = layout.to_device_layout([b"abc"], device="cpu")
    assert xxh32_batch(t, n).device.type == "cpu"     # CPU tensors stay
