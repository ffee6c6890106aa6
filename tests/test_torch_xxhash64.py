"""The port's batched XXH64 (``lz4_tpu_torch.kernels.xxhash``) against the
JAX package's ``xxh64_batch``, its Pallas tile kernel in interpret mode and
the host reference, on the same seeded inputs, compared exactly. On the CPU
``xxh64_batch`` runs its plain version; ``test_torch_card.py`` holds the K4
kernel against it on the card."""

import numpy as np
import pytest
import torch

from lz4_tpu.core.xxhash_ref import xxh64
from lz4_tpu.kernels.u64_emul import to_python_ints
from lz4_tpu.kernels.xxhash64_pallas import xxh64_words_pallas
from lz4_tpu.kernels.xxhash_jax import xxh64_batch as jax_xxh64_batch
from lz4_tpu.kernels.xxhash_pallas import to_tile_layout_np
from lz4_tpu_torch.core import xxhash_ref as port_ref
from lz4_tpu_torch.kernels import layout, xxhash

LENGTHS = list(range(0, 101)) + [1000, 4096]
SEEDS = [0, (1 << 64) - 1, 0xCAFEBABE12345678]


def _ragged(seed):
    rng = np.random.default_rng(seed)
    blocks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in LENGTHS]
    return blocks, layout.to_device_layout(blocks, device="cpu")


def _u64(h: torch.Tensor) -> list[int]:
    return [v & 0xFFFFFFFFFFFFFFFF for v in h.tolist()]


@pytest.mark.parametrize("seed", SEEDS)
def test_xxh64_matches_jax_batch_and_reference(seed):
    blocks, (data, lens) = _ragged(seed & 0xFFFF)
    got = xxhash.xxh64_batch(data, lens, seed)
    assert got.dtype == torch.int64 and got.shape == (len(blocks),)
    ref = to_python_ints(jax_xxh64_batch(data.numpy(), lens.numpy(), seed))
    assert _u64(got) == ref
    assert _u64(got) == [xxh64(b, 0, len(b), seed) for b in blocks]
    assert torch.equal(got, xxhash.xxh64_plain(data, lens, seed))


@pytest.mark.parametrize("width", [64, 256])
def test_xxh64_matches_pallas_interpret(width):
    """Mirrors test_jax_kernels.py::test_xxh64_pallas_interpret_matches_
    reference: 1024 uniform rows, the tile kernel in interpret mode."""
    rng = np.random.default_rng(width)
    data = rng.integers(0, 256, (1024, width), dtype=np.uint8)
    seed = 0xCAFEBABE12345678
    hi, lo = xxh64_words_pallas(to_tile_layout_np(data), width, seed,
                                interpret=True)
    got = xxhash.xxh64_batch(torch.from_numpy(data.copy()),
                             torch.full((1024,), width, dtype=torch.int32),
                             seed)
    ghi, glo = xxhash.split_u64(got)
    assert ghi.tolist() == np.asarray(hi).tolist()
    assert glo.tolist() == np.asarray(lo).tolist()


def test_xxh64_masks_the_seed_to_64_bits():
    _, (data, lens) = _ragged(3)
    assert torch.equal(xxhash.xxh64_batch(data, lens, -1),
                       xxhash.xxh64_batch(data, lens, (1 << 64) - 1))
    assert torch.equal(xxhash.xxh64_batch(data, lens, (1 << 64) + 5),
                       xxhash.xxh64_batch(data, lens, 5))


def test_xxh64_ignores_bytes_past_length():
    _, (data, lens) = _ragged(5)
    noisy = data.clone()
    for i, n in enumerate(lens.tolist()):
        noisy[i, n:] = 0xEE
    assert torch.equal(xxhash.xxh64_batch(noisy, lens, 3),
                       xxhash.xxh64_batch(data, lens, 3))


def test_xxh64_odd_row_width_and_empty_batch():
    """Rows whose width is no multiple of 4 or 16 (the plain version pads
    them) and a batch of no rows."""
    rng = np.random.default_rng(6)
    data = torch.from_numpy(rng.integers(0, 256, (5, 37), dtype=np.uint8))
    lens = torch.tensor([0, 3, 36, 37, 8], dtype=torch.int32)
    got = xxhash.xxh64_batch(data, lens, 9)
    want = [xxh64(data[i].numpy().tobytes(), 0, n, 9)
            for i, n in enumerate(lens.tolist())]
    assert _u64(got) == want
    empty = xxhash.xxh64_batch(torch.zeros((0, 16), dtype=torch.uint8),
                               torch.zeros((0,), dtype=torch.int32))
    assert empty.shape == (0,) and empty.dtype == torch.int64


@pytest.mark.parametrize("value", [0, 1, 0x7FFFFFFFFFFFFFFF,
                                   0x8000000000000000, (1 << 64) - 1,
                                   0xCAFEBABE12345678, 0x00000001FFFFFFFF])
def test_split_join_round_trip(value):
    hi, lo = value >> 32, value & 0xFFFFFFFF
    joined = xxhash.join_u64(torch.tensor([hi], dtype=torch.int64),
                             torch.tensor([lo], dtype=torch.int64))
    assert _u64(joined) == [value]
    shi, slo = xxhash.split_u64(joined)
    assert shi.dtype == slo.dtype == torch.uint32
    assert (shi.tolist(), slo.tolist()) == ([hi], [lo])
    # JAX's uint32 pair, carried as numpy, joins to the same bit pattern
    jhi = torch.from_numpy(np.array([hi], np.uint32))
    jlo = torch.from_numpy(np.array([lo], np.uint32))
    assert torch.equal(xxhash.join_u64(jhi, jlo), joined)


@pytest.mark.parametrize("seed", SEEDS)
def test_port_host_reference_matches_jax_package(seed):
    """The port's own host copy (``core/xxhash_ref.py``) against the JAX
    package's, one-shot and streaming."""
    from lz4_tpu.core import xxhash_ref as jax_ref
    blocks, _ = _ragged(seed & 0xFF)
    for b in blocks[::7] + blocks[-2:]:
        assert port_ref.xxh64(b, 0, len(b), seed) == \
            jax_ref.xxh64(b, 0, len(b), seed)
        assert port_ref.xxh32(b, 0, len(b), seed & 0xFFFFFFFF) == \
            jax_ref.xxh32(b, 0, len(b), seed & 0xFFFFFFFF)
    big = blocks[-1]
    s = port_ref.StreamingXXH64(seed)
    for off in range(0, len(big), 333):
        s.update(big, off, min(333, len(big) - off))
    assert s.get_value() == jax_ref.xxh64(big, 0, len(big), seed)
