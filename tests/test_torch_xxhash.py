"""The port's batched XXH32 (``lz4_tpu_torch.kernels.xxhash``) against the
JAX package's ``xxh32_batch`` and its Pallas tile kernel in interpret mode,
on the same seeded inputs, compared exactly."""

import numpy as np
import pytest
import torch

from lz4_tpu.core.xxhash_ref import xxh32
from lz4_tpu.kernels.xxhash_jax import xxh32_batch as jax_xxh32_batch
from lz4_tpu.kernels.xxhash_pallas import xxh32_uniform_pallas
from lz4_tpu_torch.formats.frame import xxh32_bytes
from lz4_tpu_torch.kernels import layout, xxhash

LENGTHS = list(range(0, 70)) + [100, 127, 128, 1000, 4099]


def _ragged(seed):
    rng = np.random.default_rng(seed)
    blocks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in LENGTHS]
    return blocks, layout.to_device_layout(blocks, device="cpu")


@pytest.mark.parametrize("seed", [0, 0xFFFFFFFF, 0x9747B28C])
def test_xxh32_matches_jax_batch(seed):
    blocks, (data, lens) = _ragged(seed & 0xFFFF)
    got = xxhash.xxh32_batch(data, lens, seed)
    assert got.dtype == torch.uint32 and got.shape == (len(blocks),)
    ref = np.asarray(jax_xxh32_batch(data.numpy(), lens.numpy(), seed))
    assert got.tolist() == ref.tolist()
    assert got.tolist() == [xxh32(b, 0, len(b), seed) for b in blocks]


def test_xxh32_matches_pallas_uniform_interpret():
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (1024, 32), dtype=np.uint8)
    ref = np.asarray(xxh32_uniform_pallas(data, 7, interpret=True))
    t = torch.from_numpy(data.copy())
    got = xxhash.xxh32_batch(t, torch.full((1024,), 32, dtype=torch.int32), 7)
    assert got.tolist() == ref.tolist()


def test_host_hash_matches_reference():
    blocks, _ = _ragged(4)
    for seed in (0, 0xFFFFFFFF):
        assert [xxh32_bytes(b, seed) for b in blocks] == \
            [xxh32(b, 0, len(b), seed) for b in blocks]


def test_xxh32_ignores_bytes_past_length():
    blocks, (data, lens) = _ragged(5)
    noisy = data.clone()
    for i, n in enumerate(lens.tolist()):
        noisy[i, n:] = 0xEE
    assert torch.equal(xxhash.xxh32_batch(noisy, lens, 3),
                       xxhash.xxh32_batch(data, lens, 3))
