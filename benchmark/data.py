"""The data every cell compresses: the three-kind block mix, made on the
device from the run's seed.

A frozen copy, for the benchmark, of the mix of
``lz4_tpu_torch/dist/sharded.py::make_blocks`` that every number of the
port's ``PERF.md`` was taken on, drawn by ``torch.Generator`` on the card in
a few large calls in place of NumPy on the host:

- half alphabet-4 blocks: each byte one of 0..3;
- a quarter text: phrases of a vocabulary of 512 words of 4 to 47 printable
  bytes, with about one byte in 64 replaced by a random byte;
- the rest incompressible random bytes, which a frame stores raw.

The kinds are spread over a batch by a seeded permutation. The same seed
gives the same bytes on the same kind of device; every operation here is
deterministic (no scatter with repeated indices).
"""

from __future__ import annotations

import torch

VOCAB_WORDS = 512
WORD_MIN, WORD_MAX = 4, 48          # lengths drawn from [4, 48)
MUTATE_ONE_IN = 64
# text rows made at once: the position tables take 24 bytes a byte of them
TEXT_CHUNK = 256

A4, TEXT, RANDOM = 0, 1, 2


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any integer; taken
    modulo 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 64)
    return g


def kind_counts(n: int) -> tuple[int, int, int]:
    """Alphabet-4, text and random blocks in a batch of ``n``."""
    n_a4, n_text = n // 2, n // 4
    return n_a4, n_text, n - n_a4 - n_text


def _text_rows(n: int, block_len: int, g: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """``n`` rows of phrases of one vocabulary, about one byte in 64
    replaced."""
    word_len = torch.randint(WORD_MIN, WORD_MAX, (VOCAB_WORDS,), generator=g,
                             device=device)
    vocab = torch.randint(32, 127, (VOCAB_WORDS, WORD_MAX), generator=g,
                          device=device, dtype=torch.uint8)
    n_words = block_len // WORD_MIN + 1
    rows = torch.empty((n, block_len), dtype=torch.uint8, device=device)
    pos = torch.arange(block_len, device=device)
    for r0 in range(0, n, TEXT_CHUNK):
        r = min(TEXT_CHUNK, n - r0)
        ids = torch.randint(0, VOCAB_WORDS, (r, n_words), generator=g,
                            device=device)
        lens = word_len[ids]
        ends = torch.cumsum(lens, 1)
        at = torch.searchsorted(ends, pos.expand(r, block_len).contiguous(),
                                right=True)
        start = ends.gather(1, at) - lens.gather(1, at)
        text = vocab[ids.gather(1, at), pos - start]
        hit = torch.randint(0, MUTATE_ONE_IN, (r, block_len), generator=g,
                            device=device) == 0
        noise = torch.randint(0, 256, (r, block_len), generator=g,
                              device=device, dtype=torch.uint8)
        rows[r0:r0 + r] = torch.where(hit, noise, text)
    return rows


def make_batch(n: int, block_len: int, stride: int, g: torch.Generator,
               device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` blocks of ``block_len`` bytes in rows of ``stride`` bytes
    (``uint8[n, stride]``, the bytes past a block zero), and each block's
    kind (``int8[n]``)."""
    n_a4, n_text, n_rand = kind_counts(n)
    kinds = torch.empty((n,), dtype=torch.int8, device=device)
    order = torch.randperm(n, generator=g, device=device)
    a4, text, rand = order[:n_a4], order[n_a4:n_a4 + n_text], order[n_a4 + n_text:]
    kinds[a4], kinds[text], kinds[rand] = A4, TEXT, RANDOM
    out = torch.zeros((n, stride), dtype=torch.uint8, device=device)
    out[a4, :block_len] = torch.randint(0, 4, (n_a4, block_len), generator=g,
                                        device=device, dtype=torch.uint8)
    out[rand, :block_len] = torch.randint(0, 256, (n_rand, block_len),
                                          generator=g, device=device,
                                          dtype=torch.uint8)
    if n_text:
        out[text, :block_len] = _text_rows(n_text, block_len, g, device)
    return out, kinds
