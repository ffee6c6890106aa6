"""Seeded inputs that hold the kernels against their plain versions.

Shared by the CPU tests and ``chip_smoke.py``; every generator takes a
``numpy.random.Generator``.
"""

from __future__ import annotations

import numpy as np

KINDS = ("zeros", "period3", "alphabet4", "incompressible")


def block_of(rng: np.random.Generator, kind: str, size: int) -> bytes:
    if kind == "zeros":
        return bytes(size)
    if kind == "period3":
        return (b"abc" * (size // 3 + 1))[:size]
    if kind == "alphabet4":
        return rng.integers(0, 4, size, dtype=np.uint8).tobytes()
    if kind == "incompressible":
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    raise ValueError(f"unknown kind {kind!r}")


def mixed_blocks(rng: np.random.Generator, sizes) -> list[bytes]:
    """One block of every kind at every size."""
    return [block_of(rng, kind, size) for size in sizes for kind in KINDS]


def fuzz_blocks(rng: np.random.Generator, comp_blocks: list[bytes],
                n: int) -> list[bytes]:
    """``n`` malformed variants of valid compressed blocks: bit flips,
    truncations, overwritten runs, and streams of random tokens."""
    out = []
    sources = [c for c in comp_blocks if c]
    for i in range(n):
        base = bytearray(sources[int(rng.integers(len(sources)))])
        op = i % 4
        if op == 0:
            for _ in range(int(rng.integers(1, 5))):
                pos = int(rng.integers(len(base)))
                base[pos] ^= 1 << int(rng.integers(8))
        elif op == 1:
            base = base[:int(rng.integers(len(base) + 1))]
        elif op == 2:
            pos = int(rng.integers(len(base)))
            run = rng.integers(0, 256, int(rng.integers(1, 9)), dtype=np.uint8)
            base[pos:pos + run.size] = run.tobytes()
        else:
            base = bytearray(rng.integers(
                0, 256, int(rng.integers(1, 65)), dtype=np.uint8).tobytes())
        out.append(bytes(base))
    return out
