"""What the comparison that decides ``correct`` shares between the pipelines:
the numbers compared with their limits, and the plain reference's slow row
work in worker processes.

Every number compared counts blocks found wrong; each has the limit 0, as
an exact comparison has. The reference reads the program's outputs only to
judge them, and works out again from the generated blocks whatever the
program derived from them. It runs once the window has closed, on the host.
Each pipeline (``pipelines/<name>.py``) says what its cells compare.

This module imports NumPy and the reference, not torch and nothing of the
program: the harness hands it host arrays, and its workers start fast.
"""

from __future__ import annotations

import concurrent.futures
import importlib
import multiprocessing
import os

from . import reference

LIMIT = 0


def compressed_as_stated(codec: str, config: dict, raw: bytes, comp: bytes,
                         out_max: int, decode: bool) -> bool:
    """Whether ``comp`` is the reference's compression of ``raw`` by the
    codec module ``codecs/<codec>.py`` and, with ``decode``, whether the
    reference decoder restores ``raw`` from it."""
    entry = importlib.import_module(f"benchmark.codecs.{codec}")
    if entry.reference(raw, config) != comp:
        return False
    return not decode or decodes_to(comp, raw, out_max)


def decodes_to(comp: bytes, raw: bytes, out_max: int) -> bool:
    """Whether the reference's safe decoder restores ``raw`` from the LZ4
    block ``comp`` of at most ``out_max`` bytes."""
    try:
        return reference.decompress_safe(comp, out_max) == raw
    except reference.MalformedBlock:
        return False


def workers() -> int:
    """Reference workers: the host's cores less one for the harness."""
    return max(1, min(8, (os.cpu_count() or 2) - 1))


def all_agree(fn, tasks: list[tuple], n_workers: int,
              slow_first: list[float] | None = None) -> list[bool]:
    """``fn(*task)`` of each task, in worker processes when ``n_workers`` >
    1 (started by ``spawn``, all ended on return); ``slow_first`` weighs
    each task, so that the slowest start first and no worker is left with
    a long tail."""
    if n_workers <= 1 or len(tasks) <= 1:
        return [fn(*t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    order = (sorted(range(len(tasks)), key=lambda i: -slow_first[i])
             if slow_first else range(len(tasks)))
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(n_workers, len(tasks)), mp_context=ctx) as ex:
        futures = {i: ex.submit(fn, *tasks[i]) for i in order}
        return [futures[i].result() for i in range(len(tasks))]


def slowness(raw: bytes) -> float:
    """A row's weight for :func:`all_agree`: rows of few distinct bytes
    (alphabet-4) take the reference longest."""
    return -len(set(raw[:256]))


class Verdict:
    """The numbers compared, each with its limit, and the blocks found
    wrong, as ``(batch, row)``."""

    def __init__(self, names: tuple[str, ...] = ()):
        self.numbers: dict[str, int] = {name: 0 for name in names}
        self.bad: set[tuple[int, int]] = set()

    def add(self, name: str, rows) -> None:
        rows = list(rows)
        self.numbers[name] = self.numbers.get(name, 0) + len(rows)
        self.bad.update(rows)

    def count(self, name: str, value: int) -> None:
        self.numbers[name] = self.numbers.get(name, 0) + value

    @property
    def correct(self) -> bool:
        return all(v <= LIMIT for v in self.numbers.values())

    def compared(self) -> dict:
        return {k: {"value": v, "limit": LIMIT} for k, v in self.numbers.items()}
