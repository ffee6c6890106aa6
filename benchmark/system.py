"""The system under test: the calls into ``lz4_tpu_torch`` that a batch
makes, and nothing else of the program.

This module and the codec modules (``codecs/``) are the ones that import
the program. They take from it only the entry points, its batch layout's
row stride and its kernel launch counts. Each call carries the name of the
program's function it calls, which the benchmark's spans take.
"""

from __future__ import annotations

import importlib

import torch


def codec(name: str):
    """The codec module ``codecs/<name>.py``."""
    return importlib.import_module(f"benchmark.codecs.{name}")


class Port:
    """The port's entry points for one configuration: the compressor of its
    ``codec``, the frame body and the safe decode. ``overrides`` replaces
    configuration values (``codec``, ``level``) for a control run."""

    def __init__(self, config: dict, overrides: dict | None = None):
        from lz4_tpu_torch import decompress_safe_batch
        from lz4_tpu_torch.dist import sharded
        from lz4_tpu_torch.kernels import build, layout

        cfg = {**config, **(overrides or {})}
        entry = codec(cfg["codec"])
        self._compress = entry.program(cfg)
        self.compress_name = entry.ENTRY
        self._decode = decompress_safe_batch
        self._sharded = sharded
        self._build = build
        self._layout = layout

    def row_stride(self, block_bytes: int) -> int:
        return self._layout.row_stride(block_bytes)

    def launches(self) -> int:
        """Kernel launches of the program so far (``build.launch_counts``)."""
        return sum(self._build.launch_counts().values())

    def compress(self, src: torch.Tensor, lens: torch.Tensor, cap: int):
        """(dest, comp_lens, err) of the configuration's codec."""
        return self._compress(src, lens, cap)

    def frame_body(self, src, lens, comp, comp_lens):
        """(body, total): ``frame_body_packed``; the host holds ``total``."""
        return self._sharded.frame_body_packed(src, lens, comp, comp_lens)

    def decode(self, comp: torch.Tensor, comp_lens: torch.Tensor,
               out_max: int):
        """(out, out_lens, err): ``decompress_safe_batch``."""
        return self._decode(comp, comp_lens, out_max)
