"""The ``lz4block_read`` pipeline: a whole LZ4Block stream that set-up wrote
with the program and holds on the card, read on the card: its headers
walked (``block_stream_index``), every block decoded or copied into its
row and its check compared (``decompress_block_stream_batch``); the batch
is done when each record's verdict (read without fault) is on the host.

Set-up compresses each ring slot's raw blocks with the configuration's
codec and writes them as one stream (``block_stream_body_packed``), as the
write pipeline does; it keeps the stream and the compressed lengths. The
rate counts every block of the batch, as the reader returns and checks
every one.

The check, once the window has closed:

- ``setup_stream``: blocks of the set-up streams, read by the reference
  reader with ``LZ4BlockInputStream``'s checks, whose header is not what
  the reference writer writes (the level, the original length, stored raw
  exactly where compressing did not make the block smaller, the
  compressed length, the check: XXH32 of the raw block with the
  configuration's seed and mask) or whose raw payload is not the raw
  block; a stream that breaks a rule or ends otherwise than in its end
  block counts its unread blocks; and of ``check.rows.lz4block_read``
  (slot, row) pairs drawn from the seed, the blocks that are not what the
  writer stores with the reference codec;
- ``decoded``: every block of the held batches whose decoded bytes,
  length or code are not its raw block's (the end block's record: code
  OK, no bytes);
- ``verdicts``: every record of every batch of the window not verified;
- ``missing``: held batches that did not complete in the window.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import check, lz4block_layers, lz4block_port, reference
from benchmark import reference_lz4block as ref


class Pipeline:
    names = ("missing", "setup_stream", "decoded", "verdicts")

    def __init__(self, port, config: dict, ring, span):
        self.calls = lz4block_port.of(port)
        self.port, self.config, self.ring, self.span = port, config, ring, span
        self.L = L = config["block_bytes"]
        self.n = int(ring.lens.shape[0])
        self.pinned = ring.lens.device.type == "cuda"
        cap = reference.max_compressed_length(L)
        self.streams, self.comp_lens, self.sizes = [], [], []
        for src in ring.src:
            dest, comp_lens, err = port.compress(src, ring.lens, cap)
            stream, total = self.calls.body(src, ring.lens, dest, comp_lens, L)
            comp = comp_lens.to(torch.int64)
            full = torch.full_like(comp, L)
            self.streams.append((stream, total))
            self.comp_lens.append(comp_lens.cpu().numpy())
            self.sizes.append(lz4block_layers.StreamBytes(
                self.n, L, int(comp.sum()),
                int(torch.minimum(comp, full).sum()), total,
                int(torch.where(comp < full, comp, 0).sum()), self.n + 1))
            del dest, err

    def batch_bytes(self, slot: int) -> int:
        return self.n * self.L

    def submit(self, slot: int) -> dict:
        span = self.span
        stream, total = self.streams[slot]
        with span(lz4block_port.INDEX):
            index = self.calls.index(stream, total, self.n + 1)
        with span(lz4block_port.DECODE):
            out, out_lens, err = self.calls.decode(stream, index, self.L)
        with span("verdict"):
            verdict = torch.empty(err.shape, dtype=torch.bool,
                                  pin_memory=self.pinned)
            verdict.copy_(err == 0, non_blocking=True)
        return {"out": out, "out_lens": out_lens, "err": err,
                "verdict": verdict}

    @staticmethod
    def finish(out: dict) -> np.ndarray:
        return out["verdict"].numpy().copy()

    def slot_bytes(self, out: dict, slot: int) -> lz4block_layers.StreamBytes:
        return self.sizes[slot]

    @staticmethod
    def to_host(out: dict) -> dict:
        return {k: out[k].cpu().numpy() for k in ("out", "out_lens", "err")}

    def judge(self, raw_rows, held: list, done: list, rng: np.random.Generator,
              n_workers: int) -> check.Verdict:
        """``raw_rows(slot)``: the ring's raw rows (uint8[N, W]); ``held``:
        each held batch as host arrays with its ``index`` and ``slot`` (None
        where it did not complete in the window); ``done``: the records of
        every batch of the window."""
        cfg, L, n = self.config, self.L, self.n
        level = ref.level_of(L)
        v = check.Verdict(self.names)
        v.count("missing", sum(1 for h in held if h is None))
        read = []
        for slot, (stream, total) in enumerate(self.streams):
            rows = raw_rows(slot)
            sums = (ref.xxh32_rows(rows, L, cfg["checksum_seed"])
                    & np.uint32(cfg["checksum_mask"]))
            try:
                blocks, end_level = ref.read_stream(
                    stream[:total].cpu().numpy().tobytes())
            except ref.MalformedStream:
                blocks, end_level = [], level
            read.append(blocks)
            v.add("setup_stream", [(-1 - slot, i)
                                   for i in range(len(blocks), n)])
            if end_level != level:
                v.add("setup_stream", [(-1 - slot, n - 1)])
            stored = self.comp_lens[slot]
            for i, blk in enumerate(blocks[:n]):
                raw_stored = stored[i] >= L
                if (ref.block_fault(blk, rows[i, :L].tobytes(), int(sums[i]),
                                    level)
                        or (blk.method == ref.METHOD_RAW) != raw_stored
                        or (not raw_stored and blk.comp_len != stored[i])):
                    v.add("setup_stream", [(-1 - slot, i)])

        pairs = [(s, r) for s in range(len(read)) for r in range(
            min(n, len(read[s])))]
        pick = rng.choice(len(pairs), size=min(
            cfg["check"]["rows"]["lz4block_read"], len(pairs)), replace=False)
        tasks, where = [], []
        for slot, row in sorted(pairs[i] for i in pick):
            blk = read[slot][row]
            tasks.append((cfg["codec"], cfg, raw_rows(slot)[row, :L].tobytes(),
                          blk.method, blk.payload))
            where.append((-1 - slot, row))
        ok = check.all_agree(ref.stored_as_stated, tasks, n_workers,
                             [check.slowness(t[2]) for t in tasks])
        v.add("setup_stream", [w for w, good in zip(where, ok) if not good])

        for h in held:
            if h is None:
                continue
            want = raw_rows(h["slot"])[:, :L]
            bad = (~(h["out"][:n, :L] == want).all(1) | (h["out_lens"][:n] != L)
                   | (h["err"][:n] != 0))
            v.add("decoded", [(h["index"], int(i)) for i in np.flatnonzero(bad)])
            if h["err"][n] != 0 or h["out_lens"][n] != 0:
                v.add("decoded", [(h["index"], n)])
        for rec in done:
            v.add("verdicts", [(rec.index, int(i))
                               for i in np.flatnonzero(~rec.verdict)])
        return v
