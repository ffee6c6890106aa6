"""The ``read`` pipeline: the LZ4 blocks of a frame that set-up wrote with
the configuration's codec, safe-decoded on the card; the batch is done
when each block's verdict (decoded without error) is on the host.

Set-up compresses each ring slot's raw blocks with the program, as the
write pipeline does, and keeps the blocks that the frame stores compressed
(those that compressing made smaller); a block stored raw needs no decode,
and the read leaves it out. The rate counts the bytes the batch decodes.

The check, once the window has closed:

- ``setup_rows``: of ``check.rows.read`` (slot, row) pairs drawn from the
  seed, every block of the slots counted, the set-up rows that are not the
  reference codec's bytes or that the reference's safe decoder does not
  turn back into the raw block;
- ``decoded``: every block of the held batches whose decoded bytes, length
  or error code are not its raw block's;
- ``verdicts``: every block of every batch of the window not verified;
- ``missing``: held batches that did not complete in the window.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import check, layers, reference


class Pipeline:
    names = ("missing", "setup_rows", "decoded", "verdicts")

    def __init__(self, port, config: dict, ring, span):
        self.port, self.config, self.ring, self.span = port, config, ring, span
        self.L = L = config["block_bytes"]
        self.pinned = ring.lens.device.type == "cuda"
        cap = reference.max_compressed_length(L)
        self.setup, self.rows, self.comp, self.comp_lens = [], [], [], []
        for src in ring.src:
            dest, comp_lens, err = port.compress(src, ring.lens, cap)
            stored = (err == 0) & (comp_lens >= 0) & (comp_lens < L)
            rows = torch.nonzero(stored).flatten()
            self.setup.append((dest, comp_lens))
            self.rows.append(rows.cpu().numpy())
            self.comp.append(dest.index_select(0, rows))
            self.comp_lens.append(comp_lens.index_select(0, rows).contiguous())

    def batch_bytes(self, slot: int) -> int:
        return len(self.rows[slot]) * self.L

    def submit(self, slot: int) -> dict:
        p, span = self.port, self.span
        with span("decompress_safe_batch"):
            out, out_lens, err = p.decode(self.comp[slot],
                                          self.comp_lens[slot], self.L)
        with span("verdict"):
            verdict = torch.empty(err.shape, dtype=torch.bool,
                                  pin_memory=self.pinned)
            verdict.copy_(err == 0, non_blocking=True)
        return {"out": out, "out_lens": out_lens, "err": err,
                "verdict": verdict}

    @staticmethod
    def finish(out: dict) -> np.ndarray:
        return out["verdict"].numpy().copy()

    def slot_bytes(self, out: dict, slot: int) -> layers.SlotBytes:
        comp = self.comp_lens[slot].to(torch.int64)
        return layers.SlotBytes(comp.shape[0], self.L, int(comp.sum()))

    @staticmethod
    def to_host(out: dict) -> dict:
        return {k: out[k].cpu().numpy() for k in ("out", "out_lens", "err")}

    def judge(self, raw_rows, held: list, done: list, rng: np.random.Generator,
              n_workers: int) -> check.Verdict:
        """``raw_rows(slot)``: the ring's raw rows (uint8[N, W]); ``held``:
        each held batch as host arrays with its ``index`` and ``slot`` (None
        where it did not complete in the window); ``done``: the records of
        every batch of the window."""
        cfg, L = self.config, self.L
        v = check.Verdict(self.names)
        v.count("missing", sum(1 for h in held if h is None))
        n = int(self.ring.lens.shape[0])
        pairs = [(s, r) for s in range(len(self.setup)) for r in range(n)]
        pick = rng.choice(len(pairs), size=min(cfg["check"]["rows"]["read"],
                                               len(pairs)), replace=False)
        tasks, where = [], []
        for slot, row in sorted(pairs[i] for i in pick):
            dest, comp_lens = self.setup[slot]
            clen = int(comp_lens[row].clamp(0, dest.shape[1]))
            tasks.append((cfg["codec"], cfg, raw_rows(slot)[row, :L].tobytes(),
                          dest[row, :clen].cpu().numpy().tobytes(), L, True))
            where.append((-1 - slot, row))
        ok = check.all_agree(check.compressed_as_stated, tasks, n_workers,
                             [check.slowness(t[2]) for t in tasks])
        v.add("setup_rows", [w for w, good in zip(where, ok) if not good])
        for h in held:
            if h is None:
                continue
            rows = self.rows[h["slot"]]
            want = raw_rows(h["slot"])[rows, :L]
            bad = (~(h["out"][:, :L] == want).all(1) | (h["out_lens"] != L)
                   | (h["err"] != 0))
            v.add("decoded", [(h["index"], int(rows[i]))
                              for i in np.flatnonzero(bad)])
        for rec in done:
            v.add("verdicts", [(rec.index, int(self.rows[rec.slot][i]))
                               for i in np.flatnonzero(~rec.verdict)])
        return v
