"""The ``lz4block_write`` pipeline: a batch of raw blocks compressed by the
configuration's codec and written on the card as one LZ4Block stream
(``block_stream_body_packed``: each block's 21-byte header with its check,
its payload, then the end block); the host holds the stream's size.

The check, once the window has closed, over the batches held in it:

- ``errors``: blocks with an error code, or a length outside their row;
- ``stream``: blocks whose part of the stream is not what the reference
  writer (``reference_lz4block.py``) writes of the raw block and the
  program's compressed row (the header: method, level, lengths and the
  check, XXH32 of the raw block with the configuration's seed and mask;
  the payload), the end block, and the stream's size;
- ``decoded``: blocks of the stream, read by the reference reader with
  ``LZ4BlockInputStream``'s checks, whose payload does not give back the
  raw block (decoded by the reference, consuming exactly the compressed
  length) or whose check is not the raw block's, in every block of
  ``check.decoded_batches`` held batches drawn from the seed;
- ``rows``: of ``check.rows.lz4block_write`` (held batch, row) pairs drawn
  from the seed, the compressed rows that are not the reference codec's
  bytes;
- ``missing``: held batches that did not complete in the window.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import check, lz4block_layers, lz4block_port, reference
from benchmark import reference_lz4block as ref


class Pipeline:
    names = ("missing", "errors", "stream", "decoded", "rows")

    def __init__(self, port, config: dict, ring, span):
        self.calls = lz4block_port.of(port)
        self.port, self.config, self.ring, self.span = port, config, ring, span
        self.L = config["block_bytes"]
        self.cap = reference.max_compressed_length(self.L)

    def batch_bytes(self, slot: int) -> int:
        return int(self.ring.lens.shape[0]) * self.L

    def submit(self, slot: int) -> dict:
        p, span = self.port, self.span
        src, lens = self.ring.src[slot], self.ring.lens
        with span(p.compress_name):
            dest, comp_lens, err = p.compress(src, lens, self.cap)
        with span(lz4block_port.PACK):
            body, total = self.calls.body(src, lens, dest, comp_lens, self.L)
        return {"dest": dest, "comp_lens": comp_lens, "err": err,
                "body": body, "total": total}

    @staticmethod
    def finish(out: dict) -> None:
        return None

    def slot_bytes(self, out: dict, slot: int) -> lz4block_layers.StreamBytes:
        comp = out["comp_lens"].to(torch.int64)
        full = torch.full_like(comp, self.L)
        lz4 = torch.where(comp < full, comp, torch.zeros_like(comp))
        return lz4block_layers.StreamBytes(
            comp.shape[0], self.L, int(comp.sum()),
            int(torch.minimum(comp, full).sum()), int(out["total"]),
            int(lz4.sum()), comp.shape[0] + 1)

    @staticmethod
    def to_host(out: dict) -> dict:
        return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in out.items()}

    def judge(self, raw_rows, held: list, done: list, rng: np.random.Generator,
              n_workers: int) -> check.Verdict:
        """``raw_rows(slot)``: the ring's raw rows (uint8[N, W]); ``held``:
        each held batch as host arrays with its ``index`` and ``slot`` (None
        where it did not complete in the window)."""
        cfg, L = self.config, self.L
        level = ref.level_of(L)
        v = check.Verdict(self.names)
        v.count("missing", sum(1 for h in held if h is None))
        present = [h for h in held if h is not None]
        checks = {}

        def checks_of(slot):
            if slot not in checks:
                checks[slot] = (ref.xxh32_rows(raw_rows(slot), L,
                                               cfg["checksum_seed"])
                                & np.uint32(cfg["checksum_mask"]))
            return checks[slot]

        for h in present:
            b, rows = h["index"], raw_rows(h["slot"])
            clens = h["comp_lens"].astype(np.int64)
            v.add("errors", [(b, int(i)) for i in np.flatnonzero(
                (h["err"] != 0) | (clens < 0) | (clens > h["dest"].shape[1]))])
            if h["total"] != h["body"].size:
                v.count("stream", 1)
            v.add("stream", [(b, i) for i in stream_mismatches(
                rows, L, h["dest"], np.clip(clens, 0, h["dest"].shape[1]),
                checks_of(h["slot"]), level, h["body"])])

        n_dec = min(cfg["check"]["decoded_batches"], len(present))
        tasks, where = [], []
        for k in sorted(rng.choice(len(present), size=n_dec, replace=False)):
            h = present[k]
            b, rows = h["index"], raw_rows(h["slot"])
            try:
                blocks, _ = ref.read_stream(h["body"].tobytes())
            except ref.MalformedStream:
                blocks = []
            n = rows.shape[0]
            v.add("decoded", [(b, i) for i in range(len(blocks), n)])
            sums = checks_of(h["slot"])
            for i, blk in enumerate(blocks[:n]):
                raw = rows[i, :L].tobytes()
                if ref.block_fault(blk, raw, int(sums[i]), level):
                    v.add("decoded", [(b, i)])
                elif blk.method == ref.METHOD_LZ4:
                    tasks.append((blk.payload, raw, blk.orig_len))
                    where.append((b, i))
        ok = check.all_agree(check.decodes_to, tasks, n_workers,
                             [check.slowness(t[1]) for t in tasks])
        v.add("decoded", [w for w, good in zip(where, ok) if not good])

        pairs = [(k, r) for k in range(len(present))
                 for r in range(present[k]["dest"].shape[0])]
        pick = rng.choice(len(pairs), size=min(
            cfg["check"]["rows"]["lz4block_write"], len(pairs)), replace=False)
        tasks, where = [], []
        for k, row in (pairs[i] for i in pick):
            h = present[k]
            clen = int(np.clip(h["comp_lens"][row], 0, h["dest"].shape[1]))
            tasks.append((cfg["codec"], cfg,
                          raw_rows(h["slot"])[row, :L].tobytes(),
                          h["dest"][row, :clen].tobytes(), L, False))
            where.append((h["index"], row))
        ok = check.all_agree(check.compressed_as_stated, tasks, n_workers,
                             [check.slowness(t[2]) for t in tasks])
        v.add("rows", [w for w, good in zip(where, ok) if not good])
        return v


def stream_mismatches(raw: np.ndarray, block_bytes: int, comp: np.ndarray,
                      comp_lens: np.ndarray, checks: np.ndarray, level: int,
                      body: np.ndarray) -> list[int]:
    """Blocks whose part of ``body`` is not the reference writer's block
    of the raw block and the program's compressed row; the last block
    where the end block or the stream's size is not the writer's."""
    got = body.tobytes()
    bad, at = [], 0
    for i in range(raw.shape[0]):
        seg = ref.write_block(raw[i, :block_bytes].tobytes(),
                              comp[i, :comp_lens[i]].tobytes(), level,
                              int(checks[i]))
        if got[at:at + len(seg)] != seg:
            bad.append(i)
        at += len(seg)
    if got[at:] != ref.end_block(level) and raw.shape[0] - 1 not in bad:
        bad.append(raw.shape[0] - 1)
    return bad
