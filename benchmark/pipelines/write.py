"""The ``write`` pipeline: a batch of raw blocks compressed by the
configuration's codec and packed on the card into the body of an LZ4 frame
of independent blocks; the host holds the body's size.

The check, once the window has closed, over the batches held in it:

- ``errors``: blocks with an error code, or a length outside their row;
- ``body``: blocks whose part of the body is not the frame body of the raw
  block and the program's compressed row (a size word and the compressed
  bytes, or the raw bytes with the high bit set where compressing did not
  make the block smaller);
- ``decoded``: blocks of the body, walked as a frame reader walks it, that
  the reference's safe decoder (or, stored raw, the payload itself) does not
  turn back into the raw block, in every block of ``check.decoded_batches``
  held batches drawn from the seed;
- ``rows``: of ``check.rows.write`` (held batch, row) pairs drawn from the
  seed, the compressed rows that are not the reference codec's bytes;
- ``missing``: held batches that did not complete in the window.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import check, layers, reference


class Pipeline:
    names = ("missing", "errors", "body", "decoded", "rows")

    def __init__(self, port, config: dict, ring, span):
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
        with span("frame_body_packed"):
            body, total = p.frame_body(src, lens, dest, comp_lens)
        return {"dest": dest, "comp_lens": comp_lens, "err": err,
                "body": body, "total": total}

    @staticmethod
    def finish(out: dict) -> None:
        return None

    def slot_bytes(self, out: dict, slot: int) -> layers.SlotBytes:
        comp = out["comp_lens"].to(torch.int64)
        payload = torch.minimum(comp, torch.full_like(comp, self.L))
        return layers.SlotBytes(comp.shape[0], self.L, int(comp.sum()),
                                int(payload.sum()), int(out["total"]))

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
        v = check.Verdict(self.names)
        v.count("missing", sum(1 for h in held if h is None))
        present = [h for h in held if h is not None]
        for h in present:
            b, rows = h["index"], raw_rows(h["slot"])
            clens = h["comp_lens"].astype(np.int64)
            v.add("errors", [(b, int(i)) for i in np.flatnonzero(
                (h["err"] != 0) | (clens < 0) | (clens > h["dest"].shape[1]))])
            if h["total"] != h["body"].size:
                v.count("body", 1)
            v.add("body", [(b, i) for i in body_mismatches(
                rows, L, h["dest"], np.clip(clens, 0, h["dest"].shape[1]),
                h["body"])])

        n_dec = min(cfg["check"]["decoded_batches"], len(present))
        tasks, where = [], []
        for k in sorted(rng.choice(len(present), size=n_dec, replace=False)):
            h = present[k]
            b, rows = h["index"], raw_rows(h["slot"])
            try:
                blocks = reference.read_frame_body(h["body"].tobytes())
            except reference.MalformedBlock:
                blocks = []
            n = rows.shape[0]
            v.add("decoded", [(b, i) for i in range(len(blocks), n)])
            for i, (stored_raw, payload) in enumerate(blocks[:n]):
                raw = rows[i, :L].tobytes()
                if stored_raw:
                    if payload != raw:
                        v.add("decoded", [(b, i)])
                else:
                    tasks.append((payload, raw, L))
                    where.append((b, i))
        ok = check.all_agree(check.decodes_to, tasks, n_workers,
                             [check.slowness(t[1]) for t in tasks])
        v.add("decoded", [w for w, good in zip(where, ok) if not good])

        pairs = [(k, r) for k in range(len(present))
                 for r in range(present[k]["dest"].shape[0])]
        pick = rng.choice(len(pairs), size=min(cfg["check"]["rows"]["write"],
                                               len(pairs)), replace=False)
        tasks, where = [], []
        for k, row in (pairs[i] for i in pick):
            h = present[k]
            clen = int(np.clip(h["comp_lens"][row], 0, h["dest"].shape[1]))
            tasks.append((cfg["codec"], cfg, raw_rows(h["slot"])[row, :L].tobytes(),
                          h["dest"][row, :clen].tobytes(), L, False))
            where.append((h["index"], row))
        ok = check.all_agree(check.compressed_as_stated, tasks, n_workers,
                             [check.slowness(t[2]) for t in tasks])
        v.add("rows", [w for w, good in zip(where, ok) if not good])
        return v


def body_mismatches(raw: np.ndarray, block_bytes: int, comp: np.ndarray,
                    comp_lens: np.ndarray, body: np.ndarray) -> list[int]:
    """Blocks whose part of ``body`` is not the reference frame body of the
    raw blocks and the program's compressed rows."""
    got = body.tobytes()
    bad, at = [], 0
    for i in range(raw.shape[0]):
        seg = reference.frame_body([raw[i, :block_bytes].tobytes()],
                                   [comp[i, :comp_lens[i]].tobytes()])
        if got[at:at + len(seg)] != seg:
            bad.append(i)
        at += len(seg)
    if len(got) != at and not bad:
        bad.append(raw.shape[0] - 1)
    return bad
