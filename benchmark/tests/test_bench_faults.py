"""The check finds a broken timed path: each fault planted under a run of
the harness (its look for a card skipped, on the program's plain versions
on the CPU), and the control, turns ``correct`` false; the sound program
keeps it true."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.system import Port

SEED = 2 ** 31 + 977


class Broken(Port):
    """The port with one fault planted where the answer is produced."""

    def __init__(self, config, fault):
        super().__init__(config)
        self.fault = fault

    def compress(self, src, lens, cap):
        dest, comp_lens, err = super().compress(src, lens, cap)
        n = dest.shape[0]
        if self.fault == "unchanged":      # the output never written
            dest, comp_lens = torch.zeros_like(dest), torch.zeros_like(comp_lens)
        elif self.fault == "half":         # half of the batch left out
            dest[n // 2:] = 0
            comp_lens[n // 2:] = 0
        elif self.fault == "altered":      # a byte of each answer altered
            dest[:, 7] ^= 0x20
        elif self.fault == "one":          # a byte of one answer altered
            dest[n // 3, 9] ^= 0x01
        return dest, comp_lens, err

    def frame_body(self, src, lens, comp, comp_lens):
        body, total = super().frame_body(src, lens, comp, comp_lens)
        if self.fault == "body":
            body[body.numel() // 2] ^= 1
        return body, total

    def decode(self, comp, comp_lens, out_max):
        out, out_lens, err = super().decode(comp, comp_lens, out_max)
        n = out.shape[0]
        if self.fault == "unchanged":
            out, out_lens = torch.zeros_like(out), torch.zeros_like(out_lens)
        elif self.fault == "half":
            out[n // 2:] = 0
        elif self.fault == "altered":
            out[:, 7] ^= 0x20
        return out, out_lens, err


def _run(cell, port, seconds=None):
    # HC's plain version takes a good part of a second a batch here
    if seconds is None:
        seconds = 8.0 if cell.config["codec"] == "lz4_hc" else 4.0
    return harness.run(cell, SEED, seconds, False, torch.device("cpu"),
                       time.perf_counter(), port=port, n_workers=1).result


@pytest.mark.parametrize("name", ["block64k_fast.write", "block64k_fast.read",
                                  "block64k_hc9.write", "block64k_hc9.read"])
def test_the_sound_program_is_correct(tiny_cell, name):
    cell = tiny_cell(name, n=4 if "hc9" in name else 8)
    result = _run(cell, Port(cell.config))
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "body"])
def test_a_write_fault_is_found(tiny_cell, fault):
    cell = tiny_cell("block64k_fast.write")
    result = _run(cell, Broken(cell.config, fault))
    assert not result["correct"]
    assert result["failed"] > 0
    wrong = {k for k, v in result["compared"].items() if v["value"] > 0}
    if fault == "body":
        assert wrong == {"body", "decoded"}, wrong
    else:
        # a wrong compressed row: not the reference's bytes, and its block
        # of the body does not decode back to the raw block
        assert wrong == {"rows", "decoded"}, wrong


def test_one_wrong_block_of_a_batch_is_found(tiny_cell):
    """A block wrong in one row alone, in a row the sample of rows
    compressed again need not hold: the body's every block decoded finds
    it."""
    cell = tiny_cell("block64k_fast.write", n=16)
    cell.config["check"]["rows"]["write"] = 0
    result = _run(cell, Broken(cell.config, "one"))
    assert not result["correct"]
    assert result["compared"]["decoded"]["value"] >= 1


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_read_fault_is_found(tiny_cell, fault):
    cell = tiny_cell("block64k_fast.read")
    result = _run(cell, Broken(cell.config, fault))
    assert not result["correct"]
    assert result["compared"]["decoded"]["value"] > 0
    assert result["compared"]["verdicts"]["value"] > 0


@pytest.mark.parametrize("name", ["block64k_fast.write", "block64k_fast.read",
                                  "block64k_hc9.write", "block64k_hc9.read"])
def test_the_control_is_not_correct(tiny_cell, name):
    """Each configuration's control: the port's parallel compressor in
    place of the fast scan, or HC one level below the stated one. Levels 8
    and 9 first part on
    alphabet-4 rows of 64 KiB, so HC's control runs two full blocks a batch
    (one alphabet-4), one batch in flight, in a window long enough for the
    plain version's batch of about 3 s to complete after the held one is
    submitted."""
    if "hc9" in name:
        cell = tiny_cell(name, block_bytes=65536, n=2, ring_batches=1,
                         held_batches=1, in_flight=1)
        result = _run(cell, Port(cell.config, cell.config["control"]), 24.0)
    else:
        cell = tiny_cell(name)
        result = _run(cell, Port(cell.config, cell.config["control"]), 8.0)
    assert not result["correct"], result["compared"]
    wrong = {k for k, v in result["compared"].items() if v["value"] > 0}
    # valid LZ4, so only the comparison with the stated codec's bytes fails
    assert wrong in ({"rows"}, {"setup_rows"}), wrong


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["block64k_fast.write", "block64k_hc9.read"])
def test_the_control_on_the_card(name):
    """The control on the card at the cell's own widths, with a batch cut
    to what a test run holds: the check finds it, and passes the program
    as stated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy

    from benchmark import cells
    cell = cells.find_cell(cells.load_spec(), name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["batch_blocks"] = {"write": 64, "read": 64}
    cell.config["check"] = {"rows": {"write": 8, "read": 8},
                            "decoded_batches": 1}
    dev = torch.device("cuda", 0)
    for overrides, correct in ((None, True), (cell.config["control"], False)):
        out = harness.run(cell, SEED, 1.0, False, dev, time.perf_counter(),
                          overrides=overrides)
        assert out.result["correct"] is correct, out.result["compared"]
