"""The benchmark's own tests: ``python3 -m pytest benchmark/tests`` from the
root of a checkout. Tests that need the card carry the ``cuda`` marker and
decide inside the test whether there is one."""

import pathlib
import sys

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skips "
        "without one")


import copy  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def tiny_cell():
    """A cell of ``BENCHMARK.json`` cut to a size the plain versions run in
    seconds on the CPU: ``n`` blocks of ``block_bytes`` a batch, every
    block's row checked."""
    from benchmark import cells

    def make(name: str, block_bytes: int = 4096, n: int = 8, **traffic):
        cell = cells.find_cell(cells.load_spec(), name)
        cell.config = copy.deepcopy(cell.config)
        cell.config["block_bytes"] = block_bytes
        cell.config["batch_blocks"] = {"write": n, "read": n}
        cell.config["check"] = {"rows": {"write": 3 * n, "read": 4 * n},
                                "decoded_batches": 3}
        cell.traffic = {**cell.traffic, **traffic}
        return cell

    return make
