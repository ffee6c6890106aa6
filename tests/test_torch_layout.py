"""The port's batch layout (``lz4_tpu_torch.kernels.layout``) and its
independence from the JAX package."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from lz4_tpu.kernels import jax_codec
from lz4_tpu_torch.kernels import layout

REPO = pathlib.Path(__file__).resolve().parent.parent


def _blocks(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (0, 1, 15, 16, 17, 100, 1000)]


@pytest.mark.parametrize("cap", [None, 1000, 1023])
def test_layout_round_trip(cap):
    blocks = _blocks()
    t, lens = layout.to_device_layout(blocks, cap, device="cpu")
    assert t.dtype == torch.uint8 and lens.dtype == torch.int32
    assert t.shape == (len(blocks), layout.row_stride(cap or 1000))
    assert t.shape[1] % 16 == 0 and t.shape[1] >= (cap or 1000) + layout.PAD
    assert lens.tolist() == [len(b) for b in blocks]
    assert layout.from_device_layout(t, lens) == blocks
    for i, b in enumerate(blocks):      # bytes past a block's length are 0
        assert not t[i, len(b):].any()


def test_layout_rejects_bad_batches():
    blocks = _blocks()
    with pytest.raises(ValueError):
        layout.to_device_layout(blocks, 10, device="cpu")
    t, lens = layout.to_device_layout(blocks, device="cpu")
    layout.check_batch(t, lens)
    with pytest.raises(ValueError):
        layout.check_batch(t, lens.to(torch.int64))
    with pytest.raises(ValueError):
        layout.check_batch(t.to(torch.int32), lens)
    bad = lens.clone()
    bad[0] = t.shape[1] + 1
    with pytest.raises(ValueError):
        layout.check_batch(t, bad)
    bad[0] = -1
    with pytest.raises(ValueError):
        layout.check_batch(t, bad)


@pytest.mark.parametrize("jax_pad", [jax_codec.PAD, 256])
def test_jax_layout_carry_across(jax_pad):
    blocks = _blocks(1)
    cap = 1008
    arr, lens = jax_codec.to_device_layout(blocks, cap)
    t, tl = layout.from_jax_layout(arr, lens)
    assert layout.from_device_layout(t, tl) == blocks
    assert t.shape[1] % 16 == 0
    back, back_lens = layout.to_jax_layout(*layout.to_device_layout(
        blocks, cap, device="cpu"), jax_pad)
    assert back.dtype == np.int32 and back.shape == (len(blocks), cap + jax_pad)
    if jax_pad == jax_codec.PAD:
        np.testing.assert_array_equal(back, arr)
    assert back_lens.tolist() == lens.tolist()
    assert jax_codec.from_device_layout(back, back_lens) == blocks
    with pytest.raises(ValueError):
        layout.from_jax_layout(arr + 256, lens)


def _port_files():
    files = sorted((REPO / "lz4_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_source_imports_neither_jax_nor_lz4_tpu():
    offenders = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "lz4_tpu"):
                    offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert len(_port_files()) > 10
    assert offenders == []


def test_import_leaves_jax_and_lz4_tpu_unloaded():
    code = ("import sys, lz4_tpu_torch, lz4_tpu_torch.testing, chip_smoke, "
            "lz4_tpu_torch.api.cuda_instances, lz4_tpu_torch.core.lz4_hc_ref, "
            "lz4_tpu_torch.core.xxhash_ref; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lz4_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
