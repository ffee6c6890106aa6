"""The port's ``dist`` (``lz4_tpu_torch.dist``) against the JAX package's on
the virtual CPU mesh (``lz4_tpu.dist.block_mesh(4)``): one process, and 2
and 4 worker processes over gloo (``dryrun_multigpu(device="cpu")``), on
the plain versions. Mirrors ``tests/test_dist.py`` and the recovery cases
of ``tests/test_aux.py``."""

import io
import struct

import numpy as np
import pytest
import torch

from lz4_tpu import dist as jdist
from lz4_tpu.api.factory import Lz4Factory as JaxLz4Factory
from lz4_tpu.core.lz4_block_ref import (
    compress_fast_alloc, decompress_safe_alloc)
from lz4_tpu.core.lz4_hc_ref import compress_hc_alloc
from lz4_tpu.core.xxhash_ref import xxh32, xxh64
from lz4_tpu.dist.sharded import shard_xxh64 as jax_shard_xxh64
from lz4_tpu.formats.frame import (
    BlockSize, FrameFlag, compress_frame, decompress_frame)
from lz4_tpu_torch import dist, dryrun_multigpu
from lz4_tpu_torch.core.errors import Lz4Error
from lz4_tpu_torch.dist import mesh as mesh_mod, multihost, sharded
from lz4_tpu_torch.kernels.xxhash import join_u64
from lz4_tpu_torch.streams import compress_stream, decompress_stream
from lz4_tpu_torch.streams.pipeline import BatchEngine, get_engine

from conftest import random_bytes

CPU = torch.device("cpu")
FEATURES = (FrameFlag.BLOCK_INDEPENDENCE, FrameFlag.CONTENT_CHECKSUM)
WORKER_TIMEOUT = 120.0


@pytest.fixture(scope="module")
def jmesh():
    return jdist.block_mesh(4)


@pytest.fixture
def mesh():
    return dist.block_mesh(CPU)


def _ref_frame(data, compressor=None):
    return compress_frame(data, block_size=BlockSize.SIZE_64KB,
                          features=FEATURES, compressor=compressor)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def test_mesh_of_one_process(mesh):
    assert dist.device_count() == 1
    assert (mesh.rank, mesh.world_size, mesh.group, mesh.backend) == (
        0, 1, None, None)
    assert mesh.device == CPU
    assert dist.process_block_range(10) == (0, 10)


@pytest.mark.parametrize("n, p, ranges", [
    (5, 4, [(0, 2), (2, 4), (4, 5), (5, 5)]),
    (1, 4, [(0, 1), (1, 1), (1, 1), (1, 1)]),
    (13, 8, [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12), (12, 13),
             (13, 13)]),
    (0, 2, [(0, 0), (0, 0)]),
])
def test_block_ranges_are_the_jax_ranges(n, p, ranges):
    """Contiguous runs of ceil(n / p) blocks, as ``multihost.py:40-51``."""
    assert [mesh_mod.block_range(n, r, p) for r in range(p)] == ranges


def test_shard_compress_byte_parity(mesh, jmesh, rng):
    blocks = [random_bytes(rng, rng.randrange(50, 1500), 8) for _ in range(13)]
    comp = dist.shard_compress_blocks(blocks, mesh)
    assert comp == [compress_fast_alloc(b) for b in blocks]
    assert comp == jdist.shard_compress_blocks(blocks, jmesh)


def test_shard_roundtrip_unaligned_block_count(mesh, jmesh, rng):
    blocks = [random_bytes(rng, 700, 4) for _ in range(13)]
    comp = dist.shard_compress_blocks(blocks, mesh)
    assert dist.shard_decompress_blocks(comp, 700, mesh) == blocks
    assert jdist.shard_decompress_blocks(comp, 700, jmesh) == blocks


def test_shard_decompress_refuses_a_bad_block(mesh, rng):
    blocks = [random_bytes(rng, 700, 4) for _ in range(3)]
    comp = dist.shard_compress_blocks(blocks, mesh)
    with pytest.raises(Lz4Error):
        dist.shard_decompress_blocks(comp, 600, mesh)


def test_sharded_frame_is_standard(mesh, jmesh, rng):
    data = random_bytes(rng, 250000, 16)
    frame = dist.compress_frame_sharded(data, 1 << 16, mesh)
    assert frame == jdist.compress_frame_sharded(data, 1 << 16, jmesh)
    assert frame == _ref_frame(data)
    assert decompress_frame(frame) == data


@pytest.mark.parametrize("size", [1, 100, 65536, 65537, 250000])
def test_packed_frame_byte_exact(mesh, jmesh, rng, size):
    data = random_bytes(rng, size, 16)
    got = dist.compress_frame_sharded_packed(data, 1 << 16, mesh)
    assert got == _ref_frame(data)
    assert got == jdist.compress_frame_sharded_packed(data, 1 << 16, jmesh)
    assert got == sharded.compress_frame_packed(data, 1 << 16, True, CPU)
    assert decompress_frame(got) == data


def test_packed_frame_incompressible_blocks(mesh, jmesh, rng):
    data = random_bytes(rng, 3 * 65536 + 77, 256)
    got = dist.compress_frame_sharded_packed(data, 1 << 16, mesh)
    assert got == _ref_frame(data)
    assert got == jdist.compress_frame_sharded_packed(data, 1 << 16, jmesh)


def test_pack_offsets_is_exclusive_scan():
    lens = torch.tensor([5, 3, 9, 1], dtype=torch.int32)
    assert dist.pack_offsets(lens).tolist() == [0, 5, 8, 17]
    assert np.asarray(jdist.pack_offsets(lens.numpy())).tolist() == [0, 5, 8,
                                                                      17]


def _step_reference(n_blocks, block_len, seed=0):
    """Offsets, hashes and packed body of ``make_blocks`` by the JAX
    package's host codec, hash and frame rule."""
    data = sharded.make_blocks(n_blocks, block_len, seed)
    raws = [row.tobytes() for row in data]
    comps = [compress_fast_alloc(r) for r in raws]
    lens = [len(c) for c in comps]
    body = b"".join(
        struct.pack("<I", len(r) | 0x80000000) + r if len(c) >= len(r)
        else struct.pack("<I", len(c)) + c for r, c in zip(raws, comps))
    return (np.cumsum([0] + lens[:-1]).tolist(), sum(lens),
            [xxh32(r, 0, len(r), 0) for r in raws], body)


def test_sharded_roundtrip_step(mesh):
    st = dist.sharded_roundtrip_step(mesh, n_blocks_per_dev=2, block_len=256)
    offsets, total, hashes, body = _step_reference(2, 256)
    assert bool(st.ok.all()) and st.ok.numel() == 2
    assert st.block_range == (0, 2)
    assert st.compressed_total == total
    assert st.offsets.tolist() == offsets
    assert st.hashes.tolist() == hashes
    assert st.body.numpy().tobytes() == body and st.body_total == len(body)
    assert st.phase_ms == {}


def test_sharded_step_matches_one_device_step(mesh):
    st = dist.sharded_roundtrip_step(mesh, 3, 1000, seed=5)
    one = sharded.roundtrip_step(3, 1000, seed=5, device="cpu")
    assert torch.equal(st.ok, one.ok) and torch.equal(st.hashes, one.hashes)
    assert torch.equal(st.offsets, one.offsets)
    assert torch.equal(st.body, one.body[:one.body_total])


def _ragged_rows(rng):
    data = np.frombuffer(random_bytes(rng, 16 * 96, 256),
                         np.uint8).reshape(16, 96)
    lens = np.array([96, 95, 64, 33, 32, 31, 8, 7, 4, 3, 1, 0,
                     96, 50, 17, 96], np.int32)
    return data, lens


def test_shard_xxh64_matches_reference(mesh, jmesh, rng):
    seed = 0x0123456789ABCDEF
    data, lens = _ragged_rows(rng)
    hi, lo = dist.sharded.shard_xxh64(data, lens, seed, mesh)
    got = [h & (2 ** 64 - 1) for h in join_u64(hi, lo).tolist()]
    assert got == [xxh64(data[i].tobytes(), 0, int(lens[i]), seed)
                   for i in range(16)]
    jhi, jlo = jax_shard_xxh64(data, lens, seed, jmesh)
    assert hi.tolist() == np.asarray(jhi).tolist()
    assert lo.tolist() == np.asarray(jlo).tolist()


def test_shard_xxh32_matches_reference(mesh, jmesh, rng):
    seed = 0x9E3779B1
    data, lens = _ragged_rows(rng)
    got = dist.shard_xxh32(torch.from_numpy(data.copy()), lens, seed, mesh)
    assert got.dtype == torch.uint32
    assert got.tolist() == [xxh32(data[i].tobytes(), 0, int(lens[i]), seed)
                            for i in range(16)]
    assert got.tolist() == np.asarray(
        jdist.shard_xxh32(data, lens, seed, jmesh)).tolist()


@pytest.mark.parametrize("level", [1, 9, 17])
def test_sharded_hc_byte_parity(mesh, rng, level):
    blocks = [random_bytes(rng, rng.randrange(100, 900), 6) for _ in range(8)]
    comp = dist.shard_compress_blocks(blocks, mesh, level=level)
    assert comp == [bytes(compress_hc_alloc(b, level)) for b in blocks]


def test_sharded_hc_frames_byte_exact(mesh, rng):
    data = random_bytes(rng, 3000, 5)
    expect = _ref_frame(data, JaxLz4Factory.safe_instance().high_compressor(9))
    assert dist.compress_frame_sharded(data, 1 << 16, mesh, level=9) == expect
    assert dist.compress_frame_sharded_packed(data, 1 << 16, mesh,
                                              level=9) == expect
    with pytest.raises(ValueError):
        dist.shard_compress_blocks([data], mesh, level=18)


def test_multihost_single_process(mesh, rng):
    blocks = [random_bytes(rng, 500, 8) for _ in range(5)]
    comp = dist.compress_blocks_multihost(blocks, mesh)
    assert comp == [compress_fast_alloc(b) for b in blocks]
    data = random_bytes(rng, 70000, 8)
    assert multihost.compress_frame_multihost(data, 1 << 16,
                                              mesh) == _ref_frame(data)
    dist.initialize_multihost("file:///nonexistent", 1, 0)   # nothing at 1


# ---------------------------------------------------------------------------
# several processes over gloo
# ---------------------------------------------------------------------------

def _dryrun(n, data_bytes, tmp_path, step=(2, 256)):
    return dryrun_multigpu(n, "cpu", data_bytes=data_bytes,
                           blocks_per_rank=step[0], block_len=step[1],
                           timeout=WORKER_TIMEOUT, workdir=tmp_path)


@pytest.mark.parametrize("n, data_bytes", [
    (2, 3 * 65536 + 1234),      # 4 blocks, 2 a rank
    (4, 4 * 65536 + 1234),      # 5 blocks: [0,2),[2,4),[4,5),[5,5)
    (4, 1000),                  # fewer blocks than ranks
    (2, 0),                     # empty input
])
def test_ranks_give_the_one_process_frames(n, data_bytes, jmesh, tmp_path):
    """Every rank's frames are identical (``dryrun`` checks) and equal the
    host writer's, the JAX packed frame on a 4-device mesh and the host HC
    writer's; the step's results equal one process's on the same blocks."""
    out = _dryrun(n, data_bytes, tmp_path)
    data = multihost.dryrun_data(data_bytes)
    expect = _ref_frame(data)
    assert out["frame"] == expect and out["packed_frame"] == expect
    assert expect == jdist.compress_frame_sharded_packed(data, 1 << 16, jmesh)
    assert decompress_frame(out["frame"]) == data
    assert out["hc_frame"] == _ref_frame(
        data[:multihost.HC_BYTES],
        JaxLz4Factory.safe_instance().high_compressor(9))
    assert out["xxh64"] == [xxh64(data, i, min(65536, len(data) - i), 0)
                            for i in range(0, len(data), 65536)]
    one = multihost.run_job(dist.block_mesh(CPU),
                            {"data_bytes": 0, "step": [2 * n, 256]})
    assert out["step"] == one["step"] and out["step"]["ok"]
    assert out["block_range"] == [(2 * r, 2 * r + 2) for r in range(n)]


def test_dryrun_multihost_returns_the_frames(tmp_path):
    frame, hc_frame = multihost.dryrun_multihost(
        2, 65536 + 5, device="cpu", timeout=WORKER_TIMEOUT, workdir=tmp_path)
    data = multihost.dryrun_data(65536 + 5)
    assert frame == _ref_frame(data)
    assert decompress_frame(hc_frame) == data[:multihost.HC_BYTES]


def test_failing_worker_raises_with_its_output(tmp_path):
    with pytest.raises(RuntimeError, match="ValueError"):
        multihost.run_ranks(2, {"data_bytes": -1}, "cpu",
                            timeout=WORKER_TIMEOUT, workdir=tmp_path)


def test_ranks_need_a_card_each_unless_they_share(monkeypatch):
    with pytest.raises(RuntimeError):
        dryrun_multigpu(2)              # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="share_card"):
        multihost._placement(2, "cuda", False)
    assert multihost._placement(2, "cuda", True) == (["cuda:0"] * 2, "gloo")
    assert multihost._placement(1, "cuda", False) == (["cuda:0"], "nccl")
    assert multihost._placement(3, "cpu", False) == (["cpu"] * 3, "gloo")


# ---------------------------------------------------------------------------
# recovery and the sharded engine
# ---------------------------------------------------------------------------

def test_recovery_clean_path(rng):
    blocks = [random_bytes(rng, 800, 8) for _ in range(4)]
    comp, retried = dist.compress_blocks_verified(
        blocks, engine=get_engine("cuda", device=CPU))
    assert retried == []
    assert comp == [compress_fast_alloc(b) for b in blocks]


def _flaky_engine():
    good = get_engine("cuda", device=CPU)

    def flaky_compress(blocks):
        out = good.compress_batch(blocks)
        out[1] = out[1][:-2] + b"\x00\x00"      # corrupt block 1
        return out

    return BatchEngine("flaky", flaky_compress, good.decompress_batch, CPU)


def test_recovery_retries_bad_engine(rng):
    """Verification catches the corrupted block and the ``cuda`` tier
    compresses exactly that block again (``test_aux.py:36-52``)."""
    blocks = [random_bytes(rng, 700, 8) for _ in range(3)]
    comp, retried = dist.compress_blocks_verified(blocks,
                                                  engine=_flaky_engine())
    assert retried == [1]
    for raw, c in zip(blocks, comp):
        assert decompress_safe_alloc(c, len(raw)) == raw


def test_recovery_raises_when_retries_run_out(rng):
    blocks = [random_bytes(rng, 700, 8) for _ in range(3)]
    with pytest.raises(dist.BlockVerificationError) as info:
        dist.compress_blocks_verified(blocks, engine=_flaky_engine(),
                                      max_retries=0)
    assert info.value.indices == [1]


@pytest.mark.parametrize("level", [0, 9])
def test_sharded_engine_writes_the_cuda_frame(rng, level):
    data = random_bytes(rng, 3 * 65536 + 999 if not level else 5000, 8)
    frames = {}
    for name in ("cuda", "sharded"):
        sink = io.BytesIO()
        compress_stream(io.BytesIO(data), sink, engine=name, level=level,
                        batch_blocks=2, device=CPU)
        frames[name] = sink.getvalue()
    assert frames["sharded"] == frames["cuda"]
    back = io.BytesIO()
    decompress_stream(io.BytesIO(frames["sharded"]), back, engine="sharded",
                      batch_blocks=2, device=CPU)
    assert back.getvalue() == data
    engine = get_engine("sharded", level, CPU)
    assert engine.name == ("sharded-hc9" if level else "sharded")
    assert engine.compress_packed is None and engine.decompress_packed is None


def test_cli_takes_the_sharded_engine(tmp_path, rng):
    from lz4_tpu_torch.__main__ import main

    src = tmp_path / "in.bin"
    src.write_bytes(random_bytes(rng, 70000, 8))
    assert main(["compress", str(src), str(tmp_path / "out.lz4"),
                 "--engine", "sharded"], device=CPU) in (0, None)
    assert main(["decompress", str(tmp_path / "out.lz4"),
                 str(tmp_path / "back.bin"), "--engine", "sharded"],
                device=CPU) in (0, None)
    assert (tmp_path / "back.bin").read_bytes() == src.read_bytes()
