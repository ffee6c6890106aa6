"""The block axis over ``torch.distributed``.

Counterpart of ``lz4_tpu/dist/mesh.py``. LZ4's only axis of parallelism is
data parallelism over independent blocks (frame blocks are independent by
format, ``BLOCK_INDEPENDENCE``), so the mesh is 1-D: axis ``"blocks"`` over
the ranks of a process group. JAX held several devices in one process;
``torch.distributed`` runs one process a rank, with one device each, so a
:class:`BlockMesh` is one rank's view of the axis: its rank, the world
size, the process group and its own device. Rank r owns the contiguous
block range of :meth:`BlockMesh.block_range`, so results put together in
rank order are in global block order.

Without a process group the world is one rank, and the ``dist`` functions
run on the caller's device with no exchange. Nothing here starts a
process group; ``dist/multihost.py::initialize`` does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.device import resolve_device

BLOCK_AXIS = "blocks"


def block_range(n_blocks: int, rank: int, world_size: int) -> tuple[int, int]:
    """[start, end) of the blocks rank ``rank`` of ``world_size`` owns:
    contiguous runs of ``ceil(n_blocks / world_size)`` blocks, so the last
    ranks' runs may be short or empty (``multihost.py:40-51``)."""
    per = -(-n_blocks // world_size)
    start = min(rank * per, n_blocks)
    return start, min(start + per, n_blocks)


@dataclasses.dataclass(frozen=True)
class BlockMesh:
    """One rank's view of the block axis."""
    rank: int
    world_size: int
    group: object | None        # the ProcessGroup; None for one process
    device: torch.device        # this rank's device

    @property
    def backend(self) -> str | None:
        """The group's backend (``"nccl"``, ``"gloo"``), or None."""
        return None if self.group is None else dist.get_backend(self.group)

    def block_range(self, n_blocks: int) -> tuple[int, int]:
        """[start, end) of the blocks this rank owns."""
        return block_range(n_blocks, self.rank, self.world_size)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def device_count() -> int:
    """Devices on the block axis: one a rank of the default process group,
    1 without one."""
    return dist.get_world_size() if _initialized() else 1


def block_mesh(device: str | torch.device = "cuda",
               group=None) -> BlockMesh:
    """This rank's view of the axis over ``group`` (default: the default
    process group, if one was started), on ``device``.

    ``device="cuda"`` names the current card (the one
    ``multihost.initialize`` set); raises when it names a card and there
    is none, or when the group is NCCL and the device is not a card.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if group is None and _initialized():
        group = dist.group.WORLD
    if group is None:
        return BlockMesh(0, 1, None, dev)
    mesh = BlockMesh(dist.get_rank(group), dist.get_world_size(group), group,
                     dev)
    if mesh.backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group needs a card, not {dev}")
    return mesh
