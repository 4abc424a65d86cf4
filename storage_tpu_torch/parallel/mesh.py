"""Scale-out over the Monte-Carlo paths axis: one process, several devices.

Counterpart of the JAX package's ``parallel/mesh.py``.  There a mesh is a
1-D ``jax.sharding.Mesh(('paths',))`` and XLA shards every ``[.., S]`` array
and inserts the all-reduces.  Here the same single-process, single-controller
design is written out: a :class:`PathsMesh` is an ordered tuple of
``torch.device`` entries, each holding one equal, contiguous shard of the
sims; every per-sim tensor of the engine becomes one tensor per shard on
that shard's device; every reduction over sims is the sum of the per-shard
partials in shard order onto the first shard's device (:func:`sum_shards`);
what is replicated is copied once to each device (:func:`replicate`).
Entries may name the same device: two shards on ``cuda:0`` (or a mesh of
``cpu`` entries) exercise the split on one device.  No ``torch.distributed``:
the simulator draws each shard's window of the one-device path set, so the
shards' paths are the one-device paths' columns bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

PATHS_AXIS = "paths"


class PathsMesh:
    """A 1-D mesh over the ``paths`` axis: ``devices`` in shard order."""

    def __init__(self, devices: Sequence):
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a paths mesh needs at least one device")
        for d in self.devices:
            if d.type == "cuda" and not (torch.cuda.is_available()
                                         and (d.index or 0) < torch.cuda.device_count()):
                raise RuntimeError(f"mesh entry {d}: no such CUDA device "
                                   f"({torch.cuda.device_count()} visible)")

    @property
    def shape(self) -> Dict[str, int]:
        return {PATHS_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"PathsMesh({[str(d) for d in self.devices]})"

    def windows(self, num_sims: int) -> List[Tuple[int, int]]:
        """``(sim0, local)`` of each shard: equal contiguous windows of the
        ``num_sims`` sims, which must divide evenly."""
        n = self.size
        if num_sims % n:
            raise ValueError(f"num_sims ({num_sims}) must be divisible by the number of mesh "
                             f"devices ({n}) so paths shard evenly.")
        local = num_sims // n
        return [(i * local, local) for i in range(n)]


def paths_mesh(devices: Optional[Sequence] = None) -> PathsMesh:
    """A 1-D mesh over the given devices, or over every visible CUDA device.
    Without a CUDA device and without ``devices`` it raises: it never falls
    back to the CPU (a mesh of ``"cpu"`` entries must be asked for)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("paths_mesh() found no CUDA device; pass devices= explicitly "
                               "(e.g. ['cpu'] * 2) to shard on the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    return PathsMesh(devices)


def shard_sims(mesh: PathsMesh, x: torch.Tensor, sims_axis: int) -> List[torch.Tensor]:
    """``x`` split along ``sims_axis`` into the mesh's equal contiguous shards,
    each (contiguous) on its entry's device."""
    return [x.narrow(sims_axis, a, n).to(d).contiguous()
            for (a, n), d in zip(mesh.windows(x.shape[sims_axis]), mesh.devices)]


def replicate(mesh_or_devices, x: torch.Tensor) -> List[torch.Tensor]:
    """One copy of ``x`` for each mesh entry, made once per distinct device
    (entries on the same device share it; on ``x``'s own device it is ``x``)."""
    devices = mesh_or_devices.devices if isinstance(mesh_or_devices, PathsMesh) \
        else mesh_or_devices
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = x.to(d)
    return [copies[d] for d in devices]


def sum_shards(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of per-shard partials in shard order, on the first shard's
    device (one shard: that tensor itself)."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(out.device)
    return out


def sims_mean(parts: Sequence[torch.Tensor], dim: Optional[int] = None) -> torch.Tensor:
    """The mean over the sims of a per-shard tensor, the sims along ``dim``
    (None: every element): one shard's own ``mean``, else the shards' sums
    added in shard order (:func:`sum_shards`) over the whole count."""
    if len(parts) == 1:
        return parts[0].mean() if dim is None else parts[0].mean(dim=dim)
    count = sum(p.numel() if dim is None else p.shape[dim] for p in parts)
    return sum_shards([p.sum() if dim is None else p.sum(dim=dim) for p in parts]) / count
