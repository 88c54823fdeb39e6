"""Device meshes for the sharded engines and sharded training.

Counterpart of ``repro/launch/mesh.py`` (``make_production_mesh``,
``make_mesh``, ``data_axes``, ``make_data_mesh``). A :class:`DeviceMesh`
names the axes and gives one ``torch.device`` per mesh position, in
row-major order. Positions may share a device: on a machine with one card
every shard of a mesh runs on ``cuda:0``, one after another on the
caller's stream.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import torch

ROW_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Named axes over devices.

    ``shape`` maps each axis name to its size, in axis order, as the
    reference's ``Mesh.shape``; ``devices`` holds one device per position,
    row-major over ``axis_names``.
    """

    axis_names: tuple[str, ...]
    shape: Mapping[str, int]
    devices: tuple[torch.device, ...]

    def device(self, **coords: int) -> torch.device:
        """The device at the given coordinates; an axis left out is 0."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh {self.axis_names} has no axis {sorted(unknown)}")
        flat = 0
        for a in self.axis_names:
            c = coords.get(a, 0)
            if not 0 <= c < self.shape[a]:
                raise IndexError(f"{a}={c} outside the axis of size {self.shape[a]}")
            flat = flat * self.shape[a] + c
        return self.devices[flat]

    def along(self, axes: Sequence[str], **fixed: int) -> list[torch.device]:
        """One device per index of the flattened ``axes`` (the first axis
        major), the other axes at ``fixed`` or 0: the devices of the
        shards that ``axes`` split."""
        sizes = [self.shape[a] for a in axes]
        out = []
        for k in range(math.prod(sizes)):
            coords, rest = dict(fixed), k
            for a, n in zip(reversed(axes), reversed(sizes)):
                coords[a], rest = rest % n, rest // n
            out.append(self.device(**coords))
        return out

    def distinct_devices(self) -> list[torch.device]:
        """The mesh's devices, each once, in order of first position."""
        return list(dict.fromkeys(self.devices))


def _cuda_devices(n: int) -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a 'cuda' mesh but no CUDA device is available; pass device='cpu' to "
            "put every position on the CPU")
    return [torch.device("cuda", k % torch.cuda.device_count()) for k in range(n)]


def make_production_mesh(*, multi_pod: bool = False,
                         devices: str | torch.device | Sequence | None = None) -> DeviceMesh:
    """The reference's production layouts: ``(16, 16)`` over ``("data",
    "model")`` (256 positions), or ``(2, 16, 16)`` over ``("pod", "data",
    "model")`` (512), placed as :func:`make_mesh` places them."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=devices)


def make_mesh(
    shape: Sequence[int],
    axes: Sequence[str],
    *,
    devices: str | torch.device | Sequence | None = None,
) -> DeviceMesh:
    """A mesh of ``shape`` over ``axes``.

    ``devices``: None or ``"cuda"`` puts position ``k`` on
    ``cuda:{k % device_count}`` and raises without a card; ``"cpu"`` puts
    every position on the CPU; a sequence gives one device per position.
    """
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} do not pair up")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an empty axis")
    n = math.prod(shape)
    if devices is None or (isinstance(devices, (str, torch.device))
                           and torch.device(devices).type == "cuda"):
        devs = _cuda_devices(n)
    elif isinstance(devices, (str, torch.device)):
        dev = torch.device(devices)
        if dev.type != "cpu":
            raise ValueError(f"devices must be 'cuda' or 'cpu', got {devices!r}")
        devs = [dev] * n
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices for a mesh of {n} positions")
    return DeviceMesh(axis_names=axes, shape=dict(zip(axes, shape)), devices=tuple(devs))


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Axes that shard the rows: ('pod', 'data') where a pod axis exists."""
    return tuple(a for a in ROW_AXES if a in mesh.axis_names)


def make_data_mesh(n_shards: int | None = None, *, device: str = "cuda") -> DeviceMesh:
    """1-D ``('data',)`` mesh for the row-parallel engine: each position is
    one Piper instance. Shard ``k`` goes on ``cuda:{k % device_count}``;
    ``n_shards`` defaults to one a card (one on the CPU)."""
    if n_shards is None:
        n_shards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
        n_shards = max(n_shards, 1)
    return make_mesh((n_shards,), ("data",), devices=device)
