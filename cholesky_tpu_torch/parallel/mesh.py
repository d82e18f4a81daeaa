"""A single-process device mesh — the port of `cholesky_tpu/parallel/mesh.py`.

The JAX package is single-controller: one process builds one solver over
a `jax.sharding.Mesh`, and its level arrays carry `NamedSharding`s. The
port keeps that shape. `Mesh` is an array of torch devices that one Python
process drives, shape (ndev,) with the axis ("tree",) or (S, C) with the
axes ("slice", "tree"). A slot may repeat a device: `[cuda:0] * 4` gives
four logical slots on one card (the counterpart of the JAX tests' virtual
CPU devices) and `[cpu] * 8` the CPU test mesh; on a machine with several
cards the slots are distinct cards. JAX's collectives become peer copies
(`tensor.to(device)`), issued round-robin from the one thread, so that
work on distinct cards overlaps.

The elimination tree is the distribution, as in the JAX package. A level's
panel array [2^L, H, W] is

  * slot-sharded when 2^L >= ndev and ndev divides 2^L: slot s holds the
    contiguous blocks [s 2^L / ndev, (s + 1) 2^L / ndev), a closed subtree
    (the children of those blocks are slot s's blocks one level down);
  * split into row groups when 1 < 2^L < ndev and 2^L divides ndev: each of
    the 2^L fronts is held by ndev / 2^L slots, each a contiguous range of
    its rows (`dist_level.py` factors such a level);
  * replicated otherwise. A single process needs no redundant copies, so
    a replicated level is one tensor on the mesh's first device.

`Placement` is the port's `NamedSharding`: its `spec` is the JAX
PartitionSpec the level would carry, and it maps each slot to its batch
range and row range. `Sharded` is the port's sharded `jax.Array`: one
tensor per slot on the slot's device, with the placement; `gather(device)`
returns the whole tensor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

TREE_AXIS = "tree"
DCN_AXIS = "slice"
FB_AXIS = "fb"      # front axis of a row-group level
RG_AXIS = "rg"      # row-group axis (ndev / B slots per front)


def _device(d) -> torch.device:
    """torch.device with an explicit card index ("cuda" -> "cuda:i")."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An immutable, hashable array of torch devices with named axes."""

    __slots__ = ("devices", "axis_names", "_key")

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...],
                 shape: Optional[Tuple[int, ...]] = None):
        flat = [_device(d) for d in devices]
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        arr = arr.reshape(shape or (len(flat),))
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D devices for axes {axis_names}")
        arr.flags.writeable = False
        object.__setattr__(self, "devices", arr)
        object.__setattr__(self, "axis_names", tuple(axis_names))
        object.__setattr__(self, "_key", (tuple(str(d) for d in flat),
                                          arr.shape, tuple(axis_names)))

    def __setattr__(self, name, value):
        raise AttributeError("Mesh is immutable")

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.flat]}, shape="
                f"{self.devices.shape}, axes={self.axis_names})")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def flat(self) -> List[torch.device]:
        """The slots' devices, slice-major."""
        return list(self.devices.reshape(-1))

    @property
    def distinct(self) -> List[torch.device]:
        """The distinct devices, in slot order."""
        out = []
        for d in self.flat:
            if d not in out:
                out.append(d)
        return out

    def slots_on(self, device) -> int:
        """How many slots share `device`."""
        device = _device(device)
        return sum(1 for d in self.flat if d == device)


def _cards() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh ("tree",). `devices` defaults to every CUDA card; an
    explicit list may repeat a device as logical slots. Asking for more
    cards than the machine has raises ValueError naming how many it has
    (the JAX package truncates silently)."""
    if devices is None:
        devices = _cards()
        if n_devices is not None and n_devices > len(devices):
            raise ValueError(f"make_mesh({n_devices}) needs {n_devices} CUDA "
                             f"cards; this machine has {len(devices)}")
        if not devices:
            raise ValueError("make_mesh: this machine has no CUDA card; "
                             "pass devices= (e.g. [torch.device('cpu')] * 8)")
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh({n_devices}) given {len(devices)} "
                             f"devices")
        devices = devices[:n_devices]
    return Mesh(devices, (TREE_AXIS,))


def make_multislice_mesh(n_slices: int, chips_per_slice: Optional[int] = None,
                         devices=None) -> Mesh:
    """2-axis mesh (DCN_AXIS, TREE_AXIS): `n_slices` slices of
    `chips_per_slice` slots each, each slice's slots contiguous in
    `devices` (default: every CUDA card). The slot axis of a level shards
    over both axes slice-major, so contiguous subtree ranges stay inside a
    slice; the collective root maps its 2-D grid onto (tree, slice)
    (`dist_cholesky.distributed_cholesky_2d`). Slices of one process share
    a host: multi-node meshes are outside a single-process mesh."""
    if devices is None:
        devices = _cards()
    devices = list(devices)
    if chips_per_slice is None:
        if len(devices) % n_slices:
            raise ValueError(f"{len(devices)} devices not divisible by "
                             f"{n_slices} slices")
        chips_per_slice = len(devices) // n_slices
    need = n_slices * chips_per_slice
    if need > len(devices):
        raise ValueError(f"{n_slices} slices of {chips_per_slice} need {need} "
                         f"devices; {len(devices)} given")
    return Mesh(devices[:need], (DCN_AXIS, TREE_AXIS),
                shape=(n_slices, chips_per_slice))


def slot_axes(mesh: Mesh):
    """The axis name(s) the slot / system axis shards over: TREE_AXIS on a
    1-D mesh, the (slice, tree) tuple on a multislice mesh."""
    return mesh.axis_names if len(mesh.axis_names) > 1 else TREE_AXIS


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where the slots of a mesh hold a [batch, rows, ...] tensor: `kind`
    "slot" (batch split into ndev contiguous ranges), "rows" (each of
    `groups` fronts split over ndev / groups slots by rows) or
    "replicated"; `spec` the JAX PartitionSpec it stands for."""
    kind: str
    spec: tuple
    ndev: int
    groups: int = 1

    def batch_range(self, s: int, B: int) -> Tuple[int, int]:
        if self.kind == "slot":
            per = B // self.ndev
            return s * per, (s + 1) * per
        if self.kind == "rows":
            fb = s // (self.ndev // self.groups)
            return fb, fb + 1
        return 0, B

    def row_range(self, s: int, H: int) -> Tuple[int, int]:
        if self.kind != "rows":
            return 0, H
        G = self.ndev // self.groups
        per = -(-H // G)
        g = s % G
        return min(g * per, H), min((g + 1) * per, H)


def panel_sharding(mesh: Mesh, level: int) -> Placement:
    """Placement of a level's [2^L, H, W] panel array (the JAX package's
    `panel_sharding`): slot-sharded when the level is wide enough, row
    groups for a narrow mid-tree level (1 < 2^L < ndev, 2^L divides ndev),
    replicated otherwise."""
    ndev = mesh.size
    nslots = 1 << level
    if nslots >= ndev and nslots % ndev == 0:
        return Placement("slot", (slot_axes(mesh), None, None), ndev)
    if 1 < nslots < ndev and ndev % nslots == 0:
        return Placement("rows", (FB_AXIS, RG_AXIS, None), ndev, nslots)
    return Placement("replicated", (None, None, None), ndev)


def rhs_sharding(mesh: Mesh, level: int) -> Placement:
    ndev = mesh.size
    nslots = 1 << level
    if nslots >= ndev and nslots % ndev == 0:
        return Placement("slot", (slot_axes(mesh), None), ndev)
    return Placement("replicated", (None, None), ndev)


def family_sharding(mesh: Mesh, k: int, ndim: int = 4) -> Placement:
    """Placement of a family of k same-pattern systems: the SYSTEM axis
    shards over the mesh (k / ndev whole systems per slot, no traffic
    between slots) when ndev divides k, else replicated. `spec` is JAX's
    for the [K, B, F, W] layout; the port folds the family into the batch
    axis system-major, where the same split is contiguous batch ranges."""
    ndev = mesh.size
    spec = [None] * ndim
    if k >= ndev and k % ndev == 0:
        spec[0] = slot_axes(mesh)
        return Placement("slot", tuple(spec), ndev)
    return Placement("replicated", tuple(spec), ndev)


class Sharded:
    """One tensor held as per-slot parts: `parts[s]` is slot s's batch
    range (and, for row groups, row range) of the whole tensor of `shape`,
    on `devices[s]` or, when offloaded, in host memory. The port's
    stand-in for a sharded `jax.Array`."""

    def __init__(self, parts, placement: Placement, shape, devices):
        self.parts = list(parts)
        self.placement = placement
        self.shape = tuple(int(x) for x in shape)
        self.devices = list(devices)

    @property
    def kind(self) -> str:
        return self.placement.kind

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def element_size(self) -> int:
        return self.parts[0].element_size()

    def slot_nbytes(self) -> List[int]:
        """Bytes each slot's part holds."""
        return [p.numel() * p.element_size() for p in self.parts]

    def spans(self):
        """(slot, its part, batch range, row range) per slot."""
        B, H = self.shape[0], self.shape[1]
        return [(s, p, self.placement.batch_range(s, B),
                 self.placement.row_range(s, H))
                for s, p in enumerate(self.parts)]

    def gather(self, device=None, b0: int = 0, b1: Optional[int] = None,
               stats: Optional[dict] = None) -> torch.Tensor:
        """Blocks [b0, b1) of the whole tensor on `device` (default: the
        first slot's); `stats["bytes"]` counts the bytes copied from other
        slots' parts."""
        device = _device(device or self.devices[0])
        b1 = self.shape[0] if b1 is None else b1
        if self.kind == "slot":
            got = []
            for s, p, (lo, hi), _ in self.spans():
                a, z = max(lo, b0), min(hi, b1)
                if a < z:
                    got.append(_send(p[a - lo:z - lo], device, stats,
                                     s != 0))
            return got[0] if len(got) == 1 else torch.cat(got)
        out = torch.empty((b1 - b0,) + self.shape[1:], dtype=self.dtype,
                          device=device)
        for s, p, (lo, _), (r0, r1) in self.spans():
            if b0 <= lo < b1:
                out[lo - b0, r0:r1] = _send(p[0], device, stats, s != 0)
        return out

    def map(self, fn) -> "Sharded":
        """`fn` applied to every part (a cast, a move to host memory)."""
        return Sharded([fn(p) for p in self.parts], self.placement,
                       self.shape, self.devices)

    def home(self) -> "Sharded":
        """Every part back on its slot's device (the sharded re-upload of
        an offloaded level)."""
        return Sharded([p.to(d) for p, d in zip(self.parts, self.devices)],
                       self.placement, self.shape, self.devices)


def _send(t: torch.Tensor, device, stats: Optional[dict],
          count: bool = True) -> torch.Tensor:
    """`t` on `device` (a peer copy between cards, none within one); its
    bytes are added to stats["bytes"] when `count`. A copy between cards
    is asynchronous (torch orders it on both cards' streams); a copy into
    host memory returns only once it has landed, since the host reads it
    at once."""
    if stats is not None and count:
        stats["bytes"] = stats.get("bytes", 0) + t.numel() * t.element_size()
    device = _device(device)
    return t.to(device, non_blocking=device.type != "cpu")


def local(t, device=None):
    """A level as one tensor: a `Sharded` gathered onto `device` (default:
    where its first part is, host memory for an offloaded level), a tensor
    as it is."""
    if isinstance(t, Sharded):
        return t.gather(device or t.device)
    return t


def distribute(t: torch.Tensor, placement: Placement, mesh: Mesh):
    """`t` placed on `mesh`: a `Sharded` of its slot parts, each on its
    slot's device; a replicated tensor on the mesh's first device."""
    devs = mesh.flat
    if placement.kind == "replicated":
        return t.to(devs[0])
    B, H = t.shape[0], t.shape[1]
    parts = []
    for s, d in enumerate(devs):
        b0, b1 = placement.batch_range(s, B)
        r0, r1 = placement.row_range(s, H)
        parts.append(t[b0:b1, r0:r1].to(d).contiguous())
    return Sharded(parts, placement, t.shape, devs)


def distribute_panels(panels: Sequence, mesh: Mesh) -> list:
    return [distribute(p, panel_sharding(mesh, lvl), mesh)
            for lvl, p in enumerate(panels)]


def distribute_rhs(b: Sequence, mesh: Mesh) -> list:
    return [distribute(x, rhs_sharding(mesh, lvl), mesh)
            for lvl, x in enumerate(b)]


def distribute_family(fronts: Sequence, mesh: Mesh, k: int) -> list:
    """A family's folded per-level slabs [k B, F, W] (system-major), the
    system axis split over the mesh (`family_sharding`)."""
    place = family_sharding(mesh, k)
    return [distribute(f, place, mesh) for f in fronts]
