"""Mesh runtime on ``torch.distributed`` (port of ``parallel/mesh.py``).

The JAX package drives every device from one SPMD program over a
``jax.sharding.Mesh``.  The port runs one process per device, as the
reference's process-per-node design does (reference initializer.py:134-145):
a ``Mesh`` here is this process's rank in a ``torch.distributed`` process
group, the device it drives and the group's size, which is the ``data``
axis.  The backend is NCCL for CUDA devices (rank r drives ``cuda:r``
modulo the visible cards) and gloo for the CPU.

``create_mesh`` joins the process group that is already there (ranks
spawned by the CLI, or ``multihost_initialize``), or, with none, makes a
group of size 1 over a free localhost port, so a one-device run takes the
same collective path as a many-device one.

With ``shape``, the group's ranks are laid out row-major over several
named axes, as JAX reshapes its device list (JAX ``mesh.py:73``): on a
(data, seq) mesh of shape (dp, sp), rank r sits at (r // sp, r % sp).
Each axis gets the sub-groups of the ranks that differ only along it
(``dist.new_group``, made by every rank for every group in one order);
an axis that spans the whole group uses the world group.  Without
``shape`` the mesh is the 1-D ``data`` axis over every rank.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import random
import socket
import sys

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch import resolve_device

DATA_AXIS = "data"  # data parallelism (the reference's only axis)
SEQ_AXIS = "seq"    # sequence (context) parallelism
EXPERT_AXIS = "expert"  # expert parallelism (MoE experts sharded)
MODEL_AXIS = "model"    # tensor parallelism (Megatron layers sharded)
PIPE_AXIS = "pipe"      # pipeline parallelism (one stage per rank)


def device_count() -> int:
    """CUDA cards visible to this process (0 without one)."""
    return torch.cuda.device_count()


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def check_device_count(n: int, device) -> None:
    """One CUDA card per rank: asking for more ranks than cards raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and n > device_count():
        raise ValueError(
            f"requested {n} devices but only {device_count()} available; "
            f"for CPU testing pass device='cpu' (--device cpu), which runs "
            f"{n} gloo ranks")


def free_port() -> int:
    """A free loopback port for a process group's store, picked at random
    below the kernel's ephemeral range (32768-60999 by default): a port
    the kernel hands out can be handed out again, as the local end of any
    process's outgoing connection, before the store binds it."""
    rng = random.SystemRandom()
    for _ in range(64):
        port = rng.randrange(20000, 32768)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class Mesh:
    """This process's place in the group: its rank, the group's size, and
    the named axes the ranks are laid out over (row-major)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    owns_group: bool = False   # True: create_mesh made the group
    # sys.excepthook before create_mesh made the group
    excepthook: object = dataclasses.field(default=None, repr=False)
    axis_names: tuple[str, ...] = (DATA_AXIS,)
    dims: tuple[int, ...] = ()          # each axis's size; () = (world,)
    # each axis's sub-group holding this rank; None = the world group
    groups: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if not self.dims:
            self.dims = (self.world_size,)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis '{axis}' (axes "
                             f"{self.axis_names})")
        return self.axis_names.index(axis)

    def coords(self, rank: int | None = None) -> tuple[int, ...]:
        """A rank's coordinates on the axes (this rank's by default)."""
        r = self.rank if rank is None else rank
        out = []
        for d in reversed(self.dims):
            out.append(r % d)
            r //= d
        return tuple(reversed(out))

    def axis_size(self, axis: str) -> int:
        return self.dims[self._axis(axis)]

    def axis_index(self, axis: str) -> int:
        return self.coords()[self._axis(axis)]

    def group(self, axis: str):
        """This rank's sub-group along ``axis`` (None: the world group)."""
        self._axis(axis)
        return self.groups.get(axis)

    def global_rank(self, axis: str, index: int) -> int:
        """The rank at ``index`` along ``axis`` beside this one (the peer
        a point-to-point op takes: a global rank, whatever the group)."""
        c = list(self.coords())
        c[self._axis(axis)] = index
        return _flat(c, self.dims)

    def close(self) -> None:
        """Destroy the process group if this mesh made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            # init_process_group wraps sys.excepthook to prefix "[rankN]: "
            # to every line; a process that makes and closes a mesh per run
            # would stack one prefix per run
            sys.excepthook = self.excepthook
        self.owns_group = False


def _flat(coords, dims) -> int:
    """The rank at ``coords`` of a row-major layout of shape ``dims``."""
    r = 0
    for c, d in zip(coords, dims):
        r = r * d + c
    return r


def kv_slot_sharding(mesh: Mesh, rows: int, kv_heads: int,
                     heads: int | None = None) -> tuple[slice, slice]:
    """This rank's block of a decode KV leaf ``(rows, ..., kv_heads,
    head_dim)`` (JAX ``kv_slot_sharding``), as ``(rows, kv heads)``
    slices: the rows (a decode batch) split over 'data' in contiguous
    blocks (the caller checks that they divide); the kv heads split over
    'model' when ``kv_heads`` and ``heads`` (default ``kv_heads``) both
    divide it, else each rank holds them whole.  ``generate`` reads the
    rows; ``models.gpt.CausalSelfAttention.bind_tp`` the heads, so a
    bound attention, its cache and a slot table's leaves hold that block.
    Axes absent from the mesh (and any other axis) replicate."""
    row = slice(0, rows)
    if DATA_AXIS in mesh.axis_names:
        n = rows // mesh.axis_size(DATA_AXIS)
        d = mesh.axis_index(DATA_AXIS)
        row = slice(d * n, (d + 1) * n)
    head = slice(0, kv_heads)
    if MODEL_AXIS in mesh.axis_names:
        tp = mesh.axis_size(MODEL_AXIS)
        if not (kv_heads % tp or (heads or kv_heads) % tp):
            n = kv_heads // tp
            m = mesh.axis_index(MODEL_AXIS)
            head = slice(m * n, (m + 1) * n)
    return row, head


def _axis_groups(mesh: Mesh) -> dict:
    """Every axis's sub-groups, made in one order on every rank (each rank
    calls ``new_group`` for every group); returns this rank's group per
    axis.  An axis as large as the world uses the world group."""
    groups = {}
    for a, name in enumerate(mesh.axis_names):
        if mesh.dims[a] == mesh.world_size:
            groups[name] = None
            continue
        others = [range(d) for i, d in enumerate(mesh.dims) if i != a]
        for rest in itertools.product(*others):
            ranks = [_flat(rest[:a] + (i,) + rest[a:], mesh.dims)
                     for i in range(mesh.dims[a])]
            g = dist.new_group(ranks)
            if mesh.rank in ranks:
                groups[name] = g
    return groups


def init_process_group(device, world_size: int, rank: int,
                       init_method: str | None = None, store=None) -> None:
    """Join a group of ``world_size`` ranks at ``init_method``
    (``tcp://host:port``), or through ``store``, with the device's backend;
    a CUDA rank first selects its card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % max(device_count(), 1))
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            store=store, world_size=world_size, rank=rank)


def create_mesh(n_devices: int | None = None, device=None,
                shape: tuple[int, ...] | None = None,
                axis_names: tuple[str, ...] = (DATA_AXIS,)) -> Mesh:
    """This process's ``Mesh``.  ``n_devices`` (the reference's ``-n``)
    must match the group's size when a group exists; with none, only 1 is
    possible in one process (``cli -n N`` spawns N ranks).  ``device=None``
    means the CUDA card.  ``shape`` lays the ranks out over
    ``axis_names`` (its product must be the group's size); without it the
    mesh is the 1-D ``data`` axis."""
    if shape is not None:
        shape, axis_names = tuple(shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes "
                             f"{axis_names}")
        if n_devices is not None and math.prod(shape) != n_devices:
            raise ValueError(f"mesh shape {shape} does not cover "
                             f"{n_devices} devices")
    dev = resolve_device(device)
    owns, hook = False, None
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} ranks needs a process group of "
                f"{n_devices} processes: spawn them (cli -n {n_devices}) or "
                f"join one with multihost_initialize")
        if shape is not None and math.prod(shape) != 1:
            raise ValueError(f"mesh shape {shape} needs a process group of "
                             f"{math.prod(shape)} processes")
        hook = sys.excepthook
        # a group of one meets in an in-process store: a TCP rendezvous on
        # a port probed free can lose that port to another socket before
        # the store listens on it (EADDRINUSE)
        init_process_group(dev, 1, 0, store=dist.HashStore())
        owns = True
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested {n_devices} devices but the process "
                         f"group has {world} ranks")
    if shape is not None and math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} does not cover the process "
                         f"group's {world} ranks")
    backend = dist.get_backend()
    if backend != backend_for(dev):
        raise ValueError(f"a {dev.type} mesh needs the {backend_for(dev)} "
                         f"backend; the process group runs {backend}")
    if dev.type == "cuda":
        # the card init_process_group selected for this rank
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh(rank=rank, world_size=world, device=dev, backend=backend,
                owns_group=owns, excepthook=hook)
    if shape is not None:
        mesh.axis_names, mesh.dims = axis_names, shape
        mesh.groups = _axis_groups(mesh)
    return mesh


def multihost_initialize(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device=None) -> None:
    """Join a multi-machine group: the reference's ``-tt server|worker -ti
    I -sa ADDR`` become ``init_process_group`` coordinates, every process
    then running the same program.  ``coordinator_address`` is
    ``host:port`` of process 0."""
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError("multihost_initialize needs coordinator_address, "
                         "num_processes and process_id")
    init_process_group(resolve_device(device), num_processes, process_id,
                       f"tcp://{coordinator_address}")
