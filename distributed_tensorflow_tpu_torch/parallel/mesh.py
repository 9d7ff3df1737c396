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
"""

from __future__ import annotations

import dataclasses
import socket
import sys

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch import resolve_device

DATA_AXIS = "data"  # data parallelism (the reference's only axis)


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
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class Mesh:
    """This process's place in the data-parallel group."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    owns_group: bool = False   # True: create_mesh made the group
    # sys.excepthook before create_mesh made the group
    excepthook: object = dataclasses.field(default=None, repr=False)

    axis_names = (DATA_AXIS,)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.world_size}

    def close(self) -> None:
        """Destroy the process group if this mesh made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            # init_process_group wraps sys.excepthook to prefix "[rankN]: "
            # to every line; a process that makes and closes a mesh per run
            # would stack one prefix per run
            sys.excepthook = self.excepthook
        self.owns_group = False


def init_process_group(device, world_size: int, rank: int,
                       init_method: str) -> None:
    """Join a group of ``world_size`` ranks at ``init_method``
    (``tcp://host:port``) with the device's backend; a CUDA rank first
    selects its card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % max(device_count(), 1))
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            world_size=world_size, rank=rank)


def create_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """This process's ``Mesh``.  ``n_devices`` (the reference's ``-n``)
    must match the group's size when a group exists; with none, only 1 is
    possible in one process (``cli -n N`` spawns N ranks).  ``device=None``
    means the CUDA card."""
    dev = resolve_device(device)
    owns, hook = False, None
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} ranks needs a process group of "
                f"{n_devices} processes: spawn them (cli -n {n_devices}) or "
                f"join one with multihost_initialize")
        hook = sys.excepthook
        init_process_group(dev, 1, 0, f"tcp://127.0.0.1:{free_port()}")
        owns = True
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested {n_devices} devices but the process "
                         f"group has {world} ranks")
    backend = dist.get_backend()
    if backend != backend_for(dev):
        raise ValueError(f"a {dev.type} mesh needs the {backend_for(dev)} "
                         f"backend; the process group runs {backend}")
    if dev.type == "cuda":
        # the card init_process_group selected for this rank
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(rank=rank, world_size=world, device=dev, backend=backend,
                owns_group=owns, excepthook=hook)


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
