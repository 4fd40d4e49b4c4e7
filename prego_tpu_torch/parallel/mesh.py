"""Process meshes over torch.distributed (port of prego_tpu/parallel/mesh.py).

The reference distributes LLaMA with torchrun, NCCL and fairscale's
model-parallel groups (llama/generation.py:84-89). The JAX package builds
one ``jax.sharding.Mesh`` and lets XLA insert the collectives. Here every
rank runs the same program on its own device and holds plain local
shards; a ``Mesh`` names the axes of the ranks (``dp``, ``tp``, ``sp``)
and gives each axis's process group, over which the model calls
``all_reduce`` and ``all_gather`` itself (``models/llama/model.py``,
``parallel/sp.py``, ``train/trainer.py``). No DTensor is involved: the
port's kernels take plain CUDA tensors.

The collective backend is the caller's choice, never switched behind its
back: ``nccl`` is the default for CUDA devices and ``gloo`` for the CPU.
NCCL refuses two ranks on one device, so two ranks that share a card pass
``backend="gloo"``, which carries CUDA tensors for ``all_reduce``,
``all_gather`` and ``broadcast``.

A rank's device is ``cuda:LOCAL_RANK % device_count`` on the card (torchrun
sets ``LOCAL_RANK``; ``run_ranks`` sets it for its workers).
"""

from __future__ import annotations

import math
import multiprocessing
import os
import queue
import socket
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK % device_count`` on the card
    (raising where PyTorch sees none), the CPU otherwise."""
    if device_type == "cpu":
        return torch.device("cpu")
    from prego_tpu_torch.core.device import resolve_device

    resolve_device(device_type)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_distributed(device) -> Tuple[int, int]:
    """Join the process group a launcher (``torch.distributed.run``) set up
    in the environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), once, over ``default_backend(device)``; a single
    process (no ``WORLD_SIZE`` above 1) joins nothing. Returns (rank,
    world size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    dist.init_process_group(default_backend(dev), init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def world_size() -> int:
    """Ranks in the initialized process group; 1 where there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of the process group (the role of
    ``jax.sharding.Mesh``): ``shape`` maps each axis to its size, and
    ``group(axis)`` / ``index(axis)`` give this rank's process group and
    coordinate along it."""

    device_mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(axis_shapes: Sequence[Tuple[str, int]], backend: Optional[str] = None) -> Mesh:
    """A mesh over the process group, e.g. ``make_mesh([("dp", 2), ("tp",
    2)])``: rank r has coordinates ``unravel(r, sizes)``, the last axis
    fastest. An axis size of -1 absorbs the remaining ranks; a mesh larger
    than the world raises, and so does one smaller (every rank runs the
    program, so every rank is in the mesh).

    Joins a process group of ``backend`` (default: ``default_backend`` of
    the card where one is visible, else of the CPU) from the environment
    where none is initialized yet. The DeviceMesh's device type is
    ``cuda`` over NCCL and ``cpu`` over gloo (which carries CUDA tensors
    too); the collectives take plain tensors on each rank's own device
    either way."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        card = torch.cuda.is_available()
        if card:
            torch.cuda.set_device(rank_device("cuda"))
        dist.init_process_group(backend or default_backend("cuda" if card else "cpu"),
                                init_method="env://")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    world = dist.get_world_size()
    names = [n for n, _ in axis_shapes]
    sizes = [int(s) for _, s in axis_shapes]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world // known
    total = math.prod(sizes)
    if total > world:
        raise ValueError(f"mesh needs {total} ranks, have {world}")
    if total < world:
        raise ValueError(f"mesh of {total} ranks in a world of {world}: every rank runs "
                         "the program, so every rank must be in the mesh")
    device_mesh = init_device_mesh(device_type, tuple(sizes), mesh_dim_names=tuple(names))
    return Mesh(device_mesh, tuple(names), dict(zip(names, sizes)))


def tp_mesh(tp: Optional[int] = None, backend: Optional[str] = None) -> Mesh:
    """A pure tensor-parallel mesh over the whole world (``tp`` ranks, which
    must be the world)."""
    if tp is None:
        if not dist.is_initialized():
            raise ValueError("tp_mesh() without tp needs an initialized process group")
        tp = dist.get_world_size()
    return make_mesh([("tp", tp)], backend=backend)


class PartitionSpec(tuple):
    """Which mesh axis splits each dim of a tensor (None: kept whole), as
    ``jax.sharding.PartitionSpec``: ``PartitionSpec(None, "tp")``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class Sharding:
    """A placement: ``spec`` over ``mesh`` (the role of ``NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``x`` (a view)."""
        return local_block(x, self.spec, self.mesh)


def local_block(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """The block of ``x`` this rank holds under ``spec``: each split dim cut
    into equal blocks, block ``mesh.index(axis)`` kept. A view of ``x``;
    a dim the axis size does not divide raises (``_compatible_spec`` keeps
    such dims whole first)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over "
                             f"{axis!r} of size {n}")
        step = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(axis) * step, step)
    return x


def shard(mesh: Mesh, *spec) -> Sharding:
    return Sharding(mesh, PartitionSpec(*spec))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, backend, device_type, port, threads, args, results):
    try:
        os.environ["LOCAL_RANK"] = str(rank)
        os.environ["RANK"] = str(rank)
        os.environ["WORLD_SIZE"] = str(world)
        if threads is not None:
            torch.set_num_threads(threads)
        if device_type == "cuda":
            torch.cuda.set_device(rank_device("cuda"))
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, backend: Optional[str] = None, device: str = "cpu",
              args: tuple = (), threads: Optional[int] = None,
              timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` spawned processes joined in one process
    group (``tcp://localhost``, a free port) and return each rank's result,
    by rank: the role of the JAX tests' virtual device mesh. ``fn`` must
    be importable (it is pickled by name) and return picklable values.
    ``device`` is ``cpu`` or ``cuda`` (each rank on ``rank_device``);
    ``threads`` sets each rank's intra-op threads. A rank that raises, or
    a run past ``timeout`` seconds, raises here with the rank's
    traceback; every process is ended before this returns."""
    device_type = torch.device(device).type
    backend = backend or default_backend(device_type)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, device_type, port, threads, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    failures = []
    try:
        for _ in range(world):
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"run_ranks: no result from {sorted(set(range(world)) - set(out))} "
                                   f"in {timeout} s") from None
            if ok:
                out[rank] = value
            else:
                failures.append(f"rank {rank}:\n{value}")
                break  # the other ranks may wait on it in a collective
    finally:
        for p in procs:
            p.join(timeout=10 if not failures else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if failures:
        raise RuntimeError("run_ranks: " + "\n".join(failures))
    return [out[r] for r in range(world)]
