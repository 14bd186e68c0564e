"""The data-parallel mesh for training: one process (rank) per shard.

Port of ``joshupscale_tpu/parallel/mesh.py``.  The reference's contract
holds here: the sharded step *is* the single-device step on the global
batch.  The batch axis is sharded over the mesh's one axis (``data``),
the params and the optimizer state are replicated, and the gradient is
the gradient of the global batch's loss.  Under GSPMD that needs no
code; under ``torch.distributed`` the step holds it place by place
(``training.trainer.build_frvsr_step`` / ``build_gan_step`` with
``mesh=``): the gradient is the all-reduced mean of the ranks'
gradients, batch norm takes its moments over the global batch through
``Mesh.sum`` (differentiable), the noise is drawn at the global shape
and sliced, and the metrics, the GAN's gate and its EMAs come from
all-reduced means.

One process per shard, not one process driving every shard: batch norm
couples the shards, so every shard's forward pass has to reach each
batch-norm layer together, which separate processes do by themselves
(each blocks in the all-reduce).  ``launch`` spawns the ranks
(``torch.multiprocessing``, ``spawn``) around a ``FileStore`` in a
temporary directory (no network, no port) and returns rank 0's result.

The backend is explicit (``check_backend``): ``nccl`` for distinct
CUDA devices, ``gloo`` on the CPU and for ranks that share one card
(NCCL refuses two ranks on one device).  A pairing the backend cannot
serve raises; nothing switches silently.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from joshupscale_torch import DeviceLike

BACKENDS = ("gloo", "nccl")
# A collective that waits this long fails the rank (and so the launch)
# instead of hanging.
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a 1-D mesh: its ``rank`` of ``world_size``,
    the axis name (``axis_names``), its ``device`` and every rank's
    (``devices``), the backend and the process group (None: the
    default group)."""

    rank: int
    world_size: int
    axis_names: Tuple[str, ...]
    device: torch.device
    devices: Tuple[torch.device, ...]
    backend: str
    group: Any = None

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; every rank gets the same
        bytes."""
        dist.all_reduce(t, group=self.group)
        return t

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, differentiably: the backward pass
        sums the incoming gradient over the ranks too (``_GlobalSum``).
        Batch norm's reducer (``nn.layers.batch_norm_train``)."""
        return _GlobalSum.apply(x, self)

    def mean(self, *trees: Dict[str, torch.Tensor]) -> tuple:
        """The ranks' mean of every value of the dicts ``trees``
        (detached), in one all-reduce of their concatenation; returns
        the dicts."""
        tensors = [t for tree in trees for t in tree.values()]
        if not tensors:
            return trees
        with torch.no_grad():
            flat = torch.cat([t.detach().float().reshape(-1)
                              for t in tensors])
            self.all_reduce_(flat).div_(self.world_size)
            out, at = [], 0
            for tree in trees:
                means = {}
                for k, t in tree.items():
                    means[k] = (flat[at:at + t.numel()].reshape(t.shape)
                                .to(t.dtype))
                    at += t.numel()
                out.append(means)
        return tuple(out)


class _GlobalSum(torch.autograd.Function):
    """All-reduce sum whose backward pass all-reduces the gradient: with
    ``y = sum_r x_r`` on every rank, ``d(sum_s L_s)/d x_r = sum_s
    dL_s/d y_s``, so each rank's backward pass computes the derivative of
    the ranks' summed loss, and the ranks' mean gradient is the global
    loss's (``training.trainer``'s module docstring)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.detach().clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.detach().contiguous().clone()), None


# ---------------------------------------------------------------------------
# Devices and backends


def _canonical(d: DeviceLike) -> torch.device:
    dev = torch.device(f"cuda:{d}" if isinstance(d, int) else d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def mesh_devices(n_devices: Optional[int] = None,
                 devices: Optional[Sequence[DeviceLike]] = None) -> list:
    """The devices of an ``n_devices`` mesh: ``devices`` as given (a
    device may repeat), else the first ``n_devices`` CUDA devices (all of
    them for None).  Asking for more CUDA devices than exist raises."""
    if devices is not None:
        devs = [_canonical(d) for d in devices]
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} "
                             f"devices given")
        return devs
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else n_devices
    if n > count or n < 1:
        raise ValueError(f"{n} CUDA devices asked for, {count} visible; "
                         f"pass devices= (for example ['cpu', 'cpu']) "
                         f"for ranks on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def check_backend(devices: Sequence[DeviceLike],
                  backend: Optional[str] = None) -> str:
    """The backend for ranks on ``devices``: ``backend`` if it can serve
    them, else ValueError; None picks ``nccl`` for distinct CUDA devices
    and ``gloo`` otherwise (the CPU, or ranks sharing a card)."""
    devs = [_canonical(d) for d in devices]
    kinds = {d.type for d in devs}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh's devices are all CPU or all CUDA, got "
                         f"{[str(d) for d in devs]}")
    shared = len(set(devs)) < len(devs)
    if backend is None:
        backend = "nccl" if kinds == {"cuda"} and not shared else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "nccl" and kinds == {"cpu"}:
        raise ValueError("nccl serves CUDA tensors only; CPU ranks take "
                         "gloo")
    if backend == "nccl" and shared:
        raise ValueError("nccl refuses two ranks on one device; ranks "
                         "that share a card take gloo")
    return backend


# ---------------------------------------------------------------------------
# The reference's names


def create_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
                devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """This rank's mesh over the ranks of the initialized process group:
    rank i on ``devices[i]`` (default: CUDA device i).  Called inside a
    rank (``launch`` calls it)."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh runs inside a rank: start the "
                           "ranks with launch()")
    world = dist.get_world_size()
    devs = mesh_devices(world if n_devices is None else n_devices, devices)
    if len(devs) != world:
        raise ValueError(f"{len(devs)} devices for {world} ranks")
    backend = check_backend(devs, dist.get_backend())
    rank = dist.get_rank()
    return Mesh(rank, world, (axis_name,), devs[rank], tuple(devs), backend)


def batch_spec(mesh: Mesh, steps_per_execution: int = 1) -> tuple:
    """Where the batch is sharded, as a ``PartitionSpec`` reads: the
    leading axis over ``data``, or axis 1 of a (K, B, ...) stack of K
    steps' batches."""
    axis = mesh.axis_names[0]
    return (axis,) if steps_per_execution == 1 else (None, axis)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def local_batch(mesh: Mesh, tree, spec: Optional[tuple] = None):
    """This rank's equal slice of every leaf of a global batch (numpy
    arrays or tensors, where they are) along ``spec``'s sharded axis
    (default ``batch_spec(mesh)``).  A batch the world size does not
    divide raises ValueError; nothing is padded or dropped."""
    spec = batch_spec(mesh) if spec is None else spec
    axis = spec.index(mesh.axis_names[0])

    def take(x):
        n = x.shape[axis]
        if n % mesh.world_size:
            raise ValueError(f"a batch axis of {n} does not split over "
                             f"{mesh.world_size} ranks")
        k = n // mesh.world_size
        return x[(slice(None),) * axis
                 + (slice(mesh.rank * k, (mesh.rank + 1) * k),)]

    return _map(take, tree)


def shard_batch(mesh: Mesh, tree, spec: Optional[tuple] = None):
    """This rank's slice of a global batch (``local_batch``) as tensors
    on its device."""
    return _map(lambda x: torch.as_tensor(np.asarray(x) if not
                                          torch.is_tensor(x) else x)
                .to(mesh.device),
                local_batch(mesh, tree, spec))


def replicate(mesh: Mesh, tree):
    """A tree (params, an optimizer state) on this rank's device with
    rank 0's values: tensors broadcast from rank 0 (``requires_grad``
    kept), other leaves (counts) too."""
    tensors, others = [], []

    def collect(x):
        (tensors if torch.is_tensor(x) else others).append(x)

    _map(collect, tree)
    with torch.no_grad():
        copies = [t.detach().to(mesh.device).clone() for t in tensors]
        for c in copies:
            dist.broadcast(c, 0, group=mesh.group)
    if others:
        dist.broadcast_object_list(others, 0, group=mesh.group)
    tensors_it, others_it = iter(zip(copies, tensors)), iter(others)

    def place(x):
        if torch.is_tensor(x):
            copy, orig = next(tensors_it)
            return copy.requires_grad_(orig.requires_grad)
        return next(others_it)

    return _map(place, tree)


# ---------------------------------------------------------------------------
# Ranks


def _rank_main(rank: int, fn: Callable, args: tuple, devices: list,
               backend: str, store_dir: str) -> None:
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    elif "OMP_NUM_THREADS" not in os.environ:
        # CPU ranks share the host's cores.
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // len(devices)))
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(store_dir, "store"),
        rank=rank, world_size=len(devices), timeout=TIMEOUT)
    try:
        mesh = create_mesh(len(devices), devices=devices)
        result = fn(mesh, *args)
        if rank == 0:
            torch.save(result, os.path.join(store_dir, "result.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n_devices: Optional[int] = None, *args,
           devices: Optional[Sequence[DeviceLike]] = None,
           backend: Optional[str] = None):
    """Run ``fn(mesh, *args)`` on ``n_devices`` spawned ranks, rank i on
    ``devices[i]`` (default: the CUDA devices, one per rank; see
    ``mesh_devices``) under ``backend`` (``check_backend``), and return
    rank 0's result.  ``fn`` and ``args`` are pickled to the ranks: a
    module-level function of an importable module.  A rank that raises
    fails the launch (the others are stopped); no partial result comes
    back.  CPU ranks split the host's threads between them unless
    ``OMP_NUM_THREADS`` is set."""
    devs = mesh_devices(n_devices, devices)
    backend = check_backend(devs, backend)
    with tempfile.TemporaryDirectory(prefix="mesh-") as store_dir:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, args, [str(d) for d in devs], backend,
                              store_dir),
            nprocs=len(devs), join=True, start_method="spawn")
        return torch.load(os.path.join(store_dir, "result.pt"),
                          weights_only=False)
