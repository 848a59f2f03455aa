"""SPMD meshes, collectives and the rank launcher on ``torch.distributed``.

The port's counterpart of what the JAX package's sharded paths take from
JAX: a :class:`Mesh` names the axes of a process group's ranks (as
``jax.sharding.Mesh`` names a device grid), the few collectives the shard
bodies need stand in for ``shard_map``'s (``psum``, ``all_gather``,
``ppermute`` of strip edge rows), and :func:`run_spmd` starts the ranks, as
the JAX package's multi-device dry run provisions its virtual devices.

Every rank calls a sharded function with the same host arguments and gets
back the same full host results. Each rank runs on its own device:
``cuda:{rank % device_count}`` unless the caller passes one (through
:func:`tpu_inspect_torch.device.resolve_device`, so "cuda" raises without a
GPU; ``device="cpu"`` runs the kernels' plain versions). Without an
initialised process group a mesh is one rank on this process's device, and
the collectives are identities.

The backend is the caller's process group, or the one named to
:func:`run_spmd`; it is never swapped. NCCL takes one rank a GPU; ranks
sharing one GPU run under gloo. Where gloo refuses CUDA tensors (its
point-to-point sends) the helper here stages them through a host copy,
and only there: the planes and every kernel stay on the card.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
import types
from dataclasses import dataclass

import torch
import torch.distributed as dist

from tpu_inspect_torch.device import resolve_device

# the device run_spmd gave this rank (None outside its workers)
_RANK_DEVICE: torch.device | None = None


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_device(device=None, rank: int | None = None) -> torch.device:
    """This rank's device: ``device`` if given; else the one :func:`run_spmd`
    gave this rank; else ``cuda:{rank % device_count}`` (the rank in the
    default process group; without one, the current CUDA device). Raises
    without CUDA unless a CPU device is asked for."""
    if device is not None:
        return resolve_device(device)
    if _RANK_DEVICE is not None and rank is None:
        return _RANK_DEVICE
    resolve_device("cuda")
    if rank is None and not _distributed():
        return torch.device("cuda", torch.cuda.current_device())
    if rank is None:
        rank = dist.get_rank()
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of a process group, row-major: rank ``i``
    of the group sits at the coordinates of ``i`` unravelled over
    ``sizes``. ``group`` None is the default group when a process group is
    initialised, and one rank without one. ``device`` is this rank's."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int
    device: torch.device
    group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        i = self.axis_names.index(axis)
        return self.rank // math.prod(self.sizes[i + 1:]) % self.sizes[i]

    def global_rank(self, i: int) -> int:
        """The default group's rank of the mesh's rank ``i``."""
        return i if self.group is None else dist.get_global_rank(self.group, i)


def group_size(group=None) -> int:
    """Ranks of ``group`` (the default group; 1 without a process group)."""
    if not _distributed():
        if group is not None:
            raise ValueError("a process group was given but none is initialised")
        return 1
    return dist.get_world_size(group)


def make_mesh(axis_names, sizes, group=None, device=None) -> Mesh:
    """A mesh over the ranks of ``group`` with the axes ``axis_names`` of
    ``sizes`` (one size may be -1: the ranks left over). Raises on a rank
    outside ``group`` and when the sizes do not cover the group."""
    n = group_size(group)
    rank = dist.get_rank(group) if _distributed() else 0
    if rank < 0:
        raise ValueError("this process is not a rank of the mesh's group")
    sizes = [int(s) for s in sizes]
    if sizes.count(-1) == 1:
        rest = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // rest if rest and n % rest == 0 else 0
    if math.prod(sizes) != n or min(sizes) < 1:
        raise ValueError(f"mesh {dict(zip(axis_names, sizes))} does not cover {n} ranks")
    return Mesh(tuple(axis_names), tuple(sizes), rank, rank_device(device), group)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor the backends take: bool travels as its bytes."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def all_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The element-wise sum of ``t`` over the mesh's ranks (``psum``), in
    place; returns ``t``."""
    if _distributed():
        dist.all_reduce(t, group=mesh.group)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh, counts=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in mesh rank order
    (``all_gather(tiled=True)``). With ``counts`` (each rank's rows), a
    rank's ``t`` has its own count of rows: they travel padded to the
    largest and are cut back."""
    if not _distributed():
        return t
    dtype, x = t.dtype, _wire(t)
    if counts is not None and x.shape[0] < max(counts):
        x = torch.cat([x, x.new_zeros((max(counts) - x.shape[0],) + x.shape[1:])])
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    if counts is not None:
        parts = [p[:c] for p, c in zip(parts, counts)]
    out = torch.cat(parts)
    return out.view(dtype) if dtype == torch.bool else out


def exchange_rows(x: torch.Tensor, depth: int, mesh: Mesh):
    """Strip neighbours' edge rows along a 1-D mesh (``ppermute`` both
    ways): (the last ``depth`` rows of the rank above, the first ``depth``
    rows of the rank below), each None at the first and the last rank,
    whose edge is the true border. ``x`` is this rank's strip, rows on
    dim 0; every strip must hold at least ``depth`` rows."""
    if x.shape[0] < depth:
        raise ValueError(f"exchange_rows: a strip of {x.shape[0]} rows for a halo of {depth}")
    n, r = mesh.size, mesh.rank
    if not _distributed() or n == 1 or depth == 0:
        return None, None
    dtype, w = x.dtype, _wire(x)
    # torch 2.11's gloo sums and gathers CUDA tensors, but its isend/irecv
    # refuse them (an H100 run: "writev ... Bad address"): they travel
    # through a host copy here
    if w.device.type == "cuda" and dist.get_backend(mesh.group) == "gloo":
        w = w.cpu()
    ops, above, below = [], None, None
    if r > 0:
        peer = mesh.global_rank(r - 1)
        above = torch.empty_like(w[:depth])
        ops += [dist.P2POp(dist.isend, w[:depth].contiguous(), peer, mesh.group),
                dist.P2POp(dist.irecv, above, peer, mesh.group)]
    if r < n - 1:
        peer = mesh.global_rank(r + 1)
        below = torch.empty_like(w[:depth])
        ops += [dist.P2POp(dist.isend, w[w.shape[0] - depth:].contiguous(), peer, mesh.group),
                dist.P2POp(dist.irecv, below, peer, mesh.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()

    def back(b):
        if b is None:
            return None
        b = b.to(x.device)
        return b.view(dtype) if dtype == torch.bool else b

    return back(above), back(below)


def run_calls(calls) -> list:
    """Each of ``calls`` (zero-argument callables) in order: their results
    as a list, a generator's (a stream's) drained into a list. A picklable
    program of several calls for :func:`run_spmd`."""
    return [list(v) if isinstance(v, types.GeneratorType) else v for v in (c() for c in calls)]


def _worker(rank, world, backend, init_method, fn, args, device, results):
    global _RANK_DEVICE
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        _RANK_DEVICE = dev
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                device_id=dev if backend == "nccl" else None)
        # plain pickle bytes: a tensor then travels by value, not as shared
        # memory that dies with this process
        results.put((rank, None, pickle.dumps(fn(*args))))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, traceback.format_exc(), None))
    finally:
        if _distributed():
            dist.destroy_process_group()


def run_spmd(fn, world: int, backend: str, device=None, args=None,
             timeout: float = 900.0) -> list:
    """Run ``fn()`` on ``world`` ranks, each a process started with the
    ``spawn`` method under a process group of ``backend`` ("gloo" or
    "nccl"), initialised through a file in a fresh temporary directory.
    Returns each rank's ``fn()`` result, by rank.

    ``fn`` is a picklable callable of an importable module (a function, or
    ``functools.partial`` over one; :func:`run_calls` runs several); with
    ``args`` (one tuple per rank) rank ``r`` calls ``fn(*args[r])``.
    ``device`` is every rank's device (None:
    ``cuda:{rank % device_count}``). The CUDA kernels are built here once,
    before the ranks start. A failure on any rank stops the others and
    raises here with that rank's traceback."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"run_spmd: backend must be 'gloo' or 'nccl', got {backend!r}")
    dev = resolve_device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if backend == "nccl" and device is None and world > torch.cuda.device_count():
            raise ValueError(f"run_spmd: NCCL takes one rank a GPU: {world} ranks on "
                             f"{torch.cuda.device_count()} GPUs (gloo shares one)")
        from tpu_inspect_torch.kernels import build

        build.build()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out: list = [None] * world
    with tempfile.TemporaryDirectory(prefix="tik_spmd_") as tmp:
        init = "file://" + os.path.join(tmp, "init")
        args = [()] * world if args is None else [tuple(a) for a in args]
        if len(args) != world:
            raise ValueError(f"run_spmd: {len(args)} argument tuples for {world} ranks")
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(r, world, backend, init, fn, args[r], device, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            pending, deadline = set(range(world)), time.monotonic() + timeout
            while pending:
                try:
                    rank, tb, value = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r in pending if procs[r].exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"run_spmd: rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"run_spmd: ranks {sorted(pending)} gave no "
                                           f"result in {timeout} s") from None
                    continue
                if tb is not None:
                    raise RuntimeError(f"run_spmd: rank {rank} of {world} failed:\n{tb}")
                out[rank] = pickle.loads(value)
                pending.discard(rank)
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
    return out
