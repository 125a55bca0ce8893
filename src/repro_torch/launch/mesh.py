"""Local meshes over ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

A rank is one process. ``make_local_mesh`` lays the default process group's
ranks out as ``data x model``, rank ``r`` at coordinate ``(r // model,
r % model)`` (``jax.make_mesh`` puts the devices in that order), and opens
one process group per axis: the ranks that share every other coordinate.
Each group carries its axis's collectives, which go through the mesh's
helpers (``all_reduce``, ``all_gather``, ``reduce_scatter``).

The helpers are the one place that knows a backend's limits. Gloo (the
CPU, or ranks sharing one card) takes CUDA tensors only for
``all_reduce`` and ``broadcast``, and sums no 16-bit float on the card.
So an all-gather is the sum of a zeroed full buffer that holds the rank's
own part, as integer words (bitwise), and a reduce-scatter is a sum
followed by the rank's slice, both exact (each element is one operand
plus zeros), on every backend:
NCCL (a card per rank) would take its own collectives, with fewer bytes,
but no machine here has the cards to run it. This is transport: the
tensors stay on their device.

``spawn`` starts N ranks with ``torch.multiprocessing`` and runs a
module-level function in each, with the backend and each rank's device
given by the caller; it never moves a rank to the CPU on its own. The
ranks fork from a fork server (a parent that has touched CUDA cannot fork
itself), a process that has imported torch once and never touches CUDA
(``start_fork_server``): a fresh interpreter spends seconds importing
torch and, at its first ``torch.utils.checkpoint``, ``torch._dynamo``
(about 17 s of a rank's start on the card machine). Its ``timeout``
bounds every collective of every group the ranks open, so that the others
fail in seconds, not in gloo's 30 minutes, when one rank dies.

``make_production_mesh`` (the TPU pod's 16 x 16) is not ported: it goes
with the dry run.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import math
import os
import socket
import time

import torch
import torch.distributed as dist

AXES = ("data", "model")

# the bound on every collective of the groups this process opens; set by
# ``spawn`` for its ranks (None: the backend's default)
_timeout: datetime.timedelta | None = None


@dataclasses.dataclass
class Mesh:
    """A ``data x model`` layout of ranks, as one rank sees it.

    ``coords`` is this rank's coordinate on each axis and ``groups`` the
    process group of each axis that holds it (empty for a mesh made
    without a process group, which can answer questions of shape but runs
    no collective). ``moved`` counts, per collective, the calls, the bytes
    each rank handed in and the host seconds inside the calls.
    """
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    coords: dict = dataclasses.field(default_factory=dict)
    groups: dict = dataclasses.field(default_factory=dict)
    device: torch.device = torch.device("cpu")
    backend: str = "gloo"
    moved: dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(lambda: [0, 0, 0.0]))

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape, strict=True))

    def _axes(self, axis) -> tuple[str, ...]:
        return (axis,) if isinstance(axis, str) else tuple(axis)

    def axis_size(self, axis) -> int:
        """The ranks along ``axis``, a name or a tuple of names (their
        product); None is 1."""
        if axis is None:
            return 1
        return math.prod(self.sizes[a] for a in self._axes(axis))

    def axis_index(self, axis) -> int:
        """This rank's linear index along ``axis`` (a tuple: the first name
        the slowest, as the reference's ``_linear_index``)."""
        idx = 0
        for a in self._axes(axis):
            idx = idx * self.sizes[a] + self.coords[a]
        return idx

    def _group(self, axis):
        axes = self._axes(axis)
        key = axes[0] if len(axes) == 1 else axes
        if key not in self.groups:
            raise ValueError(f"the mesh has no process group over {axes} (it has "
                             f"one per axis and one over {self.axis_names})")
        return self.groups[key]

    def _count(self, op, t, t0):
        m = self.moved[op]
        m[0] += 1
        m[1] += t.numel() * t.element_size()
        m[2] += time.perf_counter() - t0

    def _reduce(self, x, axis, op, name, fresh=False):
        """All-reduce of ``x`` (a copy, unless ``fresh`` says the caller
        hands over a buffer of its own). Gloo reduces no 16-bit float on
        the card, so there a bf16 or f16 tensor is reduced as an f32 copy
        and rounded back: a sum of two ranks' values is then the one
        rounding the 16-bit add makes."""
        t0 = time.perf_counter()
        wide = (self.backend == "gloo" and x.is_cuda
                and x.dtype in (torch.bfloat16, torch.float16))
        if wide:
            buf = x.float().contiguous()
        else:
            buf = x.contiguous() if fresh else x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, op=op, group=self._group(axis))
        self._count(name, buf, t0)
        return buf.to(x.dtype) if wide else buf

    def all_reduce(self, x, axis, op: str = "sum"):
        """The sum (or ``op="max"``) of ``x`` over the ranks along
        ``axis``, on every one of them; ``x`` is left as it is."""
        if self.axis_size(axis) == 1:
            return x
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        return self._reduce(x, axis, red, f"all_reduce_{op}")

    def all_gather(self, x, axis, dim: int):
        """The ranks' ``x`` along ``axis`` concatenated on ``dim`` in their
        order (tiled), on every rank, bitwise in any dtype: the parts travel
        as their bit patterns (an integer view of the buffer, each byte one
        rank's or zero, so the sum carries nothing)."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        dim = dim % x.dim()
        shape = list(x.shape)
        shape[dim] *= n
        full = x.new_zeros(shape)
        i, step = self.axis_index(axis), x.shape[dim]
        full.narrow(dim, i * step, step).copy_(x)
        got = self._reduce(_words(full), axis, dist.ReduceOp.SUM, "all_gather", fresh=True)
        return got.view(torch.uint8).view(full.dtype).view(full.shape)

    def broadcast(self, x, axis, src: int):
        """The ``x`` of the rank at index ``src`` along ``axis``, on every rank
        of the axis: the others hand in a buffer of its shape and dtype (its
        content is not read) and get it back filled. Bitwise in any dtype
        (the bytes travel as an integer view)."""
        if self.axis_size(axis) == 1:
            return x
        t0 = time.perf_counter()
        group = self._group(axis)
        buf = x.contiguous()
        words = _words(buf)
        dist.broadcast(words, src=dist.get_global_rank(group, src), group=group)
        self._count("broadcast", words, t0)
        return words.view(torch.uint8).view(buf.dtype).view(buf.shape)

    def barrier(self):
        """Every rank of the mesh waits for the others."""
        dist.barrier(group=self._group(self.axis_names))

    def reduce_scatter(self, x, axis, dim: int):
        """The sum of the ranks' ``x`` along ``axis``, this rank keeping its
        slice of ``dim`` (tiled: slice i of n equal ones)."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        dim = dim % x.dim()
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                             f"does not split over {n} ranks")
        step, i = x.shape[dim] // n, self.axis_index(axis)
        full = self._reduce(x, axis, dist.ReduceOp.SUM, "reduce_scatter")
        return full.narrow(dim, i * step, step).contiguous()

    def _block_axes(self, dims: dict) -> tuple:
        """The mesh axes that ``dims`` ({dim: axis name}) name, in the mesh's
        order (the key of their process group)."""
        named = set(dims.values())
        return tuple(a for a in self.axis_names if a in named)

    def all_gather_blocks(self, x, dims: dict):
        """The whole of a tensor whose ranks each hold one block of it:
        ``dims`` maps each sharded dimension of ``x`` to the mesh axis that
        splits it (one axis a dimension), block i of n along a dimension on
        the rank whose index along its axis is i. One sum over the ranks of
        those axes, bitwise in any dtype (as ``all_gather``: each rank's
        bytes in their place, zeros elsewhere)."""
        axes = self._block_axes(dims)
        if self.axis_size(axes) == 1:
            return x
        shape = list(x.shape)
        for d, ax in dims.items():
            shape[d] *= self.sizes[ax]
        full = x.new_zeros(shape)
        part = full
        for d, ax in dims.items():
            part = part.narrow(d, self.coords[ax] * x.shape[d], x.shape[d])
        part.copy_(x)
        got = self._reduce(_words(full), axes, dist.ReduceOp.SUM, "all_gather", fresh=True)
        return got.view(torch.uint8).view(full.dtype).view(full.shape)

    def reduce_scatter_blocks(self, x, dims: dict):
        """The sum of the ranks' ``x`` over the axes that ``dims`` names,
        this rank keeping its block (the reverse of ``all_gather_blocks``):
        one sum, so each element is rounded once."""
        axes = self._block_axes(dims)
        if self.axis_size(axes) == 1:
            return x
        for d, ax in dims.items():
            if x.shape[d] % self.sizes[ax]:
                raise ValueError(f"reduce_scatter_blocks: dim {d} of {tuple(x.shape)} "
                                 f"does not split over {ax}")
        part = self._reduce(x, axes, dist.ReduceOp.SUM, "reduce_scatter")
        for d, ax in dims.items():
            step = x.shape[d] // self.sizes[ax]
            part = part.narrow(d, self.coords[ax] * step, step)
        return part.contiguous()

    def stats(self) -> dict:
        """{collective: {"calls", "bytes", "s"}} so far on this rank."""
        return {k: {"calls": c, "bytes": b, "s": s}
                for k, (c, b, s) in sorted(self.moved.items())}


def _words(t):
    """A contiguous tensor's bytes as int32 words where they divide into
    them, else as uint8 (a view; the types every backend moves)."""
    flat = t.reshape(-1).view(torch.uint8)
    return flat.view(torch.int32) if flat.numel() % 4 == 0 else flat


def make_local_mesh(model_parallel: int = 1, *, device=None) -> Mesh:
    """The default process group as ``data x model`` (``world //
    model_parallel`` x ``model_parallel``), with one process group per
    axis. Every rank must call it, in the same order as its other group
    creations. ``device``: the rank's device (default: the current card
    where there is one, else the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialised default "
                           "process group (mesh.spawn starts one per rank)")
    n, rank = dist.get_world_size(), dist.get_rank()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel={model_parallel}")
    shape = (n // model_parallel, model_parallel)
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    grid = [[d * shape[1] + m for m in range(shape[1])] for d in range(shape[0])]
    coords = {"data": rank // shape[1], "model": rank % shape[1]}
    groups = {}
    # every rank makes every group, in one order (dist.new_group is collective)
    for d in range(shape[0]):
        g = dist.new_group(grid[d], timeout=_timeout)
        if coords["data"] == d:
            groups["model"] = g
    for m in range(shape[1]):
        g = dist.new_group([grid[d][m] for d in range(shape[0])], timeout=_timeout)
        if coords["model"] == m:
            groups["data"] = g
    groups[AXES] = dist.group.WORLD
    return Mesh(AXES, shape, coords, groups, torch.device(device), backend)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def tp_axis(mesh) -> str | None:
    return "model" if "model" in mesh.axis_names else None


def free_port() -> int:
    """A TCP port on the loopback that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# what every rank imports, loaded once in the fork server
_PRELOAD = ["torch", "torch._dynamo", "torch.utils.checkpoint", "torch.distributed"]


def start_fork_server() -> None:
    """Starts the fork server that ``spawn``'s ranks fork from, if it is
    not running, with ``_PRELOAD`` imported in it (a caller that spawns
    later may start it early, so that the imports overlap its own work).
    The server touches no CUDA; it ends when this process does, or at
    ``stop_fork_server``."""
    from multiprocessing import forkserver
    forkserver.set_forkserver_preload(_PRELOAD)
    forkserver.ensure_running()


def stop_fork_server() -> None:
    """Ends the fork server, if this process started one."""
    from multiprocessing import forkserver
    server = forkserver._forkserver
    if server._forkserver_pid is not None:
        server._stop()


def _rank_main(rank, fn, world, backend, devices, port, args, timeout):
    global _timeout
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # the ranks meet on the loopback: a sealed machine may have no other
    # interface that its own hostname resolves to
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    _timeout = None if timeout is None else datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank, timeout=_timeout)
    try:
        fn(rank, world, device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *, backend: str, device, args=(),
          timeout: float | None = None) -> None:
    """Runs ``fn(rank, world, device, *args)`` in ``world`` new processes,
    forked from the fork server (``start_fork_server``), each a rank of one
    default process group (``backend``, on a free loopback port), and
    waits for all of them; a rank that raises makes this raise
    (``torch.multiprocessing.ProcessRaisedException``).

    ``fn`` must be a module-level function (it is pickled by name).
    ``device``: each rank's device, one for all (``"cpu"``, ``"cuda:0"``)
    or a list, one per rank. NCCL needs a card per rank; ranks that share
    one card, or run on the CPU, use gloo. ``timeout``: seconds that any
    collective (and the meeting at the start) may wait before it raises,
    in every group the ranks open (default: the backend's, 30 minutes for
    gloo), so that a rank left waiting on one that died fails soon.
    """
    devices = [device] * world if isinstance(device, (str, torch.device)) \
        else list(device)
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    devices = [str(d) for d in devices]
    if backend == "nccl" and len(set(devices)) != world:
        raise ValueError("nccl needs a card of its own for each rank; ranks "
                         "that share a card (or the CPU) use gloo")
    import torch.multiprocessing as mp
    start_fork_server()
    mp.start_processes(_rank_main, args=(fn, world, backend, devices, free_port(), args,
                                         timeout),
                       nprocs=world, join=True, start_method="forkserver")
