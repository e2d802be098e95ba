"""Process groups, the device mesh and the global batch, over
``torch.distributed``: the counterpart of the JAX package's
``parallel/mesh.py``.

Each rank is one process with one device (``init_distributed``). A
:class:`Mesh` lays the ranks out over named axes, the data axis first and
the model axis (``parallel/tp.py``) innermost, so rank ``r = d * tp + m``,
and holds a process group for each axis. Every rank iterates the same
global batch stream and keeps the rows of its data index
(``shard_batch``), as ``NamedSharding(P("data"))`` places them.

Under GSPMD a loss over a batch-sharded input is the loss of the global
batch. Inside ``data_parallel(mesh)`` the losses get that too:
``global_sums`` and ``global_mean`` all-reduce their numerators and
denominators over the data group, so every rank holds the global value of
each loss term while its gradient flows to that rank's rows alone; the
train step then sums the ranks' gradients. ``draw_rows`` draws a per-row
random tensor for the global batch from a generator in the same state on
every rank and keeps this rank's rows: for the real rows alone when the
context is told how many there are before padding, so that the generator
moves as a single process's does and the padding rows draw zeros. Outside
the context (one process, or a mesh whose data axis has one rank) each is
the plain reduction or draw.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     device: Any = None) -> torch.device:
    """Join this process to the job and return its device.

    With no arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``
    through ``init_method="env://"``). The device is ``cuda:LOCAL_RANK``
    unless ``device`` names one; a CUDA device without a GPU raises. The
    backend is ``nccl`` on a CUDA device and ``gloo`` on the CPU unless
    ``backend`` names one; a backend that fails to initialise raises, and
    no other is tried."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else int(rank)
    world_size = int(env["WORLD_SIZE"]) if world_size is None else int(world_size)
    device = torch.device(f"cuda:{int(env.get('LOCAL_RANK', 0))}" if device is None
                          else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"init_distributed: rank {rank} was given {device} but no "
                               "CUDA device is present; pass device='cpu' for gloo on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return device


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a job."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main() -> bool:
    """Whether this process writes files and prints: rank 0, or no job."""
    return world()[0] == 0


class Mesh:
    """The ranks laid out over ``axes`` (name -> size, the last innermost):
    ``shape``, this rank's ``coords``, and ``group(axis)``, the process
    group of the ranks that differ from this one along ``axis`` alone
    (``None`` where the axis has one rank)."""

    def __init__(self, axes: dict, rank: int, groups: dict):
        self.shape = dict(axes)
        self.rank = rank
        self.size = int(np.prod(list(axes.values())))
        self.coords = dict(zip(axes, (int(c) for c in
                                      np.unravel_index(rank, tuple(axes.values())))))
        self._groups = groups

    def group(self, axis: str):
        return self._groups.get(axis)

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    @property
    def data_size(self) -> int:
        return self.axis_size(DATA_AXIS)

    @property
    def data_index(self) -> int:
        return self.index(DATA_AXIS)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def __repr__(self) -> str:
        return "x".join(f"{a}={s}" for a, s in self.shape.items())


def make_mesh(n: Optional[int] = None, axes: Optional[dict] = None) -> Mesh:
    """A mesh over every rank of the job (``n``, when given, must be the
    world size); by default one data axis. Every rank calls it, since it
    makes the axes' process groups."""
    rank, size = world()
    n = size if n is None else int(n)
    if n != size:
        raise ValueError(f"make_mesh: a mesh of {n} ranks in a job of {size}")
    axes = {DATA_AXIS: n} if axes is None else dict(axes)
    if int(np.prod(list(axes.values()))) != n:
        raise ValueError(f"mesh axes {axes} do not multiply to the {n} ranks")
    groups = {}
    if n > 1:
        grid = np.arange(n).reshape(tuple(axes.values()))
        for i, axis in enumerate(axes):
            if axes[axis] == 1:
                continue
            if axes[axis] == n:
                groups[axis] = dist.group.WORLD
                continue
            # every rank makes every group of the axis, in the same order
            lines = np.moveaxis(grid, i, -1).reshape(-1, axes[axis])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[axis] = g
    return Mesh(axes, rank, groups)


# -- the batch -------------------------------------------------------------------

def _map_leaves(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1


def pad_batch_to_multiple(batch: Any, multiple: int) -> Any:
    """Pad the leading dim of every array leaf (numpy or torch) with
    all-zero rows up to a multiple of ``multiple``; the losses weigh such
    rows 0 through their nonpadding weights."""

    def pad(x):
        if not _is_array(x):
            return x
        rem = (-x.shape[0]) % multiple
        if rem == 0:
            return x
        if isinstance(x, np.ndarray):
            return np.pad(x, [(0, rem)] + [(0, 0)] * (x.ndim - 1))
        return torch.cat([x, x.new_zeros((rem,) + tuple(x.shape[1:]))])

    return _map_leaves(pad, batch)


def shard_batch(batch: Any, mesh: Mesh, axis: str = DATA_AXIS) -> Any:
    """This rank's rows of every array leaf: the contiguous block
    ``[i * B / n, (i + 1) * B / n)`` of its index ``i`` along ``axis``, as
    ``NamedSharding(P(axis))`` splits the leading dim. A leaf whose leading
    dim does not divide stays whole."""
    n, i = mesh.axis_size(axis), mesh.index(axis)

    def rows(x):
        if n == 1 or not _is_array(x) or x.shape[0] % n:
            return x
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return _map_leaves(rows, batch)


def replicate_tree(tree: Any, mesh: Mesh) -> Any:
    """Every tensor leaf set, in place, to rank 0's value (one broadcast
    over the whole job a dtype); every rank calls it with a tree of the
    same shapes."""
    if mesh.size == 1:
        return tree
    leaves: list = []
    _map_leaves(lambda x: leaves.append(x) if isinstance(x, torch.Tensor) else None, tree)
    for dtype in sorted({x.dtype for x in leaves}, key=str):
        same = [x.data for x in leaves if x.dtype == dtype]
        flat = torch.cat([x.reshape(-1) for x in same])
        dist.broadcast(flat, src=0)
        for x, part in zip(same, flat.split([x.numel() for x in same])):
            x.copy_(part.view_as(x))
    return tree


def gather_axis(x: torch.Tensor, dim: int, mesh: Mesh, axis: str) -> torch.Tensor:
    """The concatenation along ``dim`` of every rank's ``x`` along mesh
    ``axis``, in the axis's order (an all-gather; every rank of the group
    calls it)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim)


def to_host_local(tree: Any, mesh: Optional[Mesh] = None, specs: Optional[dict] = None) -> Any:
    """Every tensor leaf of a dict tree on the CPU, whole: a leaf that
    ``specs`` (leaf name -> its dim split over the model axis, or None)
    marks as split is all-gathered along that dim first, which makes this a
    collective that every rank calls together (the data axis's ranks hold
    the same values)."""
    specs = specs or {}

    def fetch(name, x):
        if not isinstance(x, torch.Tensor):
            return x
        dim = specs.get(name)
        if dim is not None and mesh is not None:
            x = gather_axis(x, dim, mesh, "model")
        return x.detach().cpu()

    if isinstance(tree, dict):
        return {k: fetch(k, v) for k, v in tree.items()}
    return fetch(None, tree)


# -- the global batch inside a loss -------------------------------------------------

_ACTIVE: list = []


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh], rows: Optional[int] = None):
    """Within: the losses' reductions and the per-row draws cover the
    global batch across ``mesh``'s data axis, whose first ``rows`` rows are
    real and the rest padding (all real when None; see the module doc)."""
    _ACTIVE.append((mesh, rows))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_data_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``data_parallel``, if its data axis has
    more than one rank."""
    mesh = _ACTIVE[-1][0] if _ACTIVE else None
    return mesh if mesh is not None and mesh.data_size > 1 else None


def global_sums(*xs: torch.Tensor) -> Sequence[torch.Tensor]:
    """Each 0-d ``x`` summed over the data group, in float32, by one
    all-reduce: the value is the global sum on every rank, the gradient
    that of this rank's ``x``. Outside ``data_parallel`` the ``xs`` as
    they are."""
    mesh = active_data_mesh()
    if mesh is None:
        return xs
    local = [x.float().reshape(()) for x in xs]
    totals = torch.stack([v.detach() for v in local])
    dist.all_reduce(totals, group=mesh.group(DATA_AXIS))
    return tuple(v + (s - v.detach()) for v, s in zip(local, totals.unbind()))


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch, in ``x``'s dtype (the
    mean of every rank's ``x`` elements; ``x.mean()`` outside
    ``data_parallel``)."""
    mesh = active_data_mesh()
    if mesh is None:
        return x.mean()
    (total,) = global_sums(x.float().sum())
    return (total / (x.numel() * mesh.data_size)).to(x.dtype)


def draw_rows(b: int, draw: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """``draw(n)`` gives ``n`` rows; this rank's ``b`` of the global
    batch's ``b * data size``, drawn for its real rows and zero for its
    padding rows (``draw(b)`` outside ``data_parallel``)."""
    mesh = active_data_mesh()
    if mesh is None:
        return draw(b)
    total = b * mesh.data_size
    real = _ACTIVE[-1][1] or total
    full = draw(real)
    if real < total:
        full = torch.cat([full, full.new_zeros((total - real,) + tuple(full.shape[1:]))])
    i = mesh.data_index
    return full[i * b:(i + 1) * b]


def local_rows(x: torch.Tensor, b: int) -> torch.Tensor:
    """This rank's ``b`` rows of ``x``, a tensor of the global batch's rows
    (``x`` outside ``data_parallel`` or when it is not such a tensor)."""
    mesh = active_data_mesh()
    if mesh is None or not torch.is_tensor(x) or x.ndim == 0 or x.shape[0] != b * mesh.data_size:
        return x
    i = mesh.data_index
    return x[i * b:(i + 1) * b]


def all_reduce_grads(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Sum ``tensors`` in place over the data group, as one flat bucket."""
    if mesh is None or mesh.data_size == 1 or not tensors:
        return
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group(DATA_AXIS))
    torch._foreach_copy_(tensors, [f.view_as(t) for f, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])
