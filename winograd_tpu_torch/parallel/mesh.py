"""Meshes of ranks, their collectives, sharding tables and a world of ranks.

Port of winograd_tpu/parallel/mesh.py (make_mesh, block_shardings) and of
pipeline.py's make_pipe_mesh on torch.distributed, one process a rank. A
JAX mesh names the axes of an array of devices inside one program; here
each rank is a process of the default process group and the mesh lays the
ranks 0..n-1 out as an array with named axes, ("data", "model") or
("pipe",), row-major like the JAX package's reshape of its device list.
Along each axis the ranks that differ only in that coordinate share a
process group (torch.distributed.new_group), which the
collectives below take by the axis's name. torch.distributed.device_mesh's
init_device_mesh is PyTorch's own form of the same thing; the groups are
built here by hand so that a mesh may cover the first n ranks of a larger
world (the tests' smaller meshes are sub-groups of one spawned world) and so
that each collective is written out where the staging below can be read.

Each rank's device is explicit: the mesh carries it (`device`, "cuda" by
default, "cpu" in the tests), and every shard, activation and result of the
parallel functions lives on it.

The collectives are the four the JAX code uses, each on a named axis:
psum (and pmean) is all_reduce, all_gather is JAX's tiled all_gather (the
ranks' blocks concatenated along one dimension), axis_index is the rank's
coordinate, and ppermute, which the pipeline uses to hand activations to
the next stage, is send and recv between neighbours; broadcast plays the
part of the pipeline's final psum. reduce_from_axis and copy_to_axis are
psum written as torch.autograd.Functions, the two halves of the psums XLA
inserts into the channel-sharded train step: a sum of partial products
forward (its gradient passed back as it is), and the entry of a replicated
tensor into cut work (its partial gradients summed backward). On a gloo group (one card shared by
several ranks: NCCL refuses two ranks on one GPU) a CUDA tensor is staged
through a host copy for every collective: gloo's point-to-point and gather
operations take CPU tensors only, and one rule for all of them is easier to
read. On an NCCL group (one card a rank) CUDA tensors go as they are.
Either way the kernels run on the rank's device.

None of this can be captured in a CUDA graph (a gloo collective is host
code), so the engines serve eagerly under a mesh (engine.py).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from winograd_tpu_torch.kernels import _build

__all__ = [
    "Mesh", "all_gather", "axis_index", "block_shardings", "broadcast", "check_mesh",
    "copy_to_axis", "local_shard",
    "make_mesh", "make_pipe_mesh", "pmean", "psum", "recv", "reduce_from_axis",
    "resolve_device", "send", "spawn_world",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh: the axes' names and sizes, this rank's
    coordinate on each, the process group of each axis with its members'
    global ranks, and the device this rank computes on."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[dist.ProcessGroup, ...]
    members: Tuple[Tuple[int, ...], ...]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as a JAX mesh's shape."""
        return dict(zip(self.axis_names, self.sizes))

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r}")
        return self.axis_names.index(axis)

    def group(self, axis: str) -> dist.ProcessGroup:
        return self.groups[self._axis(axis)]

    def global_rank(self, axis: str, index: int) -> int:
        """The global rank at coordinate `index` along `axis`, this rank's
        other coordinates kept."""
        return self.members[self._axis(axis)][index]

    def to(self, device) -> "Mesh":
        """The same mesh and groups, computing on `device` (a CPU twin of a
        card's mesh runs the kernels' plain versions through the same
        collectives)."""
        return dataclasses.replace(self, device=_build.require_device(device))


def _mesh(shape: Sequence[int], axis_names: Sequence[str], device, backend) -> Optional[Mesh]:
    """The mesh of ranks 0..prod(shape)-1, row-major. Collective over the
    whole default group: every rank must call it, in the same order as
    every other mesh; ranks outside the mesh get None."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized default process group "
                           "(init_process_group, or spawn_world)")
    device = _build.require_device(device)
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"requested {n} ranks, the world has {world}")
    rank = dist.get_rank()
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    groups, members = [], []
    for a, size in enumerate(shape):
        mine, my_group = (), None
        # Every line of ranks along axis a: the other coordinates fixed. An
        # axis of one rank gets its groups too, so that every collective
        # runs on the backend asked for.
        for base in range(n):
            if (base // strides[a]) % size:
                continue
            line = tuple(base + i * strides[a] for i in range(size))
            group = dist.new_group(list(line), backend=backend)
            if rank in line:
                mine, my_group = line, group
        groups.append(my_group)
        members.append(mine)
    if rank >= n:
        return None
    coords = tuple((rank // stride) % size for stride, size in zip(strides, shape))
    return Mesh(tuple(axis_names), shape, coords, tuple(groups), tuple(members), device)


def make_mesh(n_devices: Optional[int] = None, model_axis: Optional[int] = None,
              device="cuda", backend: Optional[str] = None) -> Optional[Mesh]:
    """A ("data", "model") mesh over ranks 0..n_devices-1 (the whole world by
    default). model_axis defaults to 2 when n is even and above 1, else 1,
    the JAX package's default; n must divide by it. backend: the axis
    groups' (None: the default group's). Every rank of the world calls it;
    ranks outside the mesh get None."""
    n = n_devices or dist.get_world_size()
    if model_axis is None:
        model_axis = 2 if n % 2 == 0 and n > 1 else 1
    if n % model_axis:
        raise ValueError(f"{n} ranks do not divide by model_axis {model_axis}")
    return _mesh((n // model_axis, model_axis), ("data", "model"), device, backend)


def make_pipe_mesh(n_stages: int, device="cuda", backend: Optional[str] = None) -> Optional[Mesh]:
    """A ("pipe",) mesh over ranks 0..n_stages-1, one pipeline stage a rank;
    called on every rank of the world, None outside the mesh."""
    return _mesh((n_stages,), ("pipe",), device, backend)


def check_mesh(mesh) -> None:
    """Raise TypeError unless mesh is a Mesh."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a winograd_tpu_torch.parallel.Mesh, got "
                        f"{type(mesh).__name__}")


def resolve_device(mesh: Optional[Mesh], device) -> torch.device:
    """An entry point's device under an optional mesh: without one, `device`
    (_build.require_device); with one, the mesh's device, which `device`
    must name (its index may be left out). A mesh that is not a Mesh is a
    TypeError."""
    device = _build.require_device(device)
    if mesh is None:
        return device
    check_mesh(mesh)
    if device.type != mesh.device.type or (
            device.type == "cuda" and device.index not in (None, mesh.device.index)):
        raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
    return mesh.device


# --- collectives on a named axis --------------------------------------------------


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """The buffer a collective of `group` moves: a host copy of a CUDA tensor
    on a gloo group, else x itself, contiguous."""
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        return x.detach().cpu()
    return x.contiguous()


def axis_index(mesh: Mesh, axis: str) -> int:
    """This rank's coordinate along `axis` (JAX's lax.axis_index)."""
    return mesh.coords[mesh._axis(axis)]


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of x over the ranks of `axis` (lax.psum), on x's device. x
    is a temporary: it may be summed in place."""
    group = mesh.group(axis)
    buf = _wire(x, group)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


def pmean(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The mean of x over the ranks of `axis` (lax.pmean)."""
    return psum(x, mesh, axis) / mesh.shape[axis]


class _ReduceFrom(torch.autograd.Function):
    """psum forward, identity backward (reduce_from_axis)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """Identity forward, psum backward (copy_to_axis)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.clone(), ctx.mesh, ctx.axis), None, None


def reduce_from_axis(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over `axis` of the ranks' partial x (a product over a cut
    contraction), differentiable: the sum is the same on every rank of the
    axis, and so is its gradient, which passes back unchanged (the psum XLA
    inserts for a contraction over a sharded dimension)."""
    return _ReduceFrom.apply(x, mesh, axis)


def copy_to_axis(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x, the same on every rank of `axis`, entering work cut over the axis:
    the identity, whose backward sums the ranks' partial gradients over the
    axis, so the gradient of x is whole and the same on every rank (the
    psum XLA inserts in the transpose of a replicated operand)."""
    return _CopyTo.apply(x, mesh, axis)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = -1) -> torch.Tensor:
    """The ranks' x along `axis` concatenated along `dim`, in coordinate
    order (lax.all_gather(tiled=True)); every rank's x has one shape."""
    group = mesh.group(axis)
    buf = _wire(x, group)
    parts = [torch.empty_like(buf) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """Coordinate `src`'s x on every rank of `axis`; the other ranks pass a
    tensor of its shape and dtype to receive into."""
    group = mesh.group(axis)
    buf = _wire(x, group)
    dist.broadcast(buf, src=mesh.global_rank(axis, src), group=group)
    return buf.to(x.device)


def send(x: torch.Tensor, mesh: Mesh, axis: str, dst: int):
    """Start sending x to coordinate `dst` of `axis` (the pipeline's
    ppermute to the next stage); returns the request, whose wait() the
    caller calls before the end of the schedule. The request holds the
    buffer it sends (x, or its staged host copy) until then."""
    group = mesh.group(axis)
    buf = _wire(x, group)
    return _Send(dist.isend(buf, dst=mesh.global_rank(axis, dst), group=group), buf)


@dataclasses.dataclass
class _Send:
    work: object
    buf: torch.Tensor

    def wait(self) -> None:
        self.work.wait()


def recv(shape: Sequence[int], mesh: Mesh, axis: str, src: int,
         dtype=torch.float32) -> torch.Tensor:
    """A tensor of `shape` received from coordinate `src` of `axis`, on this
    rank's device."""
    group = mesh.group(axis)
    buf = torch.empty(tuple(shape), dtype=dtype, device=mesh.device)
    wire = _wire(buf, group)
    dist.recv(wire, src=mesh.global_rank(axis, src), group=group)
    return wire.to(mesh.device)


# --- sharding tables -----------------------------------------------------------------

# A spec names, for each dimension of an array, the mesh axis it is sharded
# over or None (jax.sharding.PartitionSpec's role).
Spec = Tuple[Optional[str], ...]


def local_shard(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of t under `spec`, contiguous, on the mesh's
    device: each dimension named by an axis is cut into that axis's size
    equal blocks and the block at this rank's coordinate kept. Every kernel
    wrapper takes contiguous operands, so the cut is copied once here."""
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} has more dimensions than the array {tuple(t.shape)}")
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        parts = mesh.shape[axis]
        if t.shape[dim] % parts:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not divide over "
                             f"{parts} ranks of {axis!r}")
        step = t.shape[dim] // parts
        t = t.narrow(dim, axis_index(mesh, axis) * step, step)
    return t.to(mesh.device).contiguous()


def block_shardings() -> Tuple[Spec, Dict[str, Spec]]:
    """The specs of (x, params) of a bottleneck block over a ("data",
    "model") mesh: x (N, H, W, Cio) batch over "data" and Cio over "model"
    (activations enter and leave the block channel-sharded; the skip add
    stays local); w_reduce row-sharded on Cin, w_expand column-sharded on
    Cout with its BN, the rest replicated. The JAX package's
    block_shardings, as a table (data_parallel.py reads it)."""
    x_spec = ("data", None, None, "model")
    param_specs = {
        "w_reduce": ("model", None),   # Cin (= Cio) sharded: a local partial GEMM
        "s_reduce": (None,), "b_reduce": (None,),
        "w_mid": (None, None, None, None),
        "u_mid": (None, None, None), "u2_mid": (None, None, None), "w9_mid": (None, None),
        "s_mid": (None,), "b_mid": (None,),
        "w_expand": (None, "model"),   # Cout (= Cio) sharded: the output stays sharded
        "s_expand": ("model",), "b_expand": ("model",),
    }
    return x_spec, param_specs


# --- a world of ranks -----------------------------------------------------------------


def _rank_main(rank: int, world: int, timeout: float, tmp: str, fn: Callable,
               args: tuple) -> None:
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(tmp, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_world(fn: Callable, world: int, args: tuple = (), timeout: float = 120.0) -> List:
    """Run fn(rank, world, *args) on `world` ranks, one process each, started
    by torch.multiprocessing's spawn method (a process holding threads or a
    CUDA context cannot be forked safely), and return the ranks' results in
    rank order. The default group is gloo (the ranks may share one card; a
    mesh may ask NCCL for its axes' groups, make_mesh's backend). The ranks
    meet on a FileStore in a temporary directory, so no TCP port is taken;
    `timeout` (seconds) goes to init_process_group,
    so a collective that hangs fails the rank. fn must be importable by
    name (a module-level function) and return what torch.save and
    torch.load(weights_only=True) carry: tensors, numbers, strings, and
    lists and dicts of them. A rank that raises fails the call
    (torch.multiprocessing.ProcessRaisedException), the others terminated."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(world, timeout, tmp, fn, tuple(args)),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=True)
                for r in range(world)]
