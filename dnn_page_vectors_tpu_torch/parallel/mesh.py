"""The mesh of a training job: one process a card, its ranks laid out on
a (data, model, seq) grid, and the collectives that carry gradients.

Counterpart of the JAX package's parallel/mesh.py. There XLA inserts the
collectives of one SPMD program; here each rank is a process of its own
(``torchrun --nproc-per-node N``), and the collectives are explicit:

* ``multihost_init`` forms the process group (NCCL on cards, gloo for
  tensors on the CPU, as in the tests);
* ``make_mesh`` lays the ranks out as the JAX package lays out its
  devices, ``reshape(data, model, seq)`` of the ranks in order, and
  creates a process group for each line of each axis and one for the
  ranks that hold the same parameter shard (data x seq), which carries
  the gradient all-reduce. Every rank creates every group, in the same
  order, as torch.distributed requires;
* ``fit_mesh_to_devices`` shrinks a config's mesh to the ranks there are,
  as the JAX package's does.

The gradient convention. The training objective is the sum over the
data x seq ranks of each rank's own loss (models/losses.py gives each
data rank its rows' share of the global loss; the trainer divides it by
the seq size, since the ranks of a seq group compute the same rows).
Under that convention the backward of a collective is its adjoint summed
over the ranks: an all-gather's backward all-reduces the gradient and
keeps this rank's slice (``all_gather_sum_grad``), an all-reduce's
backward all-reduces (``all_reduce_sum_grad``). Each rank's parameter
gradients are then its share of the global gradient, and their sum over
the data x seq group (``all_reduce_``) is the single card's gradient.
The model axis keeps the tensor-parallel convention of Megatron-LM
instead: every rank of a model group holds the same activations and the
same gradients of replicated parameters, through ``copy_reduce_grad``
before a column-parallel matmul (identity forward, all-reduce backward),
``all_reduce_identity_grad`` after a row-parallel one (all-reduce
forward, identity backward) and ``all_gather_split_grad`` after the
feature-split embedding (all-gather forward, slice backward).

In one process every group is None and every collective is the
identity, so a single card runs exactly the code it ran before.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from dnn_page_vectors_tpu_torch.config import MeshConfig

# a collective that waits longer than this raises instead of hanging
DEFAULT_TIMEOUT_S = 600.0
# the gradient all-reduce's bucket: one collective a bucket
BUCKET_BYTES = 64 << 20


def world() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank() -> Optional[int]:
    """torchrun's LOCAL_RANK (this process's card on its host), or None."""
    value = os.environ.get("LOCAL_RANK")
    return None if value is None else int(value)


def multihost_init(init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None,
                   backend: Optional[str] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Forms the process group of a job of several processes, one a card.

    The arguments default to torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT; ``init_method`` "env://"). With
    one process (WORLD_SIZE unset or 1) it does nothing and returns False.
    ``backend`` defaults to "nccl" where CUDA is available, which also
    makes ``cuda:LOCAL_RANK`` the current card, and to "gloo" elsewhere.
    A group that does not form raises: a job launched with several ranks
    never trains alone. Every collective of the group raises after
    ``timeout_s`` seconds instead of hanging. Returns True once the group
    is formed (or was already)."""
    if dist.is_initialized():
        return True
    size = int(world_size if world_size is not None
               else os.environ.get("WORLD_SIZE", "1"))
    if size <= 1:
        return False
    if rank is None:
        if "RANK" not in os.environ:
            raise RuntimeError(f"WORLD_SIZE={size} but RANK is not set: "
                               "launch with torchrun, or pass rank=")
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank() or 0)
    try:
        dist.init_process_group(
            backend, init_method=init_method or "env://", world_size=size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(
            f"the process group of {size} ranks ({backend}) did not form "
            f"at rank {rank}: {type(e).__name__}: {e}") from e
    return True


@dataclasses.dataclass
class Mesh:
    """This rank's place on the (data, model, seq) grid and its groups.

    Rank r sits at (d, m, s) with r = (d * model + m) * seq + s. A group
    is None where its line holds one rank. ``group("dp")`` holds the
    ranks with this rank's model index (the data x seq ranks that hold
    the same parameter shard); ``dp_rank`` is this rank's place in it."""
    data: int = 1
    model: int = 1
    seq: int = 1
    rank: int = 0
    groups: Dict[str, Optional[object]] = dataclasses.field(
        default_factory=dict)

    @property
    def size(self) -> int:
        return self.data * self.model * self.seq

    @property
    def coords(self) -> Tuple[int, int, int]:
        return coords(self.rank, self.model, self.seq)

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_index(self) -> int:
        return self.coords[1]

    @property
    def seq_index(self) -> int:
        return self.coords[2]

    @property
    def dp_size(self) -> int:
        return self.data * self.seq

    @property
    def dp_rank(self) -> int:
        d, _, s = self.coords
        return d * self.seq + s

    def group(self, axis: str):
        """The process group of `axis` ("data", "model", "seq" or "dp")
        through this rank, or None where it holds this rank alone."""
        return self.groups.get(axis)


def coords(rank: int, model: int, seq: int) -> Tuple[int, int, int]:
    return rank // (model * seq), (rank // seq) % model, rank % seq


def axis_lines(cfg: MeshConfig) -> Dict[str, List[List[int]]]:
    """Every line of ranks of each axis, and of the data x seq plane at
    each model index ("dp"), in a fixed order."""
    D, M, S = cfg.data, cfg.model, cfg.seq
    rank = lambda d, m, s: (d * M + m) * S + s
    return {
        "data": [[rank(d, m, s) for d in range(D)]
                 for m in range(M) for s in range(S)],
        "model": [[rank(d, m, s) for m in range(M)]
                  for d in range(D) for s in range(S)],
        "seq": [[rank(d, m, s) for s in range(S)]
                for d in range(D) for m in range(M)],
        "dp": [[rank(d, m, s) for d in range(D) for s in range(S)]
               for m in range(M)],
    }


def fit_mesh_to_devices(cfg: MeshConfig, n: int) -> MeshConfig:
    """Shrinks `cfg` to `n` ranks as the JAX package does: the model axis
    first (as large as divides n), then seq, then data."""
    model = min(cfg.model, n)
    while n % model:
        model -= 1
    rem = n // model
    seq = min(cfg.seq, rem)
    while rem % seq:
        seq -= 1
    rem //= seq
    data = min(cfg.data, rem)
    while rem % data:
        data -= 1
    return MeshConfig(data=data, model=model, seq=seq, strict=cfg.strict)


def make_mesh(cfg: MeshConfig) -> Mesh:
    """The mesh of this job: `cfg` fitted to the ranks of the process
    group (one rank outside a group). With ``cfg.strict`` a mesh of
    another size raises; without, it shrinks (``fit_mesh_to_devices``),
    and a mesh that does not use every rank raises, since an idle rank
    would wait at the first collective. A process launched as one of
    WORLD_SIZE > 1 ranks whose group has not formed raises."""
    rank, size = world()
    launched = int(os.environ.get("WORLD_SIZE", "1"))
    if launched > size:
        raise RuntimeError(
            f"WORLD_SIZE={launched} but this process is in a group of "
            f"{size}: call parallel.mesh.multihost_init() first (a rank "
            "never trains alone)")
    fitted = cfg
    if cfg.num_devices != size:
        if cfg.strict:
            raise RuntimeError(
                f"mesh.strict: the config wants {cfg.data}x{cfg.model}x"
                f"{cfg.seq} = {cfg.num_devices} ranks, the job has {size}")
        fitted = fit_mesh_to_devices(cfg, size)
        if fitted.num_devices != size:
            raise RuntimeError(
                f"mesh {cfg.data}x{cfg.model}x{cfg.seq} fits "
                f"{fitted.num_devices} of the job's {size} ranks; set "
                "mesh.data, mesh.model and mesh.seq to multiply to the "
                "world size")
    mesh = Mesh(fitted.data, fitted.model, fitted.seq, rank)
    if size > 1:
        # every rank creates every group, in one order
        for axis, lines in axis_lines(fitted).items():
            for line in lines:
                if len(line) < 2:
                    continue
                group = dist.new_group(line)
                if rank in line:
                    mesh.groups[axis] = group
    return mesh


# -- collectives ---------------------------------------------------------------

def group_size(group) -> int:
    """The ranks of `group`: 1 for None (a line of one rank)."""
    return 1 if group is None else dist.get_world_size(group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sum_grad):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        ctx.sum_grad = sum_grad
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        lo = dist.get_rank(ctx.group) * ctx.width
        return g.narrow(ctx.dim, lo, ctx.width).contiguous(), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sum_grad):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        ctx.group, ctx.sum_grad = group, sum_grad
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        return g, None, None


class _CopyReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_gather_sum_grad(x: torch.Tensor, group, dim: int = 0
                        ) -> torch.Tensor:
    """The group's `x` concatenated along `dim` in rank order; the
    backward sums the gradient over the group and keeps this rank's slice
    (the data axis: each rank's loss is its share of the global one)."""
    if group_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim % x.dim(), True)


def all_gather_split_grad(x: torch.Tensor, group, dim: int = -1
                          ) -> torch.Tensor:
    """The group's `x` concatenated along `dim`; the backward keeps this
    rank's slice of a gradient every rank holds whole (the model axis)."""
    if group_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim % x.dim(), False)


def all_reduce_sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group, whose backward also sums over it
    (the seq axis: the pool of a page whose tokens the group splits)."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group, True)


def all_reduce_identity_grad(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group, whose backward passes the gradient
    through (the model axis: after a row-parallel matmul)."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group, False)


def copy_reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """`x` itself, whose backward sums the gradient over the group (the
    model axis: before a column-parallel matmul, whose shards each give a
    part of the input's gradient)."""
    if group_size(group) == 1:
        return x
    return _CopyReduceGrad.apply(x, group)


def all_reduce_(tensors: Iterable[torch.Tensor], group) -> None:
    """Sums each tensor over the group in place, a flat bucket of up to
    BUCKET_BYTES (of one dtype and device) per collective, in the
    tensors' order; nothing without a group."""
    if group_size(group) == 1:
        return
    bucket: List[torch.Tensor] = []
    nbytes = 0

    def flush():
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        bucket.clear()

    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype
                       or t.device != bucket[0].device
                       or nbytes + t.numel() * t.element_size()
                       > BUCKET_BYTES):
            flush()
            nbytes = 0
        bucket.append(t)
        nbytes += t.numel() * t.element_size()
    flush()
