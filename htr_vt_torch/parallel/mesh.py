"""The process group and its collectives (port of
``htr_vt_tpu/parallel/mesh.py``).

JAX expresses data parallelism as sharding: one global batch split over a
``data`` mesh axis, parameters replicated, and XLA inserting the
collectives a global mean loss needs. Here each process is one rank of a
``torch.distributed`` group and holds ``train_bs // world`` rows; the port
makes the collectives JAX's program makes, by hand:

- the stem's and the conv blocks' BatchNorm sums, all-reduced before the
  statistics are formed (``all_reduce_sum``, differentiable: sum forward,
  sum backward), as K2's SPMD wrapper psums them
  (``htr_vt_tpu/ops/bn_stats.py:98-103``) and XLA reduces every other BN
  over the global array (``htr_vt_tpu/models/stem.py:11-14``);
- each SAM pass's gradient list, mean-all-reduced once
  (``all_reduce_mean_``): with the summed BN sums this is the gradient of
  the global mean loss;
- eval's predictions and per-row losses (``all_gather_rows``), the resume
  path (``broadcast_str``) and the exit and checkpoint barriers.

``DistributedDataParallel`` and ``nn.SyncBatchNorm`` do not fit: the SAM
step takes its gradients with ``torch.autograd.grad``, which DDP's reducer
never sees, and the BatchNorms are the port's own (K2's sums or float32
means), which ``SyncBatchNorm`` would replace.

Every helper returns its input unchanged at world size 1 and then makes no
call into ``torch.distributed``. Under gloo the helpers hand CUDA tensors to
the collectives as they are: gloo takes them for all-reduce, all-gather,
broadcast and barrier (``chip_smoke.py``'s data-parallel phase runs each on
the card), so ranks can share a card over gloo.

The grid (``init_mesh``): ``mesh_shape=(R, M)`` puts rank r at data index
``r // M`` and model index ``r % M``, JAX's device order
(``htr_vt_tpu/parallel/mesh.py:66-76``). The collectives above run over the
data group (the ranks that share a model index); without a model axis the
data group is the world, and the calls are the ones made before the grid
existed. The model axis is Megatron-style tensor parallelism of every
model's attention and MLP layers (``param_sharding_rules``,
``shard_model``): a qkv and an fc1 are column-sharded (by head for qkv),
an attention's proj and an fc2 row-sharded. ``copy_to_model`` /
``reduce_from_model`` make the one sum a sharded sublayer needs forward
and the one it needs backward; where JAX leaves the proj after a sharded
qkv replicated (Swin, SVTR, the decoder's self-attention),
``gather_from_model`` brings the heads' outputs together before it. Int8
serving takes its row sites' scales over the whole input
(``model_max``) and sums their int32 products over the model group.

The model axis also shards the image's width (``shard_width``,
``rank_width``), as JAX's ``train_step`` runs on an image placed
``P("data", None, "model", None)`` and GSPMD partitions the stem
(``tests/test_parallel.py:180-199``). Model index m holds columns ``[m *
W / M, (m + 1) * W / M)`` of every row its data index holds. The port
makes GSPMD's collectives by hand, for every model's stem (``width_stem``:
the ResNet18 and VAN stems, Swin's and SVTR's): each window along the
width reads its neighbours' edge columns (``halo_extend``), its BatchNorm
sums run over the whole mesh (``all_reduce_sum(..., "mesh")``), the input
LayerNorm's over the model group, int8 scales take the max over the model
group, and the stem's tokens are gathered over the model group before
masking (``gather_from_model``), so that the encoder, the head and the
loss see the whole line on every rank of a model group. Each rank's stem
gradient covers its strip, and the step sums it over the model group
(``width_sharded_mask``, ``all_reduce_model_sum_``). Under remat "all"
the stem's recompute replays its exchanges and all-reduces inside the
backward, in the forward's order on every rank.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

COORDINATOR = "HTRVT_COORDINATOR"
NUM_PROCESSES = "HTRVT_NUM_PROCESSES"
PROCESS_ID = "HTRVT_PROCESS_ID"
# How long a rank waits for the others at a rendezvous or a collective.
TIMEOUT = datetime.timedelta(minutes=10)
MAX_BROADCAST_BYTES = 4096


def default_backend(device=None, nproc: int = 1) -> str:
    """``nccl`` for a CUDA device (the card unless ``device`` says
    otherwise) with a card for every one of ``nproc`` ranks; ``gloo`` for
    the CPU, and for ranks that share cards (NCCL refuses two ranks on one
    device)."""
    cuda = torch.cuda.is_available() if device is None else \
        torch.device(device).type == "cuda"
    return "nccl" if cuda and nproc <= torch.cuda.device_count() else "gloo"


def maybe_initialize_distributed(backend: Optional[str] = None, device=None) -> None:
    """Join the process group that the ``HTRVT_*`` variables describe
    (``mesh.py:32-63``): ``HTRVT_COORDINATOR`` (host:port of rank 0),
    ``HTRVT_NUM_PROCESSES`` and ``HTRVT_PROCESS_ID``. Without a coordinator
    it does nothing, as JAX's; a second call, or a group the caller made
    itself, is left as it is. The backend is ``backend``, else
    ``default_backend(device, HTRVT_NUM_PROCESSES)``."""
    if dist.is_initialized():
        return
    coordinator = os.environ.get(COORDINATOR)
    nproc = int(os.environ.get(NUM_PROCESSES, "1"))
    if not coordinator:
        if nproc > 1:
            raise ValueError(f"{NUM_PROCESSES}={nproc} needs {COORDINATOR} "
                             "(host:port of rank 0)")
        return
    rank = int(os.environ.get(PROCESS_ID, "0"))
    backend = backend or default_backend(device, nproc)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=nproc, rank=rank, timeout=TIMEOUT)


def world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_size() -> int:
    return world()[1]


@dataclass(frozen=True)
class Grid:
    """The ranks of a ``(data, model)`` mesh: this rank's (index, size) on
    each axis and the groups it belongs to."""

    shape: Tuple[int, int]
    data: Tuple[int, int]
    model: Tuple[int, int]
    data_group: object
    model_group: object


# The grid ``init_mesh`` made; None means no model axis (the data axis is the
# world).
_GRID: Optional[Grid] = None


def check_mesh(mesh_shape: Optional[Sequence[int]], size: int) -> Tuple[int, int]:
    """``ParallelConfig.mesh_shape`` against a world of ``size`` processes,
    as (R, M): None is ``(size, 1)``, ``(R,)`` is ``(R, 1)``; R * M must
    equal the world size, else ValueError."""
    if mesh_shape is None:
        return size, 1
    shape = tuple(int(v) for v in mesh_shape)
    if len(shape) not in (1, 2) or min(shape) < 1:
        raise ValueError(f"mesh_shape={shape}: expected (data,) or (data, model)")
    r, m = (shape + (1,))[:2]
    if r * m != size:
        raise ValueError(f"mesh_shape={shape}: data x model = {r * m} must equal the "
                         f"world size, {size} process(es)")
    return r, m


def init_mesh(mesh_shape: Optional[Sequence[int]]) -> None:
    """Lay the world out as ``mesh_shape`` (``check_mesh``). Without a model
    axis this only checks the shape: the data axis is the world. With one,
    every rank creates the M data groups (the ranks ``{d * M + m}`` of one
    model index m) and then the R model groups (the ranks ``d * M ...
    d * M + M - 1`` of one data index d), in that fixed order, as
    ``dist.new_group`` requires; a second call with the same shape keeps
    the groups it made."""
    global _GRID
    rank, size = world()
    r, m = check_mesh(mesh_shape, size)
    if m == 1:
        _GRID = None
        return
    if _GRID is not None and _GRID.shape == (r, m):
        return
    data_groups = [dist.new_group([d * m + j for d in range(r)]) for j in range(m)]
    model_groups = [dist.new_group([d * m + j for j in range(m)]) for d in range(r)]
    _GRID = Grid(shape=(r, m), data=(rank // m, r), model=(rank % m, m),
                 data_group=data_groups[rank % m], model_group=model_groups[rank // m])


def data_world() -> Tuple[int, int]:
    """(index, size) on the data axis: the world without a model axis,
    (0, 1) without a process group."""
    return _GRID.data if _GRID is not None else world()


def model_world() -> Tuple[int, int]:
    """(index, size) on the model axis: (0, 1) without a model axis."""
    return _GRID.model if _GRID is not None else (0, 1)


def _data_group():
    """The data group; None, the default group, without a model axis."""
    return _GRID.data_group if _GRID is not None else None


def rank_rows(draw, batch: int) -> torch.Tensor:
    """A random draw of the global batch, this rank's rows of it:
    ``draw(n)`` draws for n rows, here ``batch * R`` of them over the R
    ranks of the data axis, and data index r keeps rows ``[r * batch,
    (r + 1) * batch)``. JAX draws a keep mask or a dropout mask for the
    global array and shards it (``htr_vt_tpu/models/htr_vt.py:106-108``);
    so, with one seeded generator on every rank, R ranks draw what one
    process draws for the whole batch. At data size 1, ``draw(batch)``."""
    rank, size = data_world()
    if size == 1:
        return draw(batch)
    return draw(batch * size)[rank * batch:(rank + 1) * batch]


def rank_cols(draw, width: int) -> torch.Tensor:
    """``rank_rows`` for a last dimension sharded over the model axis:
    ``draw(w)`` draws with a last dimension of w, here ``width * M``, and
    model index m keeps columns ``[m * width, (m + 1) * width)``: the M
    ranks draw what one process draws for the whole width, and the
    generator advances as it does there. At model size 1, ``draw(width)``."""
    index, size = model_world()
    if size == 1:
        return draw(width)
    return draw(width * size)[..., index * width:(index + 1) * width]


def comm_device() -> torch.device:
    """Where a helper puts a tensor it makes itself: the current card under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    if group is None:
        dist.all_reduce(t, op=op)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group's ranks; its gradient is the sum over the ranks of
    the gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), group=ctx.group), None


def all_reduce_sum(x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """The differentiable sum of ``x`` over ``axis``: ``"data"`` (the data
    group), ``"model"`` (the model group) or ``"mesh"`` (every rank); ``x``
    itself where that axis has size 1."""
    if axis == "data":
        size, group = data_world()[1], _data_group()
    elif axis == "model":
        size = model_world()[1]
        group = _GRID.model_group if size > 1 else None
    elif axis == "mesh":
        size, group = world_size(), None
    else:
        raise ValueError(f"axis={axis!r}: expected 'data', 'model' or 'mesh'")
    if size == 1:
        return x
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def _sum_packed_(tensors: Sequence[torch.Tensor], group, div: int = 1) -> None:
    """Replace each tensor in place by its sum over ``group`` divided by
    ``div``: one flattened all-reduce per dtype and device."""
    by_kind: dict = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for same in by_kind.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        _all_reduce_(flat, group=group)
        if div != 1:
            flat.div_(div)
        torch._foreach_copy_(same, [v.view_as(t) for v, t in zip(
            flat.split([t.numel() for t in same]), same)])


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor in place by its mean over the data axis: one
    flattened all-reduce per dtype and device (nothing at data size 1)."""
    size = data_world()[1]
    if size > 1:
        _sum_packed_(tensors, _data_group(), size)


def _all_gather(x: torch.Tensor, size: int, group) -> List[torch.Tensor]:
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(size)]
    if group is None:
        dist.all_gather(out, x)
    else:
        dist.all_gather(out, x, group=group)
    return out


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows of every data rank's ``x`` (one shape on every rank), data
    index 0's first."""
    size = data_world()[1]
    if size == 1:
        return x
    return torch.cat(_all_gather(x, size, _data_group()))


# --- the model axis ---------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """The identity forward; backward, the sum over the model group of the
    gradients, since each rank's sharded sublayer reads the whole input."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), group=_GRID.model_group)


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward (of a row-sharded linear's
    partial outputs); backward, the identity."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce_(x.contiguous().clone(), group=_GRID.model_group)

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Enter a tensor-parallel sublayer: ``x`` forward, the model group's
    sum of the gradients backward (``x`` itself at model size 1)."""
    return x if model_world()[1] == 1 else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Leave a tensor-parallel sublayer: the model group's sum of the
    partial outputs forward, the gradient as it is backward (``x`` itself at
    model size 1)."""
    return x if model_world()[1] == 1 else _ReduceFromModel.apply(x)


class _GatherFromModel(torch.autograd.Function):
    """The model group's tensors side by side on one dimension, in rank
    order, forward; backward, this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, dim):
        index, size = model_world()
        ctx.index, ctx.dim, ctx.width = index, dim, x.shape[dim]
        return torch.cat(_all_gather(x, size, _GRID.model_group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width), None


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every model rank's ``x`` concatenated on ``dim`` forward, this rank's
    slice of the gradient backward (``x`` itself at model size 1). It
    leaves a column-sharded sublayer whose output a replicated layer reads
    whole (the heads' outputs ahead of a replicated proj, on the last
    dimension), and gathers a width-sharded stem's tokens (on the width).
    The backward takes a slice and sums nothing: the gradient of what is
    gathered is the same on every rank of the group, whether the layers
    after it are replicated or enter their shards through
    ``copy_to_model``."""
    return x if model_world()[1] == 1 else _GatherFromModel.apply(x, dim)


class _HaloExtend(torch.autograd.Function):
    """``halo_extend``'s exchange: one all-gather of every rank's edge
    columns forward, one of the halos' gradients backward."""

    @staticmethod
    def forward(ctx, x, left, right):
        index, size = model_world()
        w = x.shape[-1]
        ctx.index, ctx.size, ctx.w, ctx.left, ctx.right = index, size, w, left, right
        # what the left neighbour reads as its right halo, then the right
        # neighbour's left halo
        edges = _all_gather(torch.cat([x[..., :right], x[..., w - left:]], dim=-1),
                            size, _GRID.model_group)
        lo, hi = (left if index > 0 else 0), (right if index < size - 1 else 0)
        parts = ([edges[index - 1][..., right:]] if lo else []) + [x] + (
            [edges[index + 1][..., :right]] if hi else [])
        ctx.lo, ctx.hi = lo, hi
        ext = torch.cat(parts, dim=-1)
        if x.is_contiguous(memory_format=torch.channels_last) and x.dim() == 4:
            ext = ext.contiguous(memory_format=torch.channels_last)
        return ext

    @staticmethod
    def backward(ctx, g):
        index, size, w, left, right = ctx.index, ctx.size, ctx.w, ctx.left, ctx.right
        lo, hi = ctx.lo, ctx.hi
        shape = (*g.shape[:-1], left + right)
        sent = g.new_zeros(shape)
        if lo:  # the left halo's gradient belongs to the left neighbour's last columns
            sent[..., right:] = g[..., :lo]
        if hi:  # the right halo's, to the right neighbour's first columns
            sent[..., :right] = g[..., lo + w:]
        got = _all_gather(sent, size, _GRID.model_group)
        dx = g[..., lo:lo + w].clone()
        if index < size - 1 and left:
            dx[..., w - left:] += got[index + 1][..., right:]
        if index > 0 and right:
            dx[..., :right] += got[index - 1][..., :right]
        return dx, None, None


def halo_extend(x: torch.Tensor, left: int = 1, right: int = 1
                ) -> Tuple[torch.Tensor, int, int]:
    """This rank's strip of columns (the last dimension) with ``left``
    columns of its left neighbour's before it and ``right`` of its right
    neighbour's after it, on the model axis: (the extended tensor, the
    columns added on the left, on the right). A strip at the image's edge
    gets nothing on that side, so a window op that pads by itself pads
    there as on the whole image; its outputs at halo columns are then
    cropped. Differentiable: the gradient of a halo column goes back to the
    rank that owns the column and is added there. One all-gather of each
    rank's edge columns over the model group, forward and backward (gloo's
    point-to-point calls take CPU tensors only; an all-gather takes CUDA
    tensors under gloo and NCCL alike). A 4-d channels-last strip gives a
    channels-last tensor. At model size 1, ``(x, 0, 0)``."""
    if model_world()[1] == 1:
        return x, 0, 0
    index, size = model_world()
    if max(left, right) > x.shape[-1]:
        raise ValueError(f"a halo of {max(left, right)} columns exceeds a strip of "
                         f"{x.shape[-1]}")
    ext = _HaloExtend.apply(x, left, right)
    return ext, (left if index > 0 else 0), (right if index < size - 1 else 0)


@torch.no_grad()
def model_sum(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` summed over the model group, not differentiable
    (``x`` itself at model size 1)."""
    if model_world()[1] == 1:
        return x
    return _all_reduce_(x.contiguous().clone(), group=_GRID.model_group)


def all_reduce_model_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor in place by its sum over the model group: one
    flattened all-reduce per dtype and device (nothing at model size 1)."""
    if model_world()[1] > 1:
        _sum_packed_(tensors, _GRID.model_group)


@torch.no_grad()
def model_max(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x``, the elementwise max over the model group (``x``
    itself at model size 1): the abs-max of a tensor whose columns are
    sharded, from each rank's own."""
    if model_world()[1] == 1:
        return x
    return _all_reduce_(x.contiguous().clone(), op=dist.ReduceOp.MAX,
                        group=_GRID.model_group)


class Shard(NamedTuple):
    """How a parameter is split over the model axis: ``kind`` "column"
    (output features or heads) or "row" (input features), along torch
    dimension ``dim``; that dimension is ``groups`` blocks (q, k and v for
    qkv) and each block is split in M contiguous parts, rank m keeping
    part m of every block."""

    kind: str
    dim: int
    groups: int = 1


def param_sharding_rules(name: str, tensor: torch.Tensor) -> Optional[Shard]:
    """The tensor-parallel layout of the parameter ``name`` (a
    ``named_parameters`` name), or None for a replicated one: JAX's rules
    (``htr_vt_tpu/parallel/mesh.py:104-123``), which test substrings of the
    joined path, tested on the dotted name. JAX's kernels are ``[in,
    out]`` and column-sharded on their last dimension; torch's
    ``nn.Linear.weight`` is ``[out, in]``, so a column shard splits torch
    dimension 0 and a row shard dimension 1.

    - ``qkv`` (an attention's, Swin's, SVTR's, the decoder's ``self_qkv``)
      and ``fc1`` (an MLP's, the squeeze-excite's): column-sharded. qkv's
      rows are ``[3, H, head_dim]``, so its shard is head-aligned: rank m
      keeps q, k and v of heads ``[m * H / M, (m + 1) * H / M)``, not a
      contiguous slice.
    - a ``proj`` with ``attn`` in its name (``attn``, ``local_attn``,
      ``global_attn``) and an ``fc2``: the weight row-sharded (its input
      columns are ``[H, head_dim]`` or the hidden units, in order).

    Two kinds of leaf the port shards beyond JAX's, which shards kernels
    alone (ndim >= 2): a column-sharded linear's bias, which keeps its
    local columns; and a head-indexed relative-bias table ``rel_bias``
    (``[positions, H]``: the window and global attentions', Swin's), by
    head, the heads qkv keeps, since each rank reads only those columns
    and a replicated table would get another gradient on each rank. A
    row-sharded linear's bias is replicated, added once after the sum.
    """
    if name.rpartition(".")[2] == "rel_bias":
        return Shard("column", 1)
    if "qkv" in name:
        return Shard("column", 0, 3)
    if "fc1" in name:
        return Shard("column", 0)
    if tensor.dim() >= 2 and (("attn" in name and "proj" in name) or "fc2" in name):
        return Shard("row", 1)
    return None


def shard_tensor(t: torch.Tensor, spec: Shard, index: int, size: int) -> torch.Tensor:
    """Part ``index`` of ``size`` of ``t`` under ``spec``, a new tensor."""
    n = t.shape[spec.dim]
    if n % (spec.groups * size):
        raise ValueError(f"a dimension of {n} ({spec.groups} block(s)) does not split "
                         f"over a model axis of {size}")
    k = n // spec.groups // size
    lead, tail = t.shape[:spec.dim], t.shape[spec.dim + 1:]
    blocks = t.reshape(*lead, spec.groups, n // spec.groups, *tail)
    part = blocks.narrow(spec.dim + 1, index * k, k)
    return part.reshape(*lead, spec.groups * k, *tail).clone()


def unshard_tensors(parts: Sequence[torch.Tensor], spec: Shard) -> torch.Tensor:
    """The whole tensor from every model rank's part, in rank order: the
    inverse of ``shard_tensor``."""
    t = parts[0]
    k = t.shape[spec.dim] // spec.groups
    lead, tail = t.shape[:spec.dim], t.shape[spec.dim + 1:]
    blocks = [p.reshape(*lead, spec.groups, k, *tail) for p in parts]
    whole = torch.cat(blocks, dim=spec.dim + 1)
    return whole.reshape(*lead, spec.groups * k * len(parts), *tail)


def gather_model(t: torch.Tensor, spec: Shard) -> torch.Tensor:
    """The whole tensor of a sharded one, on every rank of the model
    group."""
    size = model_world()[1]
    return unshard_tensors(_all_gather(t.detach(), size, _GRID.model_group), spec)


def _tensor_parallel(module) -> bool:
    return getattr(module, "model_shards", 1) > 1


def _sharded_modules(model) -> List[Tuple[str, torch.nn.Module]]:
    """(name, module) of every module that splits its heads or hidden
    units over the model axis: those with a ``model_shards`` attribute."""
    return [(name, m) for name, m in model.named_modules()
            if hasattr(type(m), "model_shards")]


def check_tensor_parallel(model, size: int) -> None:
    """Raise ``ValueError`` unless a model axis of ``size`` divides the
    heads (``num_heads``) and hidden units (``fc1``'s outputs) of every
    module that ``shard_model`` splits, naming the first that it does
    not."""
    for name, m in _sharded_modules(model):
        heads = getattr(m, "num_heads", None)
        fc1 = getattr(m, "fc1", None)
        hidden = None if fc1 is None else fc1.out_features
        if (heads and heads % size) or (hidden and hidden % size):
            what = " and ".join(f"{w} {n}" for n, w in (("heads", heads),
                                                       ("hidden units", hidden)) if w)
            raise ValueError(f"{name or type(model).__name__} ({type(m).__name__}): "
                             f"{what} must divide over a model axis of {size}")


@torch.no_grad()
def shard_model(model):
    """Shard ``model`` in place over the model axis (JAX's
    ``shard_params``): each parameter ``param_sharding_rules`` names keeps
    this rank's part, and every module with a ``model_shards`` attribute
    (the attentions, the MLPs, the squeeze-excite, Swin's, SVTR's and the
    decoder's blocks) learns the axis's size. Any model ``build_model``
    builds shards; heads or hidden units the axis does not divide raise
    (``check_tensor_parallel``). Returns ``model``; at model size 1 it is
    left as it is. Shard before an optimizer takes the parameters, and copy
    the EMA model after."""
    index, size = model_world()
    if size == 1:
        return model
    check_tensor_parallel(model, size)
    for name, p in list(model.named_parameters()):
        spec = param_sharding_rules(name, p)
        if spec is not None:
            owner_name, leaf = name.rpartition(".")[::2]
            owner = model.get_submodule(owner_name)
            setattr(owner, leaf, torch.nn.Parameter(shard_tensor(p, spec, index, size),
                                                    requires_grad=p.requires_grad))
    for _, m in _sharded_modules(model):
        m.model_shards = size
    model.model_shards = size
    return model


def _sharded_names(model) -> Dict[str, Shard]:
    return {name: spec for name, p in model.named_parameters()
            if (spec := param_sharding_rules(name, p)) is not None}


def sharded_mask(model) -> Optional[List[bool]]:
    """For each of ``model.parameters()``, whether it is sharded over the
    model axis; None for a model that is not sharded."""
    if not _tensor_parallel(model):
        return None
    names = _sharded_names(model)
    return [name in names for name, _ in model.named_parameters()]


def gather_state_dict(model) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` in the one-process layout: a sharded
    parameter all-gathered over the model group (every rank of the group
    must call this). A model that is not sharded gives its own."""
    sd = model.state_dict()
    if not _tensor_parallel(model):
        return sd
    names = _sharded_names(model)
    return {k: gather_model(v, names[k]) if k in names else v for k, v in sd.items()}


def shard_state_dict(model, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A one-process ``sd`` cut to this rank's parts for the sharded
    ``model`` (``sd`` itself for a model that is not sharded)."""
    if not _tensor_parallel(model):
        return sd
    index, size = model_world()
    names = _sharded_names(model)
    return {k: shard_tensor(v, names[k], index, size) if k in names else v
            for k, v in sd.items()}


def _optimizer_params(model, sd) -> Dict[int, Shard]:
    """The optimizer-state index of each sharded parameter: the optimizer
    holds ``model.parameters()`` in order, in one group."""
    names = _sharded_names(model)
    ids = [i for group in sd["param_groups"] for i in group["params"]]
    return {i: names[name] for i, (name, _) in zip(ids, model.named_parameters())
            if name in names}


def gather_optimizer_state(model, optimizer) -> Dict:
    """``optimizer.state_dict()`` in the one-process layout: the moments of
    each sharded parameter all-gathered over the model group."""
    sd = optimizer.state_dict()
    if not _tensor_parallel(model):
        return sd
    specs = _optimizer_params(model, sd)
    state = {i: {k: gather_model(v, specs[i]) if i in specs and v.dim() > 0 else v
                 for k, v in st.items()} for i, st in sd["state"].items()}
    return {**sd, "state": state}


def shard_optimizer_state(model, sd: Dict) -> Dict:
    """A one-process optimizer ``sd`` cut to this rank's parts."""
    if not _tensor_parallel(model):
        return sd
    index, size = model_world()
    specs = _optimizer_params(model, sd)
    state = {i: {k: shard_tensor(v, specs[i], index, size) if i in specs and v.dim() > 0
                 else v for k, v in st.items()} for i, st in sd["state"].items()}
    return {**sd, "state": state}


# --- the width (spatial) axis ------------------------------------------------------
def check_width(width: int, size: int, halo: int = 1) -> None:
    """A global image width ``width`` that ``size`` model ranks can share:
    every strip a whole number of tokens (the stems quarter the width) and
    every stride-2 strip starting on an even column, so ``width % (4 *
    size) == 0``; and a strip of the quarter-width map at least ``halo``
    columns wide, the most a window there reads from a neighbour (a VAN
    stem's dilated 7x7: 9). Else ValueError, naming the width, M and the
    halo."""
    if width % (4 * size):
        raise ValueError(f"an image width of {width} px does not split over a model "
                         f"axis of {size}: width sharding needs width % (4 * {size}) "
                         "== 0")
    if width // (4 * size) < halo:
        raise ValueError(f"an image width of {width} px over a model axis of {size} "
                         f"leaves strips of {width // (4 * size)} columns at a quarter of "
                         f"the width, narrower than the stem's halo of {halo} columns")


def _trunk(model):
    """The model that holds the stem: the model, or an encoder-decoder's
    trunk (an ``HTRVT``)."""
    from htr_vt_torch.models.encoder_decoder import HTREncoderDecoder
    return model.encoder if isinstance(model, HTREncoderDecoder) else model


def width_stem(model) -> List[nn.Module]:
    """The modules that run on a width strip, before the tokens' gather:
    ``HTRVT.patch_embed`` (the ResNet18 stem or a ``VanStem``), ``HTRSwin``'s
    ``stem`` and ``proj``, ``SVTR``'s ``embed_conv1/2`` and ``embed_bn1/2``."""
    from htr_vt_torch.models.svtr import SVTR
    from htr_vt_torch.models.swin import HTRSwin
    trunk = _trunk(model)
    if isinstance(trunk, HTRSwin):
        return [trunk.stem, trunk.proj]
    if isinstance(trunk, SVTR):
        return [trunk.embed_conv1, trunk.embed_bn1, trunk.embed_conv2, trunk.embed_bn2]
    return [trunk.patch_embed]


def width_halo(model) -> int:
    """The most neighbour columns a window of ``model``'s stem reads at a
    quarter of the width (``check_width``'s ``halo``)."""
    return max(getattr(m, "width_halo", 1) for m in width_stem(model))


def shard_width(model):
    """Shard the image's width over the model axis for ``model`` (every
    model ``build_model`` builds: ``HTRVT`` behind the ResNet18 or a VAN
    stem, ``HTRSwin``, ``SVTR``, an encoder-decoder through its trunk; float
    or int8, under any remat): its stem (``width_stem``) and an ``HTRVT``'s
    input LayerNorm run on this rank's strip of columns (``rank_width``),
    and the stem's tokens are gathered before masking. The weights stay as
    they are, so it composes with ``shard_model`` (the encoder
    tensor-parallel after the gather) or without it (the encoder replicated
    over the model group, JAX's layout in
    ``tests/test_parallel.py:180-199``). The configured width
    (``cfg.img_size``) must split with the stem's halo (``check_width``);
    each forward checks its own image's. Returns ``model``; at model size 1
    it is left as it is. Mark the EMA copy too (``create_train_state`` does
    both with ``width_parallel``)."""
    size = model_world()[1]
    if size == 1:
        return model
    trunk = _trunk(model)
    check_width(trunk.cfg.img_size[1], size, width_halo(model))
    for stem in width_stem(model):
        for m in stem.modules():
            if hasattr(type(m), "width_sharded"):
                m.width_sharded = True
    trunk.width_shards = size
    return model


def width_sharded_mask(model) -> Optional[List[bool]]:
    """For each of ``model.parameters()``, whether it is the stem's, whose
    gradient a rank holds for its strip only; None for a model whose width
    is not sharded."""
    if getattr(_trunk(model), "width_shards", 1) == 1:
        return None
    stem = {id(p) for m in width_stem(model) for p in m.parameters()}
    return [id(p) in stem for p in model.parameters()]


def rank_width(batch):
    """This rank's columns of a batch's ``image`` ([B, H, W, 1], a tensor
    or an array): model index m keeps ``[m * W / M, (m + 1) * W / M)``;
    every other key as it is (the ranks of a model group hold the same
    rows). The width must split (``check_width``). At model size 1, the
    batch itself."""
    index, size = model_world()
    if size == 1:
        return batch
    image = batch["image"]
    check_width(image.shape[2], size)
    w = image.shape[2] // size
    return {**batch, "image": image[:, :, index * w:(index + 1) * w]}


def broadcast_str(s: Optional[str]) -> Optional[str]:
    """Rank 0's string (or None) on every rank (``loop.py:260-271``)."""
    if world_size() == 1:
        return s
    buf = torch.zeros(MAX_BROADCAST_BYTES, dtype=torch.uint8)
    if s:
        b = s.encode()
        if len(b) > MAX_BROADCAST_BYTES:  # never truncate a checkpoint path
            raise ValueError(f"broadcast string exceeds {MAX_BROADCAST_BYTES} "
                             f"bytes: {s!r}")
        buf[:len(b)] = torch.frombuffer(bytearray(b), dtype=torch.uint8)
    buf = buf.to(comm_device())
    dist.broadcast(buf, src=0)
    out = bytes(buf.cpu().tolist()).rstrip(b"\x00").decode()
    return out or None


def barrier() -> None:
    """Wait for every rank (nothing at world size 1)."""
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


@torch.no_grad()
def assert_same_on_every_rank(tensors: Iterable[torch.Tensor], what: str) -> None:
    """Raise unless ``tensors`` hold the same values on every rank: a
    float64 checksum of each, its largest and smallest over ranks from one
    all-reduce (nothing at world size 1)."""
    if world_size() == 1:
        return
    sums = torch.stack([t.detach().double().sum().cpu() for t in tensors])
    both = torch.cat([sums, -sums]).to(comm_device())
    _all_reduce_(both, op=dist.ReduceOp.MAX)
    both = both.cpu()
    n = len(sums)
    if not (torch.equal(both[:n], sums) and torch.equal(-both[n:], sums)):
        raise AssertionError(f"{what} differ between ranks (rank {dist.get_rank()}); "
                             "every rank must start from one seed")
