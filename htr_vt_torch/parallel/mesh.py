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
the card), so ranks can share a card over gloo. Tensor parallelism (the ``model`` axis) is
not ported: JAX's ``fit`` never shards parameters either
(``shard_params`` has no caller outside ``mesh.py``).
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

COORDINATOR = "HTRVT_COORDINATOR"
NUM_PROCESSES = "HTRVT_NUM_PROCESSES"
PROCESS_ID = "HTRVT_PROCESS_ID"
# How long a rank waits for the others at a rendezvous or a collective.
TIMEOUT = datetime.timedelta(minutes=10)
MAX_BROADCAST_BYTES = 4096
TENSOR_PARALLEL_ITEM = "ROADMAP.md queue 1, item 12: tensor parallelism"


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


def rank_rows(draw, batch: int) -> torch.Tensor:
    """A random draw of the global batch, this rank's rows of it:
    ``draw(n)`` draws for n rows, here ``batch * world`` of them, and rank r
    keeps rows ``[r * batch, (r + 1) * batch)``. JAX draws a keep mask or a
    dropout mask for the global array and shards it
    (``htr_vt_tpu/models/htr_vt.py:106-108``); so, with one seeded generator
    on every rank, R ranks draw what one process draws for the whole batch.
    At world size 1, ``draw(batch)``."""
    rank, size = world()
    if size == 1:
        return draw(batch)
    return draw(batch * size)[rank * batch:(rank + 1) * batch]


def check_mesh(mesh_shape: Optional[Sequence[int]], size: int) -> None:
    """``ParallelConfig.mesh_shape`` against the world: ``(R,)`` or
    ``(R, 1)`` must have R equal to the world size; a model axis above 1
    asks for tensor parallelism, which is not ported."""
    if mesh_shape is None:
        return
    shape = tuple(mesh_shape)
    if len(shape) not in (1, 2):
        raise ValueError(f"mesh_shape={shape}: expected (data,) or (data, model)")
    if len(shape) == 2 and shape[1] > 1:
        raise NotImplementedError(
            f"mesh_shape={shape}: a model axis above 1 (tensor parallelism) is not "
            f"ported to htr_vt_torch ({TENSOR_PARALLEL_ITEM})")
    if shape[0] != size:
        raise ValueError(f"mesh_shape={shape}: the data axis must equal the world "
                         f"size, {size} process(es)")


def comm_device() -> torch.device:
    """Where a helper puts a tensor it makes itself: the current card under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; its gradient is the sum over ranks of the gradients."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The differentiable sum of ``x`` over ranks (``x`` itself at world
    size 1)."""
    if world_size() == 1:
        return x
    return _AllReduceSum.apply(x)


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor in place by its mean over ranks: one flattened
    all-reduce per dtype and device (nothing at world size 1)."""
    size = world_size()
    if size == 1:
        return
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        _all_reduce_(flat).div_(size)
        torch._foreach_copy_(group, [v.view_as(t) for v, t in zip(
            flat.split([t.numel() for t in group]), group)])


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows of every rank's ``x`` (one shape on every rank), rank 0's
    first."""
    size = world_size()
    if size == 1:
        return x
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(out, x)
    return torch.cat(out)


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
