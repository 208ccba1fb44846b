"""Flash attention, forward and backward, through hand-written CUDA kernels
(port of ``htr_vt_tpu/models/vit.py:flash_mha``, which calls the library
Pallas kernel ``jax.experimental.pallas.ops.tpu.flash_attention``).

    o, l, m = flash_attention_fwd(q, k, v, scale)        K5f
    di      = sum_d o * do                               (plain torch)
    dk, dv  = flash_attention_bwd_dkv(q, k, v, l, m, do, di, scale)   K5dkv
    dq      = flash_attention_bwd_dq(q, k, v, l, m, do, di, scale)    K5dq

q, k, v, o, do: [B, H, N, D] (bf16 or float32, one dtype), N a multiple
of 128; l, m, di: float32 [B, H, N]. The arithmetic is the library's, at
its default 128-key blocks (``flash_attention.py:342-481, 796-938,
1146-1284``):

- forward, per 128-key block: ``s = (q k^T) * scale`` in float32 from the
  input dtype's products; the running max ``m`` and sum ``l`` advance; the
  **unnormalised** ``p = exp(s - m)`` is cast to v's dtype before ``p v``;
  the float32 accumulator is rescaled by ``l_corr / l_next`` and gains
  ``(p v) / l_next``; the output is cast to q's dtype. With one key block
  (N = 128) the library normalises first: ``p = exp(s - m) / l``, cast,
  then ``p v`` (``_flash_attention_kernel_single_batch_single_step``).
- backward: ``p = exp(s - m) * (1 / l)``, ``dv += T(p)^T do``, ``dp = do
  v^T``, ``ds = (dp - di) * p * scale``, ``dk += T(ds)^T q`` and ``dq +=
  T(ds) k``, T the input dtype, in float32, cast once at the end.

Each wrapper launches its kernel (``csrc/flash_attn.cu``) for CUDA tensors
and runs its plain version for CPU tensors; nothing else decides. The
forward goes through the custom op ``htrvt::flash_attention_fwd``
(``ops/library.py``) on both devices, so an exported program holds it, a failed
build or launch raises, and there is no fallback on the card. The kernels
take every head_dim that is a multiple of 128 (``takes_head_dim``): bf16 at
128 and 256 on wgmma, bf16 past 256 and float32 on FFMA. q, k and v may be the strided views that the qkv
split makes (the last dim contiguous): the kernels read them through their
strides, with no copy. K5f writes o as a [B, N, H, D] tensor seen as [B, H,
N, D], so the heads merge back into [B, N, H * D] without a copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from htr_vt_torch.ops import library as htrvt_ops

BLOCK = 128  # the library's default block sizes (BlockSizes.get_default)
HEAD_DIM_STEP = 128  # the kernels take every multiple of it (768 / 6, 1536 / 6, ...)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def takes_head_dim(d: int) -> bool:
    """Whether the K5 kernels take head_dim ``d``: every positive multiple
    of 128 (the output slices a block makes). ``resolve_attn_impl`` asks
    this before it routes a site to them."""
    return d >= HEAD_DIM_STEP and d % HEAD_DIM_STEP == 0


# --- plain versions ------------------------------------------------------------
def _check_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash attention: q, k, v must be one [B, H, N, D] shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    n = q.shape[2]
    if n % BLOCK:
        raise ValueError(f"flash attention: N must be a multiple of {BLOCK} (the "
                         f"kernel's blocks), got N={n}")
    return n // BLOCK


def _keys(t: torch.Tensor, j: int) -> torch.Tensor:
    return t[:, :, j * BLOCK:(j + 1) * BLOCK]


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K5f: (o in q.dtype [B, H, N, D], l, m float32
    [B, H, N]), block by block with the library's rounding points."""
    nk = _check_plain(q, k, v)
    qf = q.float()
    if nk == 1:  # the single-step kernel normalises before the cast
        s = torch.matmul(qf, k.float().transpose(-1, -2)) * scale
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        p = p / l
        o = torch.matmul(p.to(v.dtype).float(), v.float())
        return o.to(q.dtype), l[..., 0], m[..., 0]
    m = torch.full(q.shape[:3] + (1,), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j in range(nk):
        s = torch.matmul(qf, _keys(k, j).float().transpose(-1, -2)) * scale
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        acc = acc * (l_corr * inv)
        acc = acc + torch.matmul(p.to(v.dtype).float(), _keys(v, j).float()) * inv
        m, l = m_next, l_next
    return acc.to(q.dtype), l[..., 0], m[..., 0]


def _probs_and_ds(q, k, v, l, m, do, di, scale, j):
    """Key block j's ``p = exp(s - m) * (1 / l)`` and ``ds = (dp - di) * p
    * scale``, float32 [B, H, N, 128], as both backward kernels recompute
    them."""
    s = torch.matmul(q.float(), _keys(k, j).float().transpose(-1, -2)) * scale
    p = torch.exp(s - m[..., None]) * (1.0 / l)[..., None]
    dp = torch.matmul(do.float(), _keys(v, j).float().transpose(-1, -2))
    return p, (dp - di[..., None]) * p * scale


def flash_attention_dkv_reference(q, k, v, l, m, do, di, scale
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5dkv: (dk in k.dtype, dv in v.dtype)."""
    nk = _check_plain(q, k, v)
    dk, dv = [], []
    for j in range(nk):
        p, ds = _probs_and_ds(q, k, v, l, m, do, di, scale, j)
        dv.append(torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float()))
        dk.append(torch.matmul(ds.to(do.dtype).float().transpose(-1, -2), q.float()))
    return torch.cat(dk, 2).to(k.dtype), torch.cat(dv, 2).to(v.dtype)


def flash_attention_dq_reference(q, k, v, l, m, do, di, scale) -> torch.Tensor:
    """Plain version of K5dq: dq in q.dtype."""
    nk = _check_plain(q, k, v)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j in range(nk):
        _, ds = _probs_and_ds(q, k, v, l, m, do, di, scale, j)
        dq = dq + torch.matmul(ds.to(k.dtype).float(), _keys(k, j).float())
    return dq.to(q.dtype)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``di = sum_d o * do`` in float32 [B, H, N] (``flash_attention.py:273-
    275``, outside every kernel there too)."""
    return (o.float() * do.float()).sum(-1)


def flash_attention_bwd_reference(q, k, v, o, l, m, do, scale
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward: (dq, dk, dv) from the forward's o, l and m."""
    di = attention_delta(o, do)
    dk, dv = flash_attention_dkv_reference(q, k, v, l, m, do, di, scale)
    return flash_attention_dq_reference(q, k, v, l, m, do, di, scale), dk, dv


# --- kernel wrappers -----------------------------------------------------------
def _check(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           do: Optional[torch.Tensor] = None, **stats: torch.Tensor) -> None:
    """What the kernels take: q, k, v (and do) of one [B, H, N, D] shape and
    dtype (bf16 or float32) on one CUDA device, N a multiple of 128, D a
    multiple of 128 (``takes_head_dim``), the last dim contiguous and the rest 16-byte strides; the ``stats``
    (l, m, di) contiguous float32 [B, H, N]. Shapes, dtypes and strides
    only: ``_check_aligned`` reads the addresses."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{fn}: q must be bfloat16 or float32, got {q.dtype}")
    _check_plain(q, k, v)
    d = q.shape[3]
    if not takes_head_dim(d):
        raise ValueError(f"{fn}: the K5 kernels take a head_dim that is a multiple "
                         f"of {HEAD_DIM_STEP} (128, 256, 384, 512, ...), got head_dim {d}")
    inputs = {"q": q, "k": k, "v": v, **({} if do is None else {"do": do})}
    for name, t in inputs.items():
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{fn}: {name} must be {q.dtype} {tuple(q.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    rows = tuple(q.shape[:3])
    for name, t in stats.items():
        if t.dtype != torch.float32 or tuple(t.shape) != rows or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous float32 {rows}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in {**inputs, **stats}.items():
        if t.device != q.device:
            raise ValueError(f"{fn}: all inputs must be on one device, {name} is on "
                             f"{t.device} and q on {q.device}")
    if not torch.compiler.is_exporting():
        _check_strides(fn, **inputs)


def _check_strides(fn: str, **inputs: torch.Tensor) -> None:
    """A contiguous last dim and 16-byte strides. Under a ``torch.export``
    trace ``_check`` leaves this to the launch, where the strides are the
    real tensors' and not a fake tensor's."""
    for name, t in inputs.items():
        if t.stride(3) != 1 or any((st * t.element_size()) % 16 for st in t.stride()[:3]):
            raise ValueError(f"{fn}: {name} needs a contiguous last dim and 16-byte "
                             f"strides, got strides {t.stride()}")


def _check_aligned(fn: str, **tensors: torch.Tensor) -> None:
    """Every input starts on a 16-byte boundary (the kernels' TMA maps);
    read where the kernel launches, since a fake tensor has no address."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned")


def _strides(*tensors: torch.Tensor):
    """The element strides (b, h, n) of each [B, H, N, D] tensor, as the
    C array the launchers read."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch(name: str, fn: str, q: torch.Tensor, *args) -> None:
    from htr_vt_torch._build import check_launch, library
    b, h, n, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(library(), name)(*args, b, h, n, d, _DTYPE_CODES[q.dtype],
                                       stream)
    check_launch(fn, err)


def _route(fn: str, q: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {q.device}")
    return True


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(o, l, m) of softmax(q k^T * scale) v.

    Calls the op ``htrvt::flash_attention_fwd`` (``ops/library.py``): CUDA
    tensors launch K5f on the current stream and add one to
    ``flash_attention_fwd.launches``; CPU tensors run
    ``flash_attention_reference``. Any other device raises."""
    if _route("flash_attention_fwd", q):
        _check("flash_attention_fwd", q, k, v)
    return htrvt_ops.flash_attention_fwd(q, k, v, float(scale))


def launch_flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5f on the current stream (the CUDA implementation of
    ``htrvt::flash_attention_fwd``). An exported program calls it without
    the wrapper, so the real tensors' strides and addresses are checked
    here."""
    _check_strides("flash_attention_fwd", q=q, k=k, v=v)
    _check_aligned("flash_attention_fwd", q=q, k=k, v=v)
    b, h, n, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    l = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    _launch("htrvt_flash_fwd", "flash_attention_fwd", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(),
            _strides(q, k, v, o), ctypes.c_float(scale))
    flash_attention_fwd.launches += 1
    return o, l, m


flash_attention_fwd.launches = 0  # kernel launches; the CPU path never counts


def flash_attention_bwd_dkv(q, k, v, l, m, do, di, scale
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), contiguous [B, H, N, D] in k's dtype.

    CUDA tensors launch K5dkv (one block per 128 keys, looping over the
    query blocks) and add one to ``flash_attention_bwd_dkv.launches``; CPU
    tensors run ``flash_attention_dkv_reference``. Any other device
    raises."""
    if not _route("flash_attention_bwd_dkv", q):
        return flash_attention_dkv_reference(q, k, v, l, m, do, di, scale)
    _check("flash_attention_bwd_dkv", q, k, v, do, l=l, m=m, di=di)
    _check_aligned("flash_attention_bwd_dkv", q=q, k=k, v=v, do=do, l=l, m=m, di=di)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _launch("htrvt_flash_bwd_dkv", "flash_attention_bwd_dkv", q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), l.data_ptr(), m.data_ptr(), do.data_ptr(),
            di.data_ptr(), dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, do),
            ctypes.c_float(scale))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0  # kernel launches; the CPU path never counts


def flash_attention_bwd_dq(q, k, v, l, m, do, di, scale) -> torch.Tensor:
    """dq, contiguous [B, H, N, D] in q's dtype.

    CUDA tensors launch K5dq (one block per 128 queries, looping over the
    key blocks; no atomics) and add one to ``flash_attention_bwd_dq.launches``;
    CPU tensors run ``flash_attention_dq_reference``. Any other device
    raises."""
    if not _route("flash_attention_bwd_dq", q):
        return flash_attention_dq_reference(q, k, v, l, m, do, di, scale)
    _check("flash_attention_bwd_dq", q, k, v, do, l=l, m=m, di=di)
    _check_aligned("flash_attention_bwd_dq", q=q, k=k, v=v, do=do, l=l, m=m, di=di)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("htrvt_flash_bwd_dq", "flash_attention_bwd_dq", q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), l.data_ptr(), m.data_ptr(), do.data_ptr(),
            di.data_ptr(), dq.data_ptr(), _strides(q, k, v, do), ctypes.c_float(scale))
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0  # kernel launches; the CPU path never counts


# --- autograd and the entry point ------------------------------------------------
class FlashAttention(torch.autograd.Function):
    """K5f forward; K5dkv and K5dq backward, with ``di`` in plain torch
    between them (``_flash_attention_bwd``, ``flash_attention.py:254-317``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, l, m = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        if do.stride(-1) != 1:  # e.g. the expanded gradient of a sum
            do = do.contiguous()
        di = attention_delta(o, do)
        dk, dv = flash_attention_bwd_dkv(q, k, v, l, m, do, di, ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, l, m, do, di, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v for q, k, v [B, H, N, D] -> [B, H, N, D] in
    q's dtype, differentiable in q, k and v (``flash_attention(q, k, v,
    sm_scale=scale)``, no bias, mask or segment ids, not causal)."""
    return FlashAttention.apply(q, k, v, float(scale))
