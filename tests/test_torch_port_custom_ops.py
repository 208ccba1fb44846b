"""The ``htrvt::`` custom ops (``htr_vt_torch/ops/library.py``) on the CPU:
``torch.library.opcheck`` on each of the four (schema, fake tensor,
autograd registration, AOT dispatch) at the shapes and layouts their
wrappers hand them; on the CPU each op runs its kernel's plain twin, bit for
bit; and each wrapper reaches its op on the CPU, so a trace records it. The
same ops against their kernels on the card: ``tests/test_torch_port_cuda.py``."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from htr_vt_torch.ops import conv_fused, flash_attn, library, pool_fused
from htr_vt_torch.ops import quant as q8

CL = torch.channels_last


def _x(shape, seed, dtype=torch.float32, layout=CL):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).contiguous(memory_format=layout)


def _terms(c, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(c, generator=g), torch.randn(c, generator=g)


def _s8(shape, seed, layout=CL):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).contiguous(
        memory_format=layout)


def _pool_args(c, dtype, layout):
    return (_x((2, c, 8, 12), 0, dtype, layout), *_terms(c, 1))


def _conv_args(cin, cout, prologue, dtype):
    x = _x((2, cin, 6, 10), 2, dtype)
    w = _x((cout, cin, 3, 3), 3, dtype, torch.contiguous_format)
    return (x, w, *(_terms(cin, 4) if prologue else (None, None)))


def _flash_args(n, d, dtype):
    return tuple(_x((2, 2, n, d), 5 + i, dtype, torch.contiguous_format) for i in range(3)
                 ) + (d ** -0.5,)


def _q1_args(kind, out_dtype, stride=(1, 1), k=3, padding=1):
    w = _s8((128, k, k, 64), 6, torch.contiguous_format)
    sx, dq = torch.tensor(0.02), torch.rand(128, generator=torch.Generator().manual_seed(7))
    if kind == "s8":
        return (_s8((2, 64, 8, 12), 8), w, sx, dq * 1e-3, list(stride), padding,
                out_dtype, None, None)
    x = _x((2, 64, 8, 12), 9, torch.bfloat16)
    terms = _terms(64, 10) if kind == "bf16+bn" else (None, None)
    return (x, w, sx, dq * 1e-3, list(stride), padding, out_dtype, *terms)


OPCHECK_CASES = {
    "pool_c16_bf16": (library.pool_bn_relu_fwd, _pool_args(16, torch.bfloat16, CL)),
    "pool_c12_f32": (library.pool_bn_relu_fwd, _pool_args(12, torch.float32, CL)),
    "pool_nchw": (library.pool_bn_relu_fwd,
                  _pool_args(16, torch.float32, torch.contiguous_format)),
    "conv_prologue_bf16": (library.conv3x3_bn_relu_fwd, _conv_args(16, 24, True,
                                                                   torch.bfloat16)),
    "conv_bare_f32": (library.conv3x3_bn_relu_fwd, _conv_args(12, 20, False,
                                                              torch.float32)),
    "flash_n128": (library.flash_attention_fwd, _flash_args(128, 128, torch.float32)),
    "flash_n256_bf16": (library.flash_attention_fwd, _flash_args(256, 128,
                                                                 torch.bfloat16)),
    "q1_s8_int32": (library.conv_int8, _q1_args("s8", torch.int32)),
    "q1_s8_f32_stride21": (library.conv_int8, _q1_args("s8", torch.float32, (2, 1))),
    "q1_s8_bf16_1x1": (library.conv_int8, _q1_args("s8", torch.bfloat16, (2, 2), 1, 0)),
    "q1_bf16_bn": (library.conv_int8, _q1_args("bf16+bn", torch.bfloat16)),
    "q1_bf16": (library.conv_int8, _q1_args("bf16", torch.float32)),
}


@pytest.mark.parametrize("case", sorted(OPCHECK_CASES))
def test_opcheck(case):
    op, args = OPCHECK_CASES[case]
    torch.library.opcheck(op, args)


def test_ops_live_in_one_namespace():
    for name in ("pool_bn_relu_fwd", "conv3x3_bn_relu_fwd", "flash_attention_fwd",
                 "conv_int8"):
        assert getattr(torch.ops.htrvt, name).default is getattr(library, name)._opoverload


def _equal(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.stride() == w.stride()
        assert torch.equal(g, w)


def test_cpu_ops_are_the_plain_twins():
    _equal(library.pool_bn_relu_fwd(*OPCHECK_CASES["pool_c12_f32"][1]),
           pool_fused.max_pool_bn_relu_reference(*OPCHECK_CASES["pool_c12_f32"][1]))
    args = OPCHECK_CASES["conv_prologue_bf16"][1]
    _equal(library.conv3x3_bn_relu_fwd(*args), conv_fused.conv3x3_bn_relu_reference(*args))
    args = OPCHECK_CASES["flash_n256_bf16"][1]
    _equal(library.flash_attention_fwd(*args), flash_attn.flash_attention_reference(*args))
    src, w, sx, dq, stride, pad, out, s, t = OPCHECK_CASES["q1_bf16_bn"][1]
    _equal(library.conv_int8(src, w, sx, dq, stride, pad, out, s, t),
           q8.conv_int8_reference(src, w.permute(0, 3, 1, 2), sx, dq, stride, pad, out,
                                  prologue=(s, t)))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def test_wrappers_reach_their_ops_on_the_cpu():
    """Each wrapper calls its op on a CPU tensor too (the kernels' CUDA
    implementations behind the same op), and a device with neither raises
    before it."""
    x, s, t = OPCHECK_CASES["pool_c16_bf16"][1]
    cx, cw, cs, ct = OPCHECK_CASES["conv_prologue_bf16"][1]
    q, k, v, scale = OPCHECK_CASES["flash_n128"][1]
    w = torch.randn(128, 64, 3, 3, generator=torch.Generator().manual_seed(11))
    calls = {
        "htrvt.pool_bn_relu_fwd.default": lambda: pool_fused.max_pool_bn_relu(x, s, t),
        "htrvt.conv3x3_bn_relu_fwd.default": lambda: conv_fused.conv3x3_bn_relu(
            cx, cw, cs, ct),
        "htrvt.flash_attention_fwd.default": lambda: flash_attn.flash_attention(
            q, k, v, scale),
        "htrvt.conv_int8.default": lambda: q8.conv_int8_bf16(
            _x((2, 64, 8, 12), 12, torch.bfloat16), w, (1, 1), 1,
            amax=torch.tensor(3.0)),
    }
    for name, call in calls.items():
        with _Ops() as mode:
            call()
        assert mode.seen.count(name) == 1, (name, mode.seen)
    meta = torch.empty((2, 16, 8, 12), device="meta").contiguous(memory_format=CL)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pool_fused.pool_bn_relu_fwd(meta, s, t)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        conv_fused.conv3x3_bn_relu_fwd(meta, torch.empty((8, 16, 3, 3), device="meta"))


def test_the_cpu_route_counts_no_launch():
    before = (pool_fused.pool_bn_relu_fwd.launches,
              conv_fused.conv3x3_bn_relu_fwd.launches,
              flash_attn.flash_attention_fwd.launches, q8.conv_int8_cuda.launches)
    for op, args in OPCHECK_CASES.values():
        op(*args)
    assert (pool_fused.pool_bn_relu_fwd.launches, conv_fused.conv3x3_bn_relu_fwd.launches,
            flash_attn.flash_attention_fwd.launches, q8.conv_int8_cuda.launches) == before
    assert np.isfinite(library.pool_bn_relu_fwd(*OPCHECK_CASES["pool_nchw"][1]).numpy()).all()
