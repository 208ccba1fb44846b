"""The port's hand-written kernels: the least time of each launch at its
shape, and the names by which the device trace shows them.

Bytes and operations are reckoned as ``chip_smoke.py`` reckons them for its
kernel phases: each input byte read once and each output byte written once,
the operations the algorithm needs. ``plan`` lists the launches one unit of
work makes (a SAM step, or one eval batch of ``batch`` lines at ``width``)
with the least seconds of each; the port's launch counters say how many
there were.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

from htrbench import peaks
from htrbench.flops import stem_convs, tokens

# Every hand-written kernel of the port -> the substrings of its device
# kernels' names (its own partial-sum launches included). The trace's
# categories and the rooflines both match names here, and only here.
NAMES = {
    "K1a": ("ctc_alpha_kernel", "ctc_alpha_strided"),
    "K1b": ("ctc_beta_kernel", "ctc_beta_strided"),
    "K2": ("bn_stats_kernel",),
    "K3f": ("pool_fwd_kernel",),
    "K3b": ("pool_bwd_kernel",),
    "K4f": ("conv_fwd_wgmma",),
    "K4d": ("conv_dgrad_wgmma", "sum_row_groups"),
    "K4w": ("wgrad_wgmma", "wgrad_f32_kernel", "sum_splits"),
    "K4f/K4d float32": ("conv_f32_kernel",),
    "K3b/K4d partial sums": ("sum_partials",),
    "K5f": ("flash_fwd_wgmma", "flash_fwd_f32"),
    "K5dkv": ("flash_dkv_wgmma", "flash_dkv_f32"),
    "K5dq": ("flash_dq_wgmma", "flash_dq_f32"),
    "Q1": ("conv_int8_wgmma", "conv_int8_kernel", "quantize_kernel"),
}
# The port's counters (``<module>:<function>.launches``) by kernel.
COUNTERS = {
    "K2": "bn_stats:bn_stats",
    "K3f": "pool_fused:pool_bn_relu_fwd",
    "K3b": "pool_fused:pool_bn_relu_bwd",
    "K4f": "conv_fused:conv3x3_bn_relu_fwd",
    "K4d": "conv_fused:conv3x3_bn_relu_dgrad",
    "K4w": "conv_fused:conv3x3_bn_relu_wgrad",
    "K5f": "flash_attn:flash_attention_fwd",
    "Q1": "quant:conv_int8_cuda",
}


def k2(n: int, c: int) -> float:
    return peaks.least_seconds(2 * n + 2 * c * 4, 3 * n, peaks.F32_OPS_PER_S)


def k3f(n_in: int, n_out: int, c: int) -> float:
    return peaks.least_seconds(2 * n_in + 2 * n_out + 2 * c * 4, 3 * n_in + 8 * n_out,
                               peaks.F32_OPS_PER_S)


def k3b(n_in: int, n_out: int, c: int) -> float:
    return peaks.least_seconds(2 * n_out + 4 * n_in + 4 * c * 4, 7 * n_in + 27 * n_out,
                               peaks.F32_OPS_PER_S)


def k4(kind: str, b: int, c: int, h: int, w: int) -> float:
    n, kw = b * c * h * w, 9 * c * c
    ops = 2.0 * b * h * w * 9 * c * c
    n_bytes = {"K4f": 4 * n + 2 * kw + 2 * c * 4,
               "K4d": 6 * n + 2 * kw + 4 * c * 4,
               "K4w": 4 * n + 4 * kw + 2 * c * 4}[kind]
    return peaks.least_seconds(n_bytes, ops, peaks.BF16_OPS_PER_S)


def k5f(b: int, h: int, n: int, d: int) -> float:
    return peaks.least_seconds(4 * b * h * n * d * 2 + 2 * b * h * n * 4,
                               4.0 * b * h * n * n * d, peaks.BF16_OPS_PER_S)


def q1(b: int, cin: int, cout: int, k: int, hin: int, win: int, hout: int, wout: int,
       in_bytes: int, out_bytes: int) -> float:
    m = b * hout * wout
    n_bytes = b * cin * hin * win * in_bytes + cout * k * k * cin + m * cout * out_bytes
    return peaks.least_seconds(n_bytes, 2.0 * m * cout * k * k * cin, peaks.INT8_OPS_PER_S)


def plan(model: dict, width: int, batch: int, train: bool) -> Dict[str, List[float]]:
    """{kernel: [least seconds of each launch]} of one unit of work: a SAM
    step (two train forwards and backwards) or one eval forward of
    ``batch`` lines at ``width``, with the configuration's switches (the
    fully fused stem; K5 at >= 256 tokens and head_dim a multiple of 128;
    the int8 sites and the stage 1 padded to 256 under ``quant`` int8)."""
    d, h = model["embed_dim"], model["img_size"][0]
    int8 = model.get("quant") == "int8" and not train
    widths = None
    if int8:
        widths = [max(model.get("quant_stage1_pad", 256), d // 4), d // 2, d]
    convs = stem_convs(d, h, width, widths)
    out: Dict[str, List[float]] = defaultdict(list)
    passes = 2 if train else 1
    c1 = convs[0]
    entry_in = batch * c1.cout * c1.hout * c1.wout
    entry_out = batch * c1.cout * (c1.hout // 2) * c1.wout
    for _ in range(passes):
        if model.get("pool_impl") == "pallas":
            out["K3f"].append(k3f(entry_in, entry_out, c1.cout))
            if train:
                out["K3b"].append(k3b(entry_in, entry_out, c1.cout))
        if train and model.get("bn_stats_impl") == "pallas":
            out["K2"].append(k2(entry_in, c1.cout))
            for cv in convs[1:]:
                out["K2"].append(k2(batch * cv.cout * cv.hout * cv.wout, cv.cout))
        for cv in convs[1:]:
            site = (batch, cv.cout, cv.hout, cv.wout)
            if int8:
                pre_q = cv.name == "layer1.0.conv1" or cv.name == "layer1.0.proj"
                in_bytes = 2 if (pre_q or cv.name.endswith("conv2")) else 1
                out_bytes = 4 if cv.name == "layer1.0.proj" else 2
                out["Q1"].append(q1(batch, cv.cin, cv.cout, cv.k, cv.hin, cv.win,
                                    cv.hout, cv.wout, in_bytes, out_bytes))
            elif (model.get("conv_impl") == "pallas" and cv.k == 3
                  and cv.stride == (1, 1)):
                out["K4f"].append(k4("K4f", *site))
                if train:
                    out["K4d"].append(k4("K4d", *site))
                    out["K4w"].append(k4("K4w", *site))
        n = tokens(h, width)
        hd = d // model["num_heads"]
        if (model.get("attn_impl", "auto") in ("auto", "flash") and n >= 256
                and n % 128 == 0 and hd % 128 == 0):
            out["K5f"] += [k5f(batch, model["num_heads"], n, hd)] * model["depth"]
    return dict(out)


def roofline(kernels: Tuple[str, ...], plans: List[Tuple[Dict[str, List[float]], float]],
             launches: Dict[str, int], device_s: Dict[str, float], also: Tuple[str, ...] = ()):
    """A group of kernels' share of its roofline, in %: the least seconds of
    the launches made over the device seconds they took. ``plans``: (plan,
    units) of the traced work; each kernel's least seconds a launch is the
    plans' mean, times the launches its counter saw. ``also``: entries of
    ``NAMES`` with no bound of their own whose time is the group's work
    (partial sums). None where no launch of the group ran or the trace
    shows none of its time."""
    least, time = 0.0, 0.0
    for k in kernels:
        n = launches.get(k, 0)
        per = [s for p, units in plans for s in p.get(k, []) for _ in range(int(units))]
        if n <= 0 or not per:
            continue
        least += n * sum(per) / len(per)
        time += device_s.get(k, 0.0)
    if least <= 0.0 or time <= 0.0:
        return None
    time += sum(device_s.get(k, 0.0) for k in also)
    return 100.0 * least / time
