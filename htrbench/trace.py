"""The traced part of a run: ``torch.profiler`` over a stretch of work
after the measured window, kept in memory, reduced to device seconds by
kernel and category, the busy share, and the idle gaps named by the
harness's host span that was open at the time.

A hand-written kernel of the port is its own category, by
``kernels.NAMES``; the rest follow a copy of
``htr_vt_torch/cli/profile_serve.py``'s ``CATEGORIES`` for the library's
kernels.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from htrbench.kernels import NAMES

PREFIX = "htrbench."
STRETCH = "stretch"
LIBRARY = (
    ("convolutions (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit")),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass", "cublas")),
    ("max pooling", ("max_pool",)),
    ("optimizer and EMA (foreach)", ("multi_tensor",)),
    ("dtype casts and copies", ("copy",)),
    ("norms, softmax, reductions", ("norm", "softmax", "reduce")),
    ("elementwise", ("elementwise",)),
)
EAGER = ("elementwise", "dtype casts and copies")


def kernel_of(name: str) -> Optional[str]:
    """The port's kernel (``kernels.NAMES``) a device kernel belongs to."""
    for k, keys in NAMES.items():
        if any(s in name for s in keys):
            return k
    return None


def category(kernel: str) -> str:
    """The port's kernel, else the library category, else ``other``."""
    own = kernel_of(kernel)
    if own is not None:
        return own
    name = kernel.lower()
    for label, keys in LIBRARY:
        if any(k in name for k in keys):
            return label
    return "other"


class Tracer:
    """``span(name)`` marks host work with a harness span (a no-op when
    not tracing); ``trace(unit, n)`` profiles ``n`` calls of ``unit``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.events: List = []

    def span(self, name: str):
        if self.enabled and self.prof is not None:
            return torch.profiler.record_function(PREFIX + name)
        return contextlib.nullcontext()

    def trace(self, unit: Callable[[], object], n: int, sync: Callable[[], None],
              count: Callable[[], Dict[str, int]]) -> Dict[str, int]:
        """One call of ``unit`` with the profiler warming up, then ``n``
        calls recorded inside the ``stretch`` span, which ends once the
        device has finished them; the events are kept in memory. Returns
        what ``count`` (launch counters) moved by over the stretch."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)

        def ready(prof):
            self.events = list(prof.profiler.kineto_results.events())

        schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=schedule,
                                    on_trace_ready=ready) as prof:
            self.prof = prof
            unit()
            sync()
            prof.step()
            before = count()
            with self.span(STRETCH):
                for _ in range(n):
                    unit()
                sync()
            after = count()
            prof.step()
        self.prof = None
        return {k: after[k] - before.get(k, 0) for k in after}


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class _Spans:
    """The harness spans by name, each kind's intervals sorted, for finding
    the innermost one open at a time."""

    INNER = ("load", "forward", "decode")

    def __init__(self, spans: List[Tuple[int, int, str]]):
        self.by: Dict[str, Tuple[List[int], List[int]]] = {}
        for name in {n for _, _, n in spans}:
            iv = sorted((s, e) for s, e, n in spans if n == name)
            self.by[name] = ([s for s, _ in iv], [e for _, e in iv])

    def _open(self, name: str, t: int) -> Optional[Tuple[int, int]]:
        if name not in self.by:
            return None
        starts, ends = self.by[name]
        i = bisect.bisect_right(starts, t) - 1
        return (starts[i], ends[i]) if i >= 0 and t < ends[i] else None

    def label(self, t: int) -> str:
        """The innermost span open at t; inside a job only, ``route``
        before its first load, else the step's own host work."""
        for name in self.INNER:
            if self._open(name, t):
                return name
        if self._open("train_step", t):
            return "train_step host work"
        job = self._open("job", t)
        if job is None:
            return "outside spans"
        loads = self.by.get("load", ([], []))[0]
        i = bisect.bisect_left(loads, job[0])
        return "route" if i >= len(loads) or loads[i] > t else "stack, H2D, loss, sync"


def reduce(events) -> dict:
    """Device seconds by category and by the port's kernel; the traced
    window (the ``stretch`` span), its busy seconds and its idle gaps by
    host span."""
    spans: List[Tuple[int, int, str]] = []
    kernels: List[Tuple[int, int, str]] = []
    for ev in events:
        name = ev.name()
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            if name.startswith(PREFIX):
                spans.append((start, start + dur, name[len(PREFIX):]))
        elif not ev.is_user_annotation() and not name.startswith(("Memcpy", "Memset", PREFIX)):
            kernels.append((start, start + dur, name))
    out = dict(window_s=0.0, busy_s=0.0, category_s={}, kernel_s={}, idle_s={}, n_kernels=0)
    stretch = [(s, e) for s, e, n in spans if n == STRETCH]
    if not stretch:
        return out
    w0, w1 = stretch[0]
    cat: Dict[str, float] = defaultdict(float)
    ker: Dict[str, float] = defaultdict(float)
    inside = []
    for s, e, name in kernels:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        inside.append((s, e))
        cat[category(name)] += (e - s) / 1e9
        k = kernel_of(name)
        if k is not None:
            ker[k] += (e - s) / 1e9
    busy = _union(inside)
    labels = _Spans(spans)
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    idle: Dict[str, float] = defaultdict(float)
    t = w0
    for s, e in busy + [(w1, w1)]:
        if s > t:  # a gap, cut where a span opens or closes, each piece by its span
            ends = cuts[bisect.bisect_right(cuts, t):bisect.bisect_left(cuts, s)] + [s]
            for a, b in zip([t] + ends[:-1], ends):
                idle[labels.label((a + b) // 2)] += (b - a) / 1e9
        t = max(t, e)
    out.update(window_s=(w1 - w0) / 1e9, busy_s=sum(e - s for s, e in busy) / 1e9,
               category_s=dict(cat), kernel_s=dict(ker), idle_s=dict(idle),
               n_kernels=len(inside))
    return out


def breakdown(red: dict) -> dict:
    """The ``breakdown`` of a traced result line: the ten device categories
    that took most time and the ten host spans under which the device sat
    idle longest, in seconds."""
    top = sorted(red["category_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(red["idle_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}
