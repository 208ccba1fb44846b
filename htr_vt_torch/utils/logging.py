"""Observability: logger, scalar writers, profiler hooks, spans.

Reference set (SURVEY §2.7): file+stdout logger (model_v1/utils/utils.py:25-39),
TensorBoard scalars, optional wandb (model_v1/train.py:46-57). Added here
(reference has none, SURVEY §5): JSONL metric stream for machine consumption
and profiler trace capture.

The port's own copy of ``htr_vt_tpu/utils/logging.py``, held to it by
``tests/test_torch_port_loop.py``, with two changes: ``maybe_profile`` takes
a ``torch.profiler`` trace over the same step window, and ``StepTimer``'s
windows close after the loss fetch, which on the card is ``float(loss)``,
a host sync on the step's device work.

``span(name, ...)`` marks a phase of the program's own work (serving's
route, load, stack, copy, forward and decode; a SAM step's passes, perturb,
update and EMA). A span records only while a ``torch.profiler`` session is
recording, so outside one it costs a boolean check and a shared null
context. While recording it opens ``record_function("htrvt." + name)``, on
the trace's own timeline beside the kernels it launches, and keeps its
name, parent, request, host start and end (``time.time_ns``, the clock of
the profiler's CPU events) and attributes; ``spans()`` reads them. A
span's device time is that of the kernels launched inside its
``record_function`` range, read from the trace. The JAX package has no
spans.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional

import torch


def get_logger(out_dir: str, name: str = "htrvt",
               write_file: bool = True) -> logging.Logger:
    """File+stdout logger writing to <out_dir>/run.log. One logger per run
    directory, so several fit() calls in one process each get their own
    run.log (a singleton would keep appending to the first run's file).
    ``write_file=False`` (non-zero ranks of a multi-host run) logs to stdout
    only, so processes never race on one run.log."""
    logger = logging.getLogger(f"{name}:{os.path.abspath(out_dir)}")
    logger.setLevel(logging.INFO)
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    os.makedirs(out_dir, exist_ok=True)
    if write_file:
        fh = logging.FileHandler(os.path.join(out_dir, "run.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    logger.propagate = False
    return logger


class ScalarWriter:
    """Fan-out scalar writer: JSONL always; TensorBoard and wandb when their
    packages are importable (both optional, mirroring the reference's gating)."""

    def __init__(self, out_dir: str, use_wandb: bool = False,
                 wandb_project: str = "None", run_name: str = "run",
                 config: Optional[Dict] = None, enabled: bool = True):
        # enabled=False (non-zero ranks of a multi-host run): a no-op writer,
        # so only process 0 owns metrics.jsonl / TB / wandb.
        self._enabled = enabled
        if not enabled:
            self._jsonl, self._tb, self._wandb = None, None, None
            return
        os.makedirs(out_dir, exist_ok=True)
        self._jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(out_dir)
        except Exception:
            pass
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                wandb.init(project=wandb_project, name=run_name, config=config,
                           dir=out_dir)
                self._wandb = wandb
            except Exception:
                pass

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        if not self._enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))
        if self._wandb is not None:
            self._wandb.log(scalars, step=int(step))

    def close(self) -> None:
        if not self._enabled:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class StepTimer:
    """Rolling images/sec tracker (the framework's perf counter; the
    reference logs none).

    Call ``close_window(n_steps, batch_size)`` AFTER syncing on those steps'
    results (e.g. fetching their losses to host). Measuring at dispatch time
    instead over-reports badly: jit dispatch is asynchronous, so a window
    that contains no host sync times only the Python enqueue loop — observed
    2x over wall-clock on TPU when the rate window (50) was misaligned with
    the loss-fetch cadence (print_iters=100)."""

    def __init__(self):
        self._t = time.perf_counter()
        self.rate = 0.0

    def close_window(self, n_steps: int, batch_size: int) -> None:
        now = time.perf_counter()
        if n_steps > 0 and now > self._t:
            self.rate = n_steps * batch_size / (now - self._t)
        self._t = now


_PROFILER = None


def maybe_profile(profile_dir: Optional[str], step: int,
                  start_step: int = 10, num_steps: int = 5):
    """Capture a torch.profiler trace (CPU and, on the card, CUDA activity)
    for steps [start, start+num), written to ``profile_dir`` as a Chrome
    trace (``trace_step{start}.json``)."""
    global _PROFILER
    if profile_dir is None:
        return
    if step == start_step:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        _PROFILER = profile(activities=activities)
        _PROFILER.__enter__()
    elif step == start_step + num_steps and _PROFILER is not None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        _PROFILER.__exit__(None, None, None)
        os.makedirs(profile_dir, exist_ok=True)
        _PROFILER.export_chrome_trace(
            os.path.join(profile_dir, f"trace_step{start_step}.json"))
        _PROFILER = None


# --------------------------------------------------------------------- spans

_SPANS: List[dict] = []      # every span recorded in this process, in opening order
_IDS = itertools.count()
_REQUESTS = itertools.count()
_LOCAL = threading.local()   # this thread's open spans (autograd runs backward elsewhere)


class _NullSpan:
    """What ``span`` returns while no profiler records: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


class _Span:
    """A recording span; ``set(**attrs)`` adds attributes (counts known
    only inside it)."""

    def __init__(self, name: str, request: bool, attrs: dict):
        self.name, self.request, self.attrs = name, request, attrs

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        parent = stack[-1] if stack else None
        self.rec = rec = {
            "name": self.name, "id": next(_IDS),
            "parent": parent["id"] if parent else None,
            "request": (next(_REQUESTS) if self.request
                        else parent["request"] if parent else None),
            "start_ns": time.time_ns(), "end_ns": None, "attrs": self.attrs}
        self.rf = torch.profiler.record_function("htrvt." + self.name)
        self.rf.__enter__()
        stack.append(rec)
        _SPANS.append(rec)
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.rec["end_ns"] = time.time_ns()
        _LOCAL.stack.pop()
        return False

    def set(self, **attrs) -> None:
        self.rec["attrs"].update(attrs)


def span(name: str, request: bool = False, **attrs):
    """A context manager that records the phase ``name`` while a
    ``torch.profiler`` session records, and is a shared no-op otherwise.

    ``request=True`` opens a request (a served batch, a SAM step): the span
    takes the next request id, and the spans inside it inherit it.
    ``attrs`` (counts: lines, rows, widths) are kept with the span; the
    context's ``set(**attrs)`` adds more from inside it."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _Span(name, request, attrs)


def spans() -> List[dict]:
    """The spans recorded so far, in opening order: each a dict of
    ``name``, ``id``, ``parent`` (its enclosing span's id, or None),
    ``request``, ``start_ns`` / ``end_ns`` (``time.time_ns``) and
    ``attrs``."""
    return list(_SPANS)


def clear_spans() -> None:
    """Forget every span recorded so far."""
    _SPANS.clear()
