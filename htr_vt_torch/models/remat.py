"""Rematerialization (port of ``cfg.remat``, ``htr_vt_tpu/models/htr_vt.py:
63-69,93-94,125-127``): a module's activations are dropped after its
forward and recomputed in the backward, through
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` (the
reentrant form does not work with ``torch.autograd.grad``, which the SAM
step uses).

JAX's ``nn.remat`` is functional; the port's forward has two side effects
that a recompute must not repeat:

- BatchNorm moves its running statistics in place. The recompute runs in a
  context (``recomputing()``) inside which ``BatchNorm`` skips that update;
  the batch statistics themselves are recomputed, from the same inputs, to
  the same bits.
- Dropout, drop-path and masking draw from an explicit ``torch.Generator``,
  which ``checkpoint``'s ``preserve_rng_state`` does not restore (it
  restores the default CPU and CUDA generators only). The generator's state
  at the wrapped call is saved, set again for the recompute, and the state
  it had at backward time put back after it.

Collectives inside a wrapped call (a width-sharded stem's halo exchanges
and BN all-reduces, ``parallel/mesh.py:shard_width``) run again in the
recompute, inside the backward. Every rank builds the same graph, so every
rank starts its recompute at the same node and issues them in the
forward's order, on the same inputs and so to the same sums; the
recomputed statistics equal the forward's bit for bit, and the running
statistics move once (``recomputing()``). A rank that stalls there fails
at the process group's timeout (``parallel/mesh.py:TIMEOUT``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

_STATE = threading.local()


def recomputing() -> bool:
    """Whether the caller runs inside a recompute (on this thread: the
    backward's recompute runs on autograd's thread)."""
    return getattr(_STATE, "depth", 0) > 0


@contextlib.contextmanager
def _recompute(generator: Optional[torch.Generator], saved):
    _STATE.depth = getattr(_STATE, "depth", 0) + 1
    now = None
    if generator is not None:
        now = generator.get_state()
        generator.set_state(saved)
    try:
        yield
    finally:
        if generator is not None:
            generator.set_state(now)
        _STATE.depth -= 1


def run(fn, *args, replay: Optional[torch.Generator] = None, **kwargs):
    """``fn(*args, **kwargs)`` with its activations recomputed in the
    backward; ``replay`` is the explicit generator ``fn`` draws from, if
    any, whose draws the recompute repeats."""
    saved = None if replay is None else replay.get_state()

    def contexts():
        return contextlib.nullcontext(), _recompute(replay, saved)

    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts, **kwargs)
