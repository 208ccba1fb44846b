"""Data-parallel training of the port (``htr_vt_torch/parallel/mesh.py``)
with two ``gloo`` processes on the CPU, launched through the ``HTRVT_*``
variables as a user launches ``cli/train.py``, against one process and
against the JAX package (tiny float32 config of ``tests/test_remat_accum.py``,
global batch 8, four rows a rank):

- three SAM steps on two ranks against one process on the whole batch,
  with the stock stem and with the ``pallas`` switches (their plain twins on
  the CPU: K2's sums through the all-reduce), random masking and dropout
  drawn from the generator (each rank keeps its rows of the global draw);
  then ``validate`` on every rank against one process;
- one step on two ranks against JAX's single-process ``jit_train_step`` on
  the global batch, from the same weights and keep masks (JAX's own
  ``tests/test_multihost.py``, marked slow, holds its multi-process step to
  that single-process one);
- the mesh checks.

``grad_accum`` under two ranks and ``fit`` on two ranks are in
``tests/test_torch_port_distributed_fit.py``. Every worker runs under a
timeout, with one torch thread; a hung rendezvous fails its test.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.config import MaskConfig, OptimConfig, TrainConfig
from htr_vt_tpu.models import masking as jmasking
from htr_vt_torch.config import config_to_dict
from htr_vt_torch.eval.validate import validate
from htr_vt_torch.models import masking
from htr_vt_torch.optim.schedule import warmup_cosine_lr
from htr_vt_torch.parallel import mesh
from htr_vt_torch.text.converter import CTCLabelConverter
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import train_step
from htr_vt_torch.utils.convert import model_to_jax_tree
from test_torch_port_memory_levers import (RANKS_STEADY_SHARE, check_against_jax, jax_init,
                                           jax_step, port_state, tiny_batch, tiny_cfg)
from test_torch_port_model import port_config
from test_torch_port_zoo import _leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS, B, N, STEPS = 2, 8, 16, 3
WORKER_TIMEOUT = 120
# Two ranks against one process: the same arithmetic but for the order of
# the sums the all-reduces split (BN sums, the gradient mean, the losses'
# mean). At JAX's tiny optimizer (OptimConfig(total_iters=100): a first LR
# of 1e-6) the losses and gradient norms of three steps agree within 2e-6
# (measured up to 7.2e-7), every weight and EMA element within Adam's
# sign-flip bound (2 x the summed LR: a gradient under float32 noise steps
# either way; measured up to 0.82 x) and 1e-6 of its value, and the running
# statistics within 1e-5 (measured up to 1.1e-6). At a first LR of 3.3e-4
# this tiny stem is ill-conditioned: the plain and folded BN dataflows of
# one process, which differ only in rounding, give gradient norms 7e-4
# apart at the second step (stem gradients 6% apart: max-pool and ReLU
# switches move), so the parity is read where the weights barely move and
# the losses and gradient norms carry it.
PARITY_RTOL = 2e-6
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
WEIGHT_RTOL, FLIP_LRS = 1e-6, 2.01
STOCK = {}
PALLAS = dict(bn_stats_impl="pallas", pool_impl="pallas", conv_impl="pallas")

WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["HTRVT_REPO"])
from htr_vt_torch.config import ExperimentConfig, config_from_dict
from htr_vt_torch.eval.validate import validate
from htr_vt_torch.models import masking
from htr_vt_torch.optim.schedule import warmup_cosine_lr
from htr_vt_torch.parallel import mesh
from htr_vt_torch.text.converter import CTCLabelConverter
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import train_step

mesh.maybe_initialize_distributed()
rank, size = mesh.world()
assert size == int(os.environ["HTRVT_NUM_PROCESSES"])
job = torch.load(os.environ["HTRVT_JOB"], weights_only=False)
out = {}
draw = masking.build_keep_mask
for name, sc in job.items():
    cfg = config_from_dict(ExperimentConfig, sc["cfg"])
    state = create_train_state(cfg, "cpu", torch.Generator().manual_seed(sc["seed"]))
    if sc.get("init") is not None:
        state.model.load_state_dict(sc["init"])
        state.ema_model.load_state_dict(sc["init"])
    masks = iter(sc.get("masks") or [])
    masking.build_keep_mask = (lambda *a, **k: next(masks)) if sc.get("masks") else draw
    metrics = []
    for batch in sc["batches"]:
        b = len(batch["image"]) // size
        mine = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        metrics.append({k: float(v) for k, v in train_step(state, mine).items()})
    rec = {"metrics": metrics, "model": state.model.state_dict(),
           "ema": state.ema_model.state_dict()}
    if sc.get("val"):
        rec["val"] = validate(state.ema_model, iter(sc["val"]),
                              CTCLabelConverter(sc["alphabet"]))
    out[name] = rec
torch.save(out, os.path.join(os.environ["HTRVT_OUT"], f"rank{rank}.pt"))
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def launch(script: str, tmp_path, job=None, ranks: int = RANKS, env=None):
    """Run ``script`` as ``ranks`` processes of one gloo group (the
    ``HTRVT_*`` launch), each under WORKER_TIMEOUT; returns the
    ``rank{r}.pt`` each saved in ``tmp_path``. A worker that fails or hangs
    fails the test with every worker's output."""
    return collect(start(script, tmp_path, job, ranks, env), tmp_path)


def start(script: str, tmp_path, job=None, ranks: int = RANKS, env=None):
    """``launch``'s processes, started and not waited for (``collect``)."""
    if job is not None:
        torch.save(job, os.path.join(str(tmp_path), "job.pt"))
    port = free_port()
    procs = []
    for rank in range(ranks):
        e = dict(os.environ, HTRVT_REPO=REPO, HTRVT_COORDINATOR=f"localhost:{port}",
                 HTRVT_NUM_PROCESSES=str(ranks), HTRVT_PROCESS_ID=str(rank),
                 HTRVT_JOB=os.path.join(str(tmp_path), "job.pt"), HTRVT_OUT=str(tmp_path),
                 OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen([sys.executable, "-c", script], env=e, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


def collect(procs, tmp_path):
    """Wait for ``start``'s processes; their ``rank{r}.pt``."""
    logs, failed = [], False
    for rank, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out += f"\n[rank {rank} timed out after {WORKER_TIMEOUT} s]"
            failed = True
        failed |= p.returncode != 0
        logs.append(f"--- rank {rank} (rc {p.returncode}) ---\n{out[-3000:]}")
    if failed:
        pytest.fail("\n".join(logs))
    return [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def global_batches(seed, steps=STEPS):
    return [tiny_batch(seed + i, B) for i in range(steps)]


def drawn_cfg(switches):
    """Random masking (a draw a row) and dropout: every draw is the global
    batch's, each rank keeping its rows."""
    cfg = tiny_cfg(TrainConfig(total_iters=100))
    return dataclasses.replace(cfg, optim=OptimConfig(total_iters=100),
                               model=dataclasses.replace(
                                   cfg.model, drop_rate=0.1, drop_path_rate=0.1,
                                   masking=MaskConfig(mode="random", ratio=0.3), **switches))


ALPHABET = list("abcdefghi")  # nb_cls 10


def eval_batches(seed):
    """Two eval batches of 8 (global), the last one with 5 valid rows."""
    out = []
    for i, valid in enumerate((B, 5)):
        b = tiny_batch(seed + i, B)
        texts = ["".join(ALPHABET[c - 1] for c in row) for row in b["labels"][:valid]]
        out.append((b, valid, texts))
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One launch of two ranks for every scenario of this file; the JAX
    steps and one-process runs are made in the test process."""
    tmp = tmp_path_factory.mktemp("dp")
    job = {}
    for name, sw in (("stock", STOCK), ("pallas", PALLAS)):
        job[name] = dict(cfg=config_to_dict(port_config(drawn_cfg(sw))), seed=11,
                         batches=global_batches(20), val=eval_batches(40), alphabet=ALPHABET)
    jcfg = dataclasses.replace(tiny_cfg(), model=dataclasses.replace(
        tiny_cfg().model, masking=MaskConfig(mode="span", ratio=0.4, max_span_length=4)))
    batch = tiny_batch(50, B)
    init = jax_init(jcfg, 4, batch)
    rng = np.random.default_rng(51)
    masks = [(rng.random((B, N, 1)) > 0.4).astype(np.float32) for _ in range(2)]
    job["jax"] = dict(cfg=config_to_dict(port_config(jcfg)), seed=0, batches=[batch],
                      init=port_state(jcfg, init).model.state_dict(),
                      masks=[torch.from_numpy(m) for m in masks])
    ranks = launch(WORKER, tmp, job)
    return dict(ranks=ranks, job=job, jax=(jcfg, init, batch, masks))


@pytest.mark.parametrize("name,switches", [("stock", STOCK), ("pallas", PALLAS)])
def test_two_ranks_equal_one_process(two_ranks, name, switches):
    ranks, sc = two_ranks["ranks"], two_ranks["job"][name]
    state = create_train_state(port_config(drawn_cfg(switches)), "cpu",
                               torch.Generator().manual_seed(sc["seed"]))
    want = [{k: float(v) for k, v in train_step(state, b).items()} for b in sc["batches"]]
    opt = state.cfg.optim
    lr_sum = sum(warmup_cosine_lr(i, max_lr=opt.max_lr, warmup_iters=opt.warmup_iters,
                                  total_iters=opt.total_iters, min_lr=opt.min_lr)
                 for i in range(STEPS))
    r0, r1 = ranks[0][name], ranks[1][name]
    assert r0["metrics"] == r1["metrics"]  # global values, one on every rank
    for key in want[0]:
        np.testing.assert_allclose([m[key] for m in r0["metrics"]], [m[key] for m in want],
                                   rtol=PARITY_RTOL, err_msg=key)
    for part, module in (("model", state.model), ("ema", state.ema_model)):
        for k, v in r0[part].items():
            assert torch.equal(v, r1[part][k]), (part, k)  # the ranks stay replicas
        other = create_train_state(port_config(drawn_cfg(switches)), "cpu",
                                   torch.Generator().manual_seed(0)).model
        other.load_state_dict(r0[part])
        got_p, got_s = (_leaves(t) for t in model_to_jax_tree(other))
        want_p, want_s = (_leaves(t) for t in model_to_jax_tree(module))
        for k, w in want_p.items():
            np.testing.assert_allclose(got_p[k], w, rtol=WEIGHT_RTOL,
                                       atol=FLIP_LRS * lr_sum, err_msg=(part, k))
        for k, w in want_s.items():
            np.testing.assert_allclose(got_s[k], w, **STATS_TOL, err_msg=(part, k))
    # validate: equal CER, WER and loss on both ranks, and one process's
    val = validate(state.ema_model, iter(sc["val"]), CTCLabelConverter(ALPHABET))
    assert r0["val"] == r1["val"]
    np.testing.assert_allclose(r0["val"][0], val[0], rtol=PARITY_RTOL)
    assert r0["val"][1:] == val[1:]


def test_two_ranks_match_jax_on_the_global_batch(two_ranks, monkeypatch):
    """One step of two ranks (each handed its rows of the global keep mask
    by ``rank_rows``) against JAX's single-process step on the batch of 8;
    the bars of ``test_torch_port_memory_levers.py``."""
    jcfg, init, batch, masks = two_ranks["jax"]
    calls = []

    def jax_mask(*a, **k):
        calls.append(None)
        return jnp.asarray(masks[len(calls) - 1])

    monkeypatch.setattr(jmasking, "build_keep_mask", jax_mask)
    want, state = jax_step(jcfg, init, batch)
    r0 = two_ranks["ranks"][0]["jax"]
    port = port_state(jcfg, init)
    port.model.load_state_dict(r0["model"])
    check_against_jax(r0["metrics"][0], port, want, state,
                      steady_share=RANKS_STEADY_SHARE)
    assert r0["metrics"] == two_ranks["ranks"][1]["jax"]["metrics"]


def test_rank_rows_are_the_global_draw():
    """At world size 1 the draw itself; the global draw's rows are what a
    rank keeps (checked here through a stand-in world)."""
    draw = lambda n: torch.arange(n * 3).view(n, 3)  # noqa: E731
    assert torch.equal(mesh.rank_rows(draw, 4), draw(4))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh, "world", lambda: (1, 2))
        assert torch.equal(mesh.rank_rows(draw, 4), draw(8)[4:])
        keep = masking.mask_tokens(torch.zeros(2, 5, 1), masking.MaskConfig(
            mode="random", ratio=0.4), torch.ones(1, 1, 1), True,
            generator=torch.Generator().manual_seed(0))
    full = masking.build_keep_mask(torch.Generator().manual_seed(0), 4, 5,
                                   masking.MaskConfig(mode="random", ratio=0.4))
    assert torch.equal(1.0 - keep, full[2:])


@pytest.mark.parametrize("shape,size,error", [
    ((2,), 1, ValueError), ((3,), 2, ValueError), ((2, 1, 1), 2, ValueError),
    ((2, 2), 2, ValueError), ((1, 4), 1, ValueError)])
def test_mesh_shape_must_match_the_world(shape, size, error):
    """data x model must be the world size; a model axis is tensor
    parallelism (``tests/test_torch_port_tensor_parallel.py``)."""
    with pytest.raises(error, match="mesh_shape"):
        mesh.check_mesh(shape, size)
    for ok in (None, (size,), (size, 1), (1, size)):
        mesh.check_mesh(ok, size)


def test_collectives_are_the_identity_in_a_world_of_one():
    """No group: every helper returns its input and calls nothing of
    ``torch.distributed``."""
    x = torch.arange(6.0).view(3, 2)
    assert mesh.world() == (0, 1)
    assert mesh.all_reduce_sum(x) is x
    assert mesh.all_gather_rows(x) is x and mesh.broadcast_str("run/c") == "run/c"
    ts = [x.clone()]
    mesh.all_reduce_mean_(ts)
    assert torch.equal(ts[0], x)
    mesh.barrier()
    mesh.assert_same_on_every_rank([x], "x")
