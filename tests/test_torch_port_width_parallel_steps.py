"""``train_step`` (3 SAM steps) and ``eval_step`` with the image's width
sharded over the model axis, at (1, 2) on the CPU (two ``gloo`` ranks,
``tests/test_torch_port_width_parallel.py:rank_main``), against the port's
one process on the whole images, at ``tests/test_parallel.py:_setup``'s
tiny config with dropout, drop-path and random masking on: the stock
stem with the encoder replicated and again tensor-parallel
(``shard_model``), and the fused stem replicated; the rest of the switch
sets in ``_steps_fused.py``. The bars are
``tests/test_torch_port_width_parallel.py``'s.
"""

import numpy as np
import torch

from htr_vt_torch.config import config_to_dict
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import eval_step, train_step
from test_torch_port_distributed import collect
from test_torch_port_width_parallel import (FLIP_LRS, FUSED, LATER_RTOL, LATER_STATS_TOL,
                                            LOGIT_ATOL, SEED, STATS_TOL, STEP_RTOL, STEPS,
                                            SWITCHES, WEIGHT_RTOL, start_width, tiny_batch,
                                            tiny_cfg)


# --- train_step and eval_step --------------------------------------------------------
def one_process(cfg, seed, batches, probe):
    state = create_train_state(cfg, "cpu", torch.Generator().manual_seed(seed))
    out = eval_step(state.model, probe)
    metrics, first = [], None
    for batch in batches:
        metrics.append({k: float(v) for k, v in train_step(state, batch).items()})
        if first is None:
            first = {"model": {k: v.clone() for k, v in state.model.state_dict().items()}}
    return {"metrics": metrics, "first": first,
            "last": {"model": state.model.state_dict(), "ema": state.ema_model.state_dict()},
            "eval": {k: out[k] for k in ("logits", "loss")}}


def check_steps(got, want, cfg, what):
    """Ranks' ``steps_task`` against one process at the bars above."""
    for key in ("loss", "loss_second", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][0][key], want["metrics"][0][key],
                                   rtol=STEP_RTOL, err_msg=f"{what} {key}")
        np.testing.assert_allclose([m[key] for m in got["metrics"]],
                                   [m[key] for m in want["metrics"]], rtol=LATER_RTOL,
                                   err_msg=f"{what} {key}")
    from htr_vt_torch.optim.schedule import warmup_cosine_lr
    lr = [warmup_cosine_lr(i, max_lr=cfg.optim.max_lr, warmup_iters=cfg.optim.warmup_iters,
                           total_iters=cfg.optim.total_iters, min_lr=cfg.optim.min_lr)
          for i in range(STEPS)]
    for tag, n in (("first", 1), ("last", STEPS)):
        parts = ("model",) if tag == "first" else ("model", "ema")
        for part in parts:
            for k, v in want[tag][part].items():
                atol = FLIP_LRS * sum(lr[:n]) if v.is_floating_point() else 0
                if "running" in k:
                    torch.testing.assert_close(got[tag][part][k], v,
                                               **(STATS_TOL if n == 1 else LATER_STATS_TOL),
                                               msg=lambda s: f"{what} {tag} {part} {k}: {s}")
                    continue
                torch.testing.assert_close(got[tag][part][k], v, rtol=WEIGHT_RTOL,
                                           atol=atol,
                                           msg=lambda s: f"{what} {tag} {part} {k}: {s}")
    torch.testing.assert_close(got["eval"]["logits"], want["eval"]["logits"], rtol=0,
                               atol=LOGIT_ATOL, msg=lambda s: f"{what} eval logits: {s}")
    np.testing.assert_allclose(float(got["eval"]["loss"]), float(want["eval"]["loss"]),
                               rtol=STEP_RTOL, err_msg=f"{what} eval loss")


SCENARIOS = {
    "stock": (dict(), False), "stock_tp": (dict(), True),
    "fused": (FUSED, False), "fused_tp": (FUSED, True),
    "fully_fused": (SWITCHES["fully_fused"], False),
    "fully_fused_tp": (SWITCHES["fully_fused"], True)}


def _same_run(got, same, name):
    """Two runs of the ranks bit for bit: metrics, the whole state after the
    first and the last step, the eval logits."""
    assert got["metrics"] == same["metrics"], name
    assert torch.equal(got["eval"]["logits"], same["eval"]["logits"]), name
    for tag in ("first", "last"):
        for part in ("model", "ema", "adamw"):
            flat = (lambda d: d) if part != "adamw" else (
                lambda d: {(i, k): v for i, st in d.items() for k, v in st.items()})
            for k, v in flat(same[tag][part]).items():
                assert torch.equal(flat(got[tag][part])[k], v), (name, tag, part, k)


def check_configs(tmp_path, cfgs, bs=16, tensor_parallel=None, compare=None):
    """At (1, 2): ``eval_step`` and three SAM steps on strips against the
    port's one process on the whole images for each of ``cfgs`` (name ->
    config), from one seed, on ``bs``-row batches, the encoder replicated
    or tensor-parallel where ``tensor_parallel`` (name -> bool) says; both
    ranks read the same metrics and hold the same weights and logits.
    ``compare``: name -> the name whose ranks' run it must equal bit for
    bit (``_same_run``), with no one-process run of its own. The
    one-process runs go while the ranks run. Returns the ranks' records."""
    compare, tensor_parallel = compare or {}, tensor_parallel or {}
    batches = [tiny_batch(40 + i, bs) for i in range(STEPS)]
    probe = tiny_batch(50, bs)
    tasks = {name: dict(kind="steps", cfg=config_to_dict(cfg), seed=SEED,
                        tensor_parallel=tensor_parallel.get(name, False), batches=batches,
                        probe=probe) for name, cfg in cfgs.items()}
    procs = start_width(tmp_path, (1, 2), tasks)
    want = {name: one_process(cfg, SEED, batches, probe) for name, cfg in cfgs.items()
            if name not in compare}
    ranks = collect(procs, tmp_path)
    assert [(r["data"], r["model"]) for r in ranks] == [((0, 1), (0, 2)), ((0, 1), (1, 2))]
    for name, cfg in cfgs.items():
        r0 = ranks[0][name]
        assert r0["sharded"] == tensor_parallel.get(name, False)
        assert "132 px" in r0["bad_width"] and "axis of 2" in r0["bad_width"]
        assert ranks[1][name]["metrics"] == r0["metrics"], name
        for k, v in r0["last"]["model"].items():
            assert torch.equal(ranks[1][name]["last"]["model"][k], v), (name, k)
        assert torch.equal(ranks[1][name]["eval"]["logits"], r0["eval"]["logits"])
        if name in compare:
            _same_run(r0, ranks[0][compare[name]], name)
        else:
            check_steps(r0, want[name], cfg, name)
    return ranks


def check_switch_sets(tmp_path, names):
    """``check_configs`` for the ``SCENARIOS`` named (a switch set, the
    encoder replicated or tensor-parallel); a width that does not split
    raises, naming it and M."""
    check_configs(tmp_path, {name: tiny_cfg(**SCENARIOS[name][0]) for name in names},
                  tensor_parallel={name: SCENARIOS[name][1] for name in names})


def test_train_and_eval_steps_match_one_process(tmp_path):
    """The stock stem, the encoder replicated and tensor-parallel, and the
    fused stem with the encoder replicated (the rest in
    ``_steps_fused.py``)."""
    check_switch_sets(tmp_path, ("stock", "stock_tp", "fused"))
