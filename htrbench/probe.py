"""The readings a cell's correctness limits are set from, in one process.

    python3 -m htrbench.probe --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--out build/probe/<cell>.json]

For each of ``--seeds`` the program runs the cell's timed path as a run
does (set-up's first steps for training; one served job for serving) and
the check's numbers against the reference are read: the lower readings.
For each of ``--control-seeds`` the same numbers are read of the control,
the reference put in the program's place in the precision below the
configuration's (float8 products under a bfloat16 configuration, int4
under int8), and of the faults the cell can have, planted in the program
or in the reference in its place:

- training: the step on the first half of each batch (the mean over the
  rest); a step that returns its state unchanged reads 1 on the change
  and needs no run;
- serving: one frame's class altered in every line where ``eval_step``
  produces it.

It needs the card and prints one JSON object per reading and their
summary last; the benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from htrbench.drivers import bulk_serve, train_loop
from htrbench.manifest import ROOT, Bench
from htrbench.reference.model import is_buffer
from htrbench.reference.numerics import FP8
from htrbench.trace import Tracer


def values(checks: dict) -> dict:
    return {k: v["value"] for k, v in checks.items()}


def probe_train(cell, seeds, control_seeds, device, leaves=False):
    cfg, tr = cell.config, cell.traffic
    n, beta1 = tr["reference_steps"], cfg["optim"]["beta1"]
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        p0, state, pool, mask_seed = train_loop.build(cfg, tr, seed, device)
        params0 = {k: v for k, v in p0.items() if not is_buffer(k)}
        prog = train_loop.readings(train_loop.first_steps(state, pool, n, beta1), params0)
        batches = pool[:n]
        del state, pool
        torch.cuda.empty_cache()
        ref = train_loop.reference(p0, cfg, batches, mask_seed, device)
        rows = [("program", prog)] if seed in seeds else []
        if seed in control_seeds:
            rows.append(("control fp8", train_loop.reference(p0, cfg, batches, mask_seed,
                                                            device, FP8())))
            half = [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]
            rows.append(("fault half batch", train_loop.reference(p0, cfg, half, mask_seed,
                                                                 device)))
        for name, got in rows:
            rec = {"seed": seed, "side": name,
                   **values(train_loop.compare(got, ref, cell.limits))}
            if all(a.shape == b.shape for a, b in zip(got["logits"], ref["logits"])):
                rec["logit_rms_by_pass"] = [train_loop.logit_rms([a], [b])
                                            for a, b in zip(got["logits"], ref["logits"])]
            if leaves:
                masks = train_loop.moving(ref)
                mine = {"grad": got["grad"], "change": train_loop.change_norms(got["change"], masks)}
                theirs = {"grad": ref["grad"], "change": train_loop.change_norms(ref["change"], masks)}
                rec["leaves"] = {part: {k: abs(mine[part][k] - theirs[part][k])
                                        / max(theirs[part][k], 1e-30) for k in theirs[part]}
                                 for part in ("grad", "change")}
                rec["ref_norms"] = theirs
            print(json.dumps({k: v for k, v in rec.items() if k not in ("leaves", "ref_norms")}),
                  flush=True)
            out.append(rec)
        del p0, batches
        torch.cuda.empty_cache()
    return out


def altered(step):
    """``eval_step`` with one frame's class changed in every row."""
    def wrapped(model, batch):
        res = step(model, batch)
        ids = res["pred_ids"].clone()
        t = ids.shape[1] // 2
        ids[:, t] = ids[:, t] % (model.cfg.nb_cls - 1) + 1
        res["pred_ids"] = ids
        return res
    return wrapped


def probe_serve(cell, seeds, control_seeds, device):
    import htr_vt_torch.cli.serve as serve_cli
    tr = cell.traffic
    ctl = "int4" if cell.config["model"].get("quant") == "int8" else "fp8"
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        srv = bulk_serve.Server(cell.config, tr, seed, device, Tracer(False))
        srv.serve(srv.job())
        job = srv.job()
        srv.serve(job, keep=True)
        bad = None
        if seed in control_seeds:
            real = serve_cli.eval_step
            serve_cli.eval_step = altered(real)
            try:
                bad = srv.job()
                srv.serve(bad, keep=True)
            finally:
                serve_cli.eval_step = real
        srv.free()
        rows = []
        if seed in seeds:
            rows.append(("program", srv.check(job)))
        if bad is not None:
            rows.append((f"control {ctl}", srv.check(job, ctl)))
            rows.append(("fault altered frame", srv.check(bad)))
        texts = {"distinct_texts": len(set(job.texts)),
                 "mean_chars": sum(map(len, job.texts)) / len(job.texts)}
        for name, got in rows:
            rec = {"seed": seed, "side": name, **got, **(texts if name == "program" else {})}
            print(json.dumps(rec), flush=True)
            out.append(rec)
        del srv
        torch.cuda.empty_cache()
    return out


def summary(rows):
    out = {}
    for r in rows:
        for k, v in r.items():
            if k in ("seed", "side", "leaves", "ref_norms", "distinct_texts", "mean_chars",
                     "logit_rms_by_pass"):
                continue
            d = out.setdefault(r["side"], {}).setdefault(k, [])
            d.append(v)
    return {side: {k: {"min": min(v), "max": max(v), "n": len(v)} for k, v in d.items()}
            for side, d in out.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    p.add_argument("--leaves", action="store_true",
                   help="training: each leaf's gaps and the reference's norms too")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("htrbench.probe needs a CUDA device", file=sys.stderr)
        return 2
    cell = Bench().cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    if cell.traffic["driver"] == "train_loop":
        rows = probe_train(cell, seeds, controls, torch.device("cuda"), args.leaves)
    else:
        rows = probe_serve(cell, seeds, controls, torch.device("cuda"))
    result = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
              "rows": rows, "summary": summary(rows)}
    path = Path(args.out or ROOT / "build" / "probe" / f"{args.workload}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    print(json.dumps(result["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
