"""Closed-loop bulk transcription: jobs of the length mix's lines back to back,
each one call of ``cli/serve.py:transcribe_buckets``.

A job's natural widths are the traffic's length mix (``lines.mix_widths``),
the same set in every job and every seed, in an order drawn from the seed;
each line is a pool image of its bucket's width, drawn from the seed. The
program routes the lines to the buckets, loads them through the harness's
``load(i, width)``, stacks a batch at a time, runs ``eval_step`` and
decodes. A request is one bucket batch: from the load of its first line
to the first load of the next batch (or the job's end), since each batch
ends in the ``.cpu()`` of its ids; a bucket's calibration loads (int8)
count toward its first request. Set-up serves one job to warm every
shape the traffic uses.

The check reads one of the window's first ``check_jobs`` jobs, drawn from
the seed: a sample of its lines' texts, and the logits the timed path
computed for them (kept by a forward hook while that job runs), each held
to the plain reference's.

Traffic parameters: ``widths`` (a job's length mix), ``buckets``,
``batch``, ``pool_lines`` (pool images a bucket), ``calib_batches``,
``check_lines`` (lines the reference reads), ``check_jobs``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from htrbench import common, flops, kernels, lines, weights
from htrbench.common import Outcome, check, sub_seed
from htrbench.reference import serve as ref_serve
from htrbench.reference.model import param_shapes
from htrbench.reference.numerics import tf32_off
from htrbench.trace import Tracer, reduce


class Job:
    """One job: each line's natural width, bucket and pool image."""

    def __init__(self, widths: List[int], buckets: List[int], pool_lines: int,
                 rng: np.random.Generator):
        order = rng.permutation(len(widths))
        self.widths = [int(widths[i]) for i in order]
        self.bucket = lines.route(self.widths, buckets)
        self.image = rng.integers(0, pool_lines, len(widths)).tolist()
        self.texts: List[str] = []
        self.logits: Dict[int, torch.Tensor] = {}

    def bucket_lines(self, width: int) -> List[int]:
        return [i for i, b in enumerate(self.bucket) if b == width]


def make_pool(tr: dict, height: int, seed: int) -> Dict[int, np.ndarray]:
    """``pool_lines`` line images a bucket, at the bucket's width, with ink
    over more than the next narrower bucket holds."""
    rng = np.random.default_rng(sub_seed(seed, "data"))
    pool, lo = {}, 64
    for w in sorted(tr["buckets"]):
        pool[w] = lines.line_images(tr["pool_lines"], rng, w, height,
                                    ink_lo=min(lo + 1, w), ink_hi=w)
        lo = w
    return pool


class Timer:
    """The harness's ``load(i, width)``: returns the pool image and notes
    when each batch's first line is loaded."""

    def __init__(self, pool, tracer: Tracer, batch: int):
        self.pool, self.tracer, self.batch = pool, tracer, batch
        self.job: Job = None
        self.firsts: Dict[int, int] = {}
        self.marks: Dict[int, List[float]] = {}
        self.pending: List[int] = []

    def begin(self, job: Job) -> None:
        self.job, self.marks, self.pending = job, {}, []
        self.firsts = {}
        for w in sorted(set(job.bucket)):
            idx = job.bucket_lines(w)
            for k in range(0, len(idx), self.batch):
                self.firsts[idx[k]] = k // self.batch

    def __call__(self, i: int, width: int) -> np.ndarray:
        if i in self.firsts:
            self.marks.setdefault(i, []).append(common.clock())
        self.pending.append(i)
        with self.tracer.span("load"):
            return self.pool[width][self.job.image[i]]

    def requests(self, end: float) -> List[float]:
        """Each request's seconds: a bucket's first batch from its first
        load (calibration included), a later batch from its last."""
        starts = sorted(ts[0] if self.firsts[i] == 0 else ts[-1]
                        for i, ts in self.marks.items())
        return [b - a for a, b in zip(starts, starts[1:] + [end])]


def _spans(model, tracer: Tracer):
    """Harness spans around the model's forward while tracing."""
    state = {}

    def pre(module, args):
        if tracer.prof is not None:
            state["rf"] = torch.profiler.record_function("htrbench.forward")
            state["rf"].__enter__()

    def post(module, args, output):
        rf = state.pop("rf", None)
        if rf is not None:
            rf.__exit__(None, None, None)

    return [model.register_forward_pre_hook(pre), model.register_forward_hook(post)]


class Keep:
    """A forward hook that keeps, while armed, the logits of the lines in
    ``wanted``: a forward's rows are the lines loaded since the one before
    (the last ``rows`` of them: a calibration's unused batch comes first),
    and a later forward of a line (serving after calibration) replaces an
    earlier one's."""

    def __init__(self, model, timer: Timer):
        self.timer, self.wanted = timer, None
        self.logits: Dict[int, torch.Tensor] = {}
        self.handle = model.register_forward_hook(self)

    def arm(self, wanted) -> None:
        self.wanted, self.logits = set(wanted), {}

    def __call__(self, module, args, output):
        loaded, self.timer.pending = self.timer.pending, []
        if self.wanted is None:
            return
        rows = loaded[-output.shape[0]:]
        for r, i in enumerate(rows):
            if i in self.wanted:
                self.logits[i] = output[r].detach().float().clone()


class Server:
    """The program set up for a bulk cell: the benchmark's weights in a
    serving model, the converter, the pool and the jobs' widths."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device, tracer: Tracer):
        from htr_vt_torch import CTCLabelConverter
        from htr_vt_torch.models.htr_vt import build_model
        from htr_vt_torch.ops.quant import serving_arrays

        self.cfg, self.tr, self.seed, self.device, self.tracer = cfg, tr, seed, device, tracer
        self.m = cfg["model"]
        exp = common.experiment_config(cfg)
        self.p0 = weights.make(param_shapes(self.m), sub_seed(seed, "weights"), device)
        self.model = build_model(exp.model, device=device)
        self.model.load_state_dict(serving_arrays(exp.model, self.p0), strict=True)

        class Converter(CTCLabelConverter):
            def decode_batch(self, indices):
                with tracer.span("decode"):
                    return super().decode_batch(indices)

        self.converter = Converter(common.alphabet(self.m["nb_cls"]))
        self.widths = lines.mix_widths(tr["widths"])
        self.buckets = sorted(tr["buckets"])
        self.pool = make_pool(tr, self.m["img_size"][0], seed)
        self.rng = np.random.default_rng(sub_seed(seed, "masks"))
        self.timer = Timer(self.pool, tracer, tr["batch"])
        self.keep = Keep(self.model, self.timer)

    def job(self) -> Job:
        return Job(self.widths, self.buckets, self.tr["pool_lines"], self.rng)

    def serve(self, job: Job, keep: bool = False) -> float:
        """One call of ``transcribe_buckets``; returns its end on the host
        clock. With ``keep`` the logits of the job's checked lines
        (``sample_lines``) are kept in ``job.logits``."""
        from htr_vt_torch.cli.serve import transcribe_buckets
        self.timer.begin(job)
        if keep:
            self.keep.arm(sample_lines(job, self.tr["check_lines"], self.buckets, self.seed))
        with self.tracer.span("job"):
            job.texts = transcribe_buckets(self.model, self.timer, job.widths, self.buckets,
                                           self.converter, self.tr["batch"],
                                           self.tr.get("calib_batches", 4))
        if keep:
            job.logits, self.keep.wanted = self.keep.logits, None
        return common.clock()

    def free(self) -> None:
        """Drop the program's model, so that the reference runs alone."""
        self.keep.handle.remove()
        del self.model, self.keep
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, job: Job, numerics: str | None = None) -> Dict[str, float]:
        return check_job(job, self.p0, self.m, self.tr, self.pool, self.converter,
                         self.device, self.seed, numerics)


def run(ctx) -> Outcome:
    tr, dev = ctx.cell.traffic, ctx.device
    tracer = Tracer(ctx.trace)
    srv = Server(ctx.cell.config, tr, ctx.seed, dev, tracer)
    m, bs, buckets = srv.m, tr["batch"], srv.buckets
    checked = int(np.random.default_rng(sub_seed(ctx.seed, "data") + 7).integers(
        tr["check_jobs"]))
    srv.serve(srv.job())  # warm every shape
    common.sync(dev)
    setup_s = common.clock() - ctx.t_start

    jobs: List[Job] = []
    latencies: List[float] = []
    t0 = common.clock()
    while True:
        job = srv.job()
        end = srv.serve(job, keep=len(jobs) == checked)
        latencies += srv.timer.requests(end)
        jobs.append(job)
        if end - t0 >= ctx.seconds and len(jobs) > checked:
            break
    window = common.clock() - t0

    served = len(jobs) * len(srv.widths)
    peak_s = sum(flops.serve_peak_seconds(m, w) * job.bucket.count(w)
                 for job in jobs for w in buckets)
    record = dict(kind="serve", cell=ctx.cell.name, model=m, window_s=window,
                  lines=served, batches=len(latencies), peak_seconds=peak_s,
                  unit_s=window / len(jobs))
    if ctx.trace:  # after the window: one job to warm the profiler, one traced
        hooks = _spans(srv.model, tracer)
        launches = tracer.trace(lambda: srv.serve(srv.job()), 1, lambda: common.sync(dev),
                                common.counters)
        for h in hooks:
            h.remove()
        red = reduce(tracer.events)
        n_batches = {w: math.ceil(jobs[0].bucket.count(w) / bs) for w in buckets}
        red.update(units=sum(n_batches.values()), stretch_units=1, launches=launches,
                   lines=len(srv.widths),
                   plans=[(kernels.plan(m, w, bs, False), n) for w, n in n_batches.items()
                          if n])
        record["trace"] = red
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    p95 = float(np.percentile(np.asarray(latencies), 95, method="linear"))
    end_to_end = {"serve_lines_s": served / window, "serve_p95_ms": 1e3 * p95,
                  "setup_s": setup_s}

    # the check: the reference reads a sample of the checked job's lines,
    # once the program's model is freed
    srv.free()
    checks = {k: check(v, ctx.cell.limits[k]) for k, v in srv.check(jobs[checked]).items()}
    return Outcome(attempted=served, failed=0, end_to_end=end_to_end, record=record,
                   checks=checks, memory_peak_bytes=peak)


def sample_lines(job: Job, n: int, buckets: List[int], seed: int) -> List[int]:
    """``n`` lines of the job drawn from the seed, as even over its buckets
    as they allow, with its widest line among them."""
    rng = np.random.default_rng(sub_seed(seed, "data") + 11)
    present = [w for w in buckets if w in job.bucket]
    pick = {int(np.argmax(job.widths))}
    for w in present:
        idx = job.bucket_lines(w)
        k = min(len(idx), max(1, n // len(present)))
        pick.update(int(i) for i in rng.choice(idx, k, replace=False))
    return sorted(pick)


def check_job(job: Job, p0, m: dict, tr: dict, pool, converter, dev, seed: int,
              numerics: str | None = None) -> Dict[str, float]:
    """Over a sample of the job's lines (``sample_lines``), the reference at
    the configuration's numerics (its int8 scales calibrated again on the
    bucket's first batches) against what the program served: ``served_gap``,
    the widest gap by which a served text lies below the reference's best
    reading (``reference/serve.py:served_gap``), and ``logit_rms``, the
    worst line's root mean square gap between the logits the timed path
    computed and the reference's. With ``numerics`` the reference in that
    precision (a control) stands in the program's place: its logits, and
    the texts its frames' argmax collapses to."""
    buckets = sorted(tr["buckets"])
    bs, calib = tr["batch"], tr.get("calib_batches", 4)
    classes = {ch: i for i, ch in enumerate(converter.character) if i}
    gap, rms = 0.0, 0.0
    with tf32_off():
        for w in buckets:
            chosen = [i for i in sample_lines(job, tr["check_lines"], buckets, seed)
                      if job.bucket[i] == w]
            if not chosen:
                continue
            imgs = torch.from_numpy(np.stack([pool[w][job.image[i]] for i in chosen])).to(dev)
            amax = None
            if m.get("quant") == "int8":
                idx = job.bucket_lines(w)[:bs * calib]
                cal = (torch.from_numpy(np.stack([pool[w][job.image[i]]
                                                  for i in idx[s:s + bs // 4]])).to(dev)
                       for s in range(0, len(idx), bs // 4))
                amax = ref_serve.calibrate(p0, m, cal)
            ref = ref_serve.logits(p0, m, imgs, ref_serve.model_numerics(m, "float32")
                                   if amax is None else
                                   ref_serve.model_numerics(m, "int8", amax))
            if numerics is not None:
                prog = ref_serve.logits(p0, m, imgs, ref_serve.model_numerics(m, numerics, amax))
                ids = [ref_serve.greedy_ids(p) for p in prog.cpu().numpy()]
            else:
                if any(i not in job.logits for i in chosen):
                    return {"served_gap": float("inf"), "logit_rms": float("inf")}
                prog = torch.stack([job.logits[i] for i in chosen]).to(dev)
                try:
                    ids = [ref_serve.ids_of(job.texts[i], classes) for i in chosen]
                except KeyError:
                    return {"served_gap": float("inf"), "logit_rms": float("inf")}
            rms = max(rms, float(ref_serve.rms_gap(prog, ref).max()))
            gap = max(gap, max(ref_serve.served_gap(r, c) for r, c in zip(ref.cpu().numpy(), ids)))
    return {"served_gap": gap, "logit_rms": rms}
