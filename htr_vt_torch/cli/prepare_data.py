"""Real-dataset arrival runbook in one command (port of
``htr_vt_tpu/cli/prepare_data.py``): preflight-validate the raw IAM /
READ2016 archives, run the formatter, wire up the shipped ``.ln`` lists, and
(optionally) smoke-train and test on the result with the port's CLIs.

The repository ships no real archives, so the formatter has only run
against byte-faithful miniatures (tests/test_real_data_path.py,
tests/test_torch_port_prepare_data.py). This command makes the day the
datasets arrive a single step:

    python -m htr_vt_torch.cli.prepare_data iam \
        --archive /data/lines.tgz --xml-dir /data/xml --out /data/iam_lines \
        --lists data/iam --smoke [--device cpu]

    python -m htr_vt_torch.cli.prepare_data read2016 \
        --pages-dir /data/pages --xml-dir /data/page_xml \
        --out /data/read_lines --lists data/read2016 --smoke

Stages (each prints a PASS/FAIL line; non-zero exit on the first failure):
  1. preflight  — archive/dir exists and parses; member names match the
                  dataset's id grammar; XML schema carries the expected
                  line-text structure; image<->label join coverage; sha256
                  of the archive recorded (compare with --expect-sha256 if
                  you have the official sum).
  2. format     — htr_vt_torch.data.format_datasets (same functions the
                  miniature e2e tests drive).
  3. lists      — every name in the shipped .ln split lists
                  (data/iam/*.ln, copied verbatim from the reference) must
                  exist among the formatted lines; reports per-split
                  coverage. Missing names = FAIL (the real archive should
                  cover the reference's official splits exactly).
  4. smoke      — (--smoke) 10-line train/eval through the port's train
                  CLI on a tiny model, then its test CLI on the best_CER
                  checkpoint: proves archive -> .ln -> loader -> train ->
                  CER end to end, on ``--device`` (default the card).

Reference workflow being packaged: data/format_datasets.py:45-252 +
run/iam.sh.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys
import tarfile
from typing import Dict, List


def _fail(stage: str, msg: str) -> None:
    print(f"[preflight] {stage}: FAIL — {msg}")
    sys.exit(1)


def _ok(stage: str, msg: str) -> None:
    print(f"[preflight] {stage}: PASS — {msg}")


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


# --------------------------------------------------------------------------
# IAM
# --------------------------------------------------------------------------
#: IAM line ids: writer-form(-suffix)-line, e.g. a01-000u-00 (the grammar of
#: every name in the shipped data/iam/*.ln lists).
_IAM_ID = re.compile(r"^[a-z]\d{2}-\d{3}[a-z]?-\d{2}$")


def preflight_iam(archive: str, xml_dir: str,
                  expect_sha256: str | None) -> Dict:
    if not os.path.isfile(archive):
        _fail("archive", f"{archive} does not exist")
    digest = sha256_file(archive)
    if expect_sha256 and digest != expect_sha256:
        _fail("archive", f"sha256 {digest} != expected {expect_sha256}")
    _ok("archive", f"sha256 {digest}" +
        ("" if expect_sha256 else " (no expected sum provided; recorded)"))

    ids_in_tar: List[str] = []
    try:
        with tarfile.open(archive, "r:*") as tar:
            for member in tar:
                if member.isfile() and member.name.endswith(".png"):
                    ids_in_tar.append(
                        os.path.splitext(os.path.basename(member.name))[0])
    except tarfile.TarError as e:
        _fail("archive", f"not a readable tarball: {e}")
    if not ids_in_tar:
        _fail("archive", "no .png members found")
    bad = [i for i in ids_in_tar if not _IAM_ID.match(i)]
    if len(bad) > len(ids_in_tar) * 0.01:
        _fail("archive", f"{len(bad)}/{len(ids_in_tar)} member names do not "
              f"match the IAM line-id grammar (e.g. {bad[:3]})")
    _ok("archive", f"{len(ids_in_tar)} line images, id grammar OK")

    if not os.path.isdir(xml_dir):
        _fail("xml", f"{xml_dir} does not exist")
    from htr_vt_torch.data.format_datasets import parse_iam_xml
    xml_files = [n for n in sorted(os.listdir(xml_dir)) if n.endswith(".xml")]
    if not xml_files:
        _fail("xml", "no .xml files")
    texts: Dict[str, str] = {}
    parse_errors = 0
    for name in xml_files:
        try:
            texts.update(parse_iam_xml(os.path.join(xml_dir, name)))
        except Exception:
            parse_errors += 1
    if parse_errors:
        _fail("xml", f"{parse_errors}/{len(xml_files)} form XMLs failed to "
              "parse")
    if not texts:
        _fail("xml", "form XMLs parsed but no <line id=... text=...> entries "
              "found — wrong schema?")
    _ok("xml", f"{len(xml_files)} form XMLs, {len(texts)} line texts")

    joined = sorted(set(ids_in_tar) & set(texts))
    cov = len(joined) / max(1, len(ids_in_tar))
    if cov < 0.95:
        _fail("join", f"only {cov:.1%} of archive images have XML ground "
              "truth — archive and xml dir are probably mismatched releases")
    _ok("join", f"{len(joined)} image+text pairs ({cov:.1%} of images)")
    return {"sha256": digest, "n_images": len(ids_in_tar),
            "n_texts": len(texts), "n_joined": len(joined)}


# --------------------------------------------------------------------------
# READ2016
# --------------------------------------------------------------------------
def preflight_read2016(pages_dir: str, xml_dir: str) -> Dict:
    if not os.path.isdir(pages_dir):
        _fail("pages", f"{pages_dir} does not exist")
    if not os.path.isdir(xml_dir):
        _fail("xml", f"{xml_dir} does not exist")
    pages = [n for n in sorted(os.listdir(pages_dir))
             if os.path.splitext(n)[1].lower() in (".jpg", ".png", ".tif")]
    xmls = [n for n in sorted(os.listdir(xml_dir)) if n.endswith(".xml")]
    if not pages:
        _fail("pages", "no page images (.jpg/.png/.tif)")
    if not xmls:
        _fail("xml", "no PAGE-XML files")
    from htr_vt_torch.data.format_datasets import parse_page_xml
    n_lines, parse_errors, matched = 0, 0, 0
    page_stems = {os.path.splitext(n)[0] for n in pages}
    for name in xmls:
        try:
            lines = parse_page_xml(os.path.join(xml_dir, name))
        except Exception:
            parse_errors += 1
            continue
        n_lines += len(lines)
        if os.path.splitext(name)[0] in page_stems:
            matched += 1
    if parse_errors:
        _fail("xml", f"{parse_errors}/{len(xmls)} PAGE-XMLs failed to parse")
    if n_lines == 0:
        _fail("xml", "PAGE-XMLs parsed but no TextLine+Coords+Unicode "
              "entries found — wrong namespace/schema?")
    cov = matched / len(xmls)
    if cov < 0.95:
        _fail("join", f"only {cov:.1%} of PAGE-XMLs have a matching page "
              "image")
    _ok("pages+xml", f"{len(pages)} pages, {len(xmls)} XMLs, {n_lines} "
        f"text lines, {cov:.1%} matched")
    return {"n_pages": len(pages), "n_xmls": len(xmls), "n_lines": n_lines}


# --------------------------------------------------------------------------
# Shipped-list coverage + smoke
# --------------------------------------------------------------------------
def check_lists(lists_dir: str, lines_dir: str) -> Dict[str, float]:
    """Every name in the shipped split lists must exist among the formatted
    lines (png + txt sidecar)."""
    cov = {}
    ln_files = [n for n in sorted(os.listdir(lists_dir)) if n.endswith(".ln")]
    if not ln_files:
        _fail("lists", f"no .ln files in {lists_dir}")
    # An absent split must be an explicit preflight FAIL, not a silent
    # partial validation (a list directory with test.ln alone would let the
    # train path crash later with a bare FileNotFoundError).
    absent = [n for n in ("train.ln", "val.ln", "test.ln")
              if n not in ln_files]
    if absent:
        _fail("lists", f"{lists_dir} is missing expected split list(s) "
              f"{absent} — training/eval need all three (the reference "
              f"ships train/val/test .ln per dataset)")
    for name in ln_files:
        names = [l.strip() for l in open(os.path.join(lists_dir, name))
                 if l.strip()]
        missing = [n for n in names
                   if not (os.path.exists(os.path.join(lines_dir, n)) and
                           os.path.exists(os.path.join(
                               lines_dir, os.path.splitext(n)[0] + ".txt")))]
        cov[name] = 1.0 - len(missing) / max(1, len(names))
        if missing:
            _fail("lists", f"{name}: {len(missing)}/{len(names)} listed "
                  f"lines missing from {lines_dir} (e.g. {missing[:3]})")
        _ok("lists", f"{name}: {len(names)} lines all present")
    return cov


def smoke_train(lines_dir: str, lists_dir: str, dataset: str,
                 out_dir: str, n_lines: int = 10, device: str = "cuda") -> None:
    """10-line train/eval through the port's CLIs on a tiny model — the same
    entries the full runs use (cli/train.py, then cli/test.py on the
    best_CER checkpoint)."""
    from htr_vt_torch.data.format_datasets import write_list_file
    train_src = os.path.join(lists_dir, "train.ln")
    if not os.path.exists(train_src):
        _fail("smoke", f"{train_src} does not exist — cannot build the "
              f"smoke split (ship the dataset's train.ln next to its "
              f"test.ln, as data/iam does)")
    names = [l.strip() for l in open(train_src) if l.strip()][:n_lines]
    smoke_dir = os.path.join(out_dir, "_smoke")
    os.makedirs(smoke_dir, exist_ok=True)
    smoke_ln = os.path.join(smoke_dir, "smoke.ln")
    write_list_file(smoke_ln, names)

    common = [dataset.upper() if dataset != "read2016" else "READ",
              "--exp-name", "smoke", "--out-dir", smoke_dir,
              "--train-data-list", smoke_ln, "--val-data-list", smoke_ln,
              "--test-data-list", smoke_ln,
              "--data-path", lines_dir.rstrip("/") + "/",
              "--embed-dim", "64", "--depth", "1", "--num-heads", "2",
              "--compute-dtype", "float32", "--num-workers", "2",
              "--val-bs", str(min(8, n_lines)), "--device", device]
    from htr_vt_torch.cli.test import main as test_main
    from htr_vt_torch.cli.train import main as train_main
    train_main(common + ["--train-bs", str(min(8, n_lines)),
                         "--total-iter", "3", "--eval-iter", "3", "--print-iter", "1",
                         "--warm-up-iter", "1"])
    run_dir = os.path.join(smoke_dir, "smoke")
    if not os.path.exists(os.path.join(run_dir, "best_CER")):
        _fail("smoke", f"training produced no best_CER checkpoint in "
              f"{run_dir}")
    test_main(common + ["--checkpoint", os.path.join(run_dir, "best_CER")])
    with open(os.path.join(run_dir, "predictions.json")) as f:
        cer = json.load(f)["CER"]
    _ok("smoke", f"{n_lines}-line train+eval completed, checkpoint at "
        f"{run_dir}/best_CER, test CER {cer:.4f}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="preflight + format + list-check (+ smoke) for real "
                    "IAM/READ2016 archives")
    sub = p.add_subparsers(dest="cmd", required=True)
    iam = sub.add_parser("iam")
    iam.add_argument("--archive", required=True, help="IAM lines.tgz")
    iam.add_argument("--xml-dir", required=True, help="IAM form XML dir")
    iam.add_argument("--expect-sha256", default=None)
    read = sub.add_parser("read2016")
    read.add_argument("--pages-dir", required=True)
    read.add_argument("--xml-dir", required=True)
    for s in (iam, read):
        s.add_argument("--out", required=True, help="output lines/ dir")
        s.add_argument("--lists", required=True,
                       help="dir of shipped .ln split lists "
                            "(e.g. data/iam)")
        s.add_argument("--smoke", action="store_true",
                       help="run a 10-line train/eval after formatting")
        s.add_argument("--report", default=None,
                       help="write the preflight report JSON here")
        s.add_argument("--device", default="cuda",
                       help="device of the smoke run: cuda (the card) or cpu")
    args = p.parse_args(argv)

    if args.cmd == "iam":
        report = preflight_iam(args.archive, args.xml_dir, args.expect_sha256)
        from htr_vt_torch.data.format_datasets import format_iam
        n = format_iam(args.archive, args.xml_dir, args.out)
    else:
        report = preflight_read2016(args.pages_dir, args.xml_dir)
        from htr_vt_torch.data.format_datasets import format_read2016
        n = format_read2016(args.pages_dir, args.xml_dir, args.out)
    _ok("format", f"wrote {n} line png+txt pairs to {args.out}")
    report["n_formatted"] = n

    report["list_coverage"] = check_lists(args.lists, args.out)
    if args.smoke:
        smoke_train(args.out, args.lists, args.cmd, args.out, device=args.device)
        report["smoke"] = "ok"
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
