"""The host-side entry points of the port against the JAX package's, on the
byte-faithful miniatures of ``tests/test_real_data_path.py`` (an IAM
``lines.tgz`` with form XMLs, a READ2016 page scan with PAGE-XML):

- ``htr_vt_torch/data/format_datasets.py``: the same output tree as JAX's
  formatter (names, label text, PNG pixels) for IAM and READ2016, and the
  same flattening;
- ``htr_vt_torch/cli/prepare_data.py``: the same preflight report and
  formatted tree as JAX's runbook, a ``--smoke`` run through the port's
  ``cli/train.py`` and ``cli/test.py``, and the same refusal of an XML
  directory from another release;
- ``cli/serve.py --selftest``: the same line files (names and pixels) and
  labels as JAX's serve CLI draws for the same seed, and the scored run on
  the smoke run's checkpoint.
"""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

import htr_vt_tpu.data.synthetic as jsynthetic
from htr_vt_tpu.cli import prepare_data as jprepare
from htr_vt_tpu.data import format_datasets as jformat
from htr_vt_tpu.data.synthetic import render_line
from htr_vt_torch.cli import prepare_data, serve
from htr_vt_torch.config import dataset_preset
from htr_vt_torch.data import format_datasets
from test_real_data_path import IAM_LINES, iam_disk  # noqa: F401  (the fixture)
from test_torch_port_model import no_tensorboard  # noqa: F401


def tree(path):
    """{name: text of a .txt, or the pixels of a .png} of a directory."""
    out = {}
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if name.endswith(".txt"):
            with open(full, encoding="utf-8") as f:
                out[name] = f.read()
        elif name.endswith(".png"):
            out[name] = np.array(Image.open(full))
    return out


def assert_same_tree(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v, k
        else:
            assert np.array_equal(got[k], v), k


def test_iam_formatter_matches_jax(iam_disk, tmp_path):  # noqa: F811
    out = str(tmp_path / "lines")
    n = format_datasets.format_iam(str(iam_disk / "lines.tgz"), str(iam_disk / "xml"), out)
    assert n == len(IAM_LINES)
    assert_same_tree(tree(out), tree(str(iam_disk / "lines")))
    assert tree(out)["a01-003-00.txt"] == "crossed out words kept"


def read2016_disk(root):
    """tests/test_real_data_path.py:test_read2016_page_xml_formatter's page
    and PAGE-XML."""
    pages, xmls = root / "pages", root / "page_xml"
    pages.mkdir(), xmls.mkdir()
    page = np.full((300, 800), 255, np.uint8)
    texts = ["erste zeile text", "zweite zeile hier"]
    boxes = [(40, 30, 720, 90), (60, 150, 700, 210)]
    for (x0, y0, x1, y1), t in zip(boxes, texts):
        page[y0:y1, x0:x1] = render_line(t, y1 - y0, x1 - x0)
    Image.fromarray(page).save(str(pages / "page_0001.JPG"))
    ns = "http://schema.primaresearch.org/PAGE/gts/pagecontent/2013-07-15"
    regions = "\n".join(
        f'  <TextLine id="l{i}"><Coords points="{x0},{y0} {x1},{y0} {x1},{y1} {x0},{y1}"/>'
        f'<TextEquiv><Unicode>{t}</Unicode></TextEquiv></TextLine>'
        for i, ((x0, y0, x1, y1), t) in enumerate(zip(boxes, texts)))
    (xmls / "page_0001.xml").write_text(
        f'<?xml version="1.0"?>\n<PcGts xmlns="{ns}"><Page>\n{regions}\n</Page></PcGts>\n')
    return str(pages), str(xmls)


def test_read2016_formatter_and_flatten_match_jax(tmp_path):
    pages, xmls = read2016_disk(tmp_path)
    outs = {}
    for name, mod in (("port", format_datasets), ("jax", jformat)):
        out = str(tmp_path / name)
        assert mod.format_read2016(pages, xmls, out) == 2
        outs[name] = tree(out)
    assert_same_tree(outs["port"], outs["jax"])
    assert outs["port"]["page_0001_l1.txt"] == "zweite zeile hier"
    for name, mod in (("port", format_datasets), ("jax", jformat)):
        root = tmp_path / f"flat_{name}"
        (root / "a" / "b").mkdir(parents=True)
        (root / "a" / "b" / "x.png").write_bytes(b"p")
        (root / "a" / "y.txt").write_text("t")
        mod.flatten_directory(str(root))
        assert sorted(os.listdir(root)) == ["x.png", "y.txt"]


@pytest.fixture(scope="module")
def prepared(iam_disk, tmp_path_factory):  # noqa: F811
    """The port's runbook with ``--smoke`` and JAX's without (its smoke
    would compile JAX's trainer), on the IAM miniature."""
    tmp = tmp_path_factory.mktemp("prepare")
    common = ["iam", "--archive", str(iam_disk / "lines.tgz"), "--xml-dir",
              str(iam_disk / "xml"), "--lists", str(iam_disk)]
    prepare_data.main(common + ["--out", str(tmp / "port"), "--report",
                                str(tmp / "port.json"), "--smoke", "--device", "cpu"])
    argv = sys.argv
    try:
        sys.argv = ["prepare_data"] + common + ["--out", str(tmp / "jax"), "--report",
                                                str(tmp / "jax.json")]
        jprepare.main()
    finally:
        sys.argv = argv
    return tmp


def test_prepare_data_matches_jax_and_smoke_trains(prepared, capsys):
    with open(prepared / "port.json") as f:
        port = json.load(f)
    with open(prepared / "jax.json") as f:
        jax_report = json.load(f)
    assert port.pop("smoke") == "ok"
    assert port == jax_report
    assert port["n_formatted"] == len(IAM_LINES)
    got, want = tree(str(prepared / "port")), tree(str(prepared / "jax"))
    assert_same_tree(got, want)
    run = prepared / "port" / "_smoke" / "smoke"
    assert (run / "best_CER").is_dir()
    with open(run / "predictions.json") as f:
        preds = json.load(f)
    assert len(preds["samples"]) == 8 and 0.0 <= preds["CER"] <= 3.0


def test_prepare_data_rejects_mismatched_xml(iam_disk, tmp_path, capsys):  # noqa: F811
    bad_xml = tmp_path / "xml"
    bad_xml.mkdir()
    (bad_xml / "z99-999.xml").write_text(
        '<?xml version="1.0"?>\n<form id="z99-999">\n'
        '  <line id="z99-999-00" text="unrelated"/>\n</form>\n')
    with pytest.raises(SystemExit) as e:
        prepare_data.main(["iam", "--archive", str(iam_disk / "lines.tgz"),
                           "--xml-dir", str(bad_xml), "--out", str(tmp_path / "o"),
                           "--lists", str(iam_disk), "--device", "cpu"])
    assert e.value.code == 1
    assert "join: FAIL" in capsys.readouterr().out


class _Drawn(Exception):
    """Stops JAX's serve CLI once its selftest lines are drawn."""


def jax_selftest(tmp_path, monkeypatch, n, max_chars):
    """(names, pixels, labels) of the lines JAX's ``serve --selftest``
    draws: its CLI run up to the lines, recording each text and how much
    of it rendered."""
    from htr_vt_tpu.cli import serve as jserve
    drawn = []
    render = jsynthetic.render_line

    def recorded(text, *a, **k):
        img, n_drawn = render(text, *a, **k)
        drawn.append(text[:n_drawn].rstrip())
        return img, n_drawn

    out = tmp_path / "jax_selftest"
    out.mkdir()
    monkeypatch.setattr(jsynthetic, "render_line", recorded)
    monkeypatch.setattr("tempfile.mkdtemp", lambda **k: str(out))
    monkeypatch.setattr(jserve, "build_dataset", lambda *a, **k: (_ for _ in ()).throw(
        _Drawn()))
    monkeypatch.setattr(sys, "argv", ["serve", "IAM", "--checkpoint", "unused",
                                      "--selftest", "--selftest-n", str(n),
                                      "--selftest-max-chars", str(max_chars)])
    with pytest.raises(_Drawn):
        jserve.main()
    monkeypatch.undo()
    return tree(str(out)), drawn


def test_selftest_lines_match_jax(tmp_path, monkeypatch):
    want, want_labels = jax_selftest(tmp_path, monkeypatch, 6, 40)
    out = tmp_path / "port_selftest"
    out.mkdir()
    paths, labels = serve.selftest_lines(6, 40, dataset_preset("IAM").data.synth_alphabet,
                                         str(out))
    assert [os.path.basename(p) for p in paths] == [f"line_{i:03d}.png" for i in range(6)]
    assert labels == want_labels
    assert_same_tree(tree(str(out)), want)


def test_serve_selftest_scores_the_buckets(prepared, capsys):
    ckpt = prepared / "port" / "_smoke" / "smoke" / "best_CER"
    serve.main(["IAM", "--checkpoint", str(ckpt), "--selftest", "--selftest-n", "5",
                "--selftest-max-chars", "30", "--batch-size", "4",
                "--width-buckets", "256,512", "--device", "cpu"])
    captured = capsys.readouterr()
    records = [json.loads(line) for line in captured.out.splitlines() if line.startswith("{")]
    assert [os.path.basename(r["image"]) for r in records] == \
        [f"line_{i:03d}.png" for i in range(5)]
    assert "# selftest CER" in captured.err and "#   bucket   512" in captured.err
