"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import re

import pytest

from htrbench.manifest import HERE, NAME, ROOT, UNIT, Bench, load_json

SPEC = load_json(ROOT / "BENCHMARK.json")


def files_named(bench):
    """Every file the manifest names, by what names it."""
    out = {}
    for name, c in bench.configs.items():
        out[f"config {name}"] = bench.root / c["file"]
    for name, w in bench.cells.items():
        out[f"traffic {w['traffic']}"] = HERE / "traffic" / f"{w['traffic']}.json"
        out[f"limits {name}"] = HERE / "limits" / f"{name}.json"
        drv = load_json(out[f"traffic {w['traffic']}"])["driver"]
        out[f"driver {drv}"] = HERE / "drivers" / f"{drv}.py"
    for m in bench.spec["per_layer"]:
        out[f"metric {m['name']}"] = HERE / "metrics" / f"{m['name']}.py"
    return out


KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(SPEC) == KEYS
    assert SPEC["paths"] == ["htrbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(isinstance(w, str) and 1 <= len(w) <= 200 for w in SPEC["command"])
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("what", sorted(files_named(Bench())))
def test_every_named_file_exists(what):
    path = files_named(Bench())[what]
    assert path.is_file(), what
    assert HERE in path.parents


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[group]}) == len(SPEC[group])
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_entries_have_exactly_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_what_its_metrics_move():
    bench = Bench()
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for cell in bench.cells:
        reported = {m["name"] for m in bench.end_to_end(cell)}
        assert "setup_s" in reported and len(reported) >= 2
        layers = bench.per_layer(cell)
        assert layers, cell
        for m in layers:
            assert m["moves"] in e2e and m["moves"] in reported, (cell, m["name"])


def test_configuration_files_state_what_is_run():
    for c in SPEC["configs"]:
        f = load_json(ROOT / c["file"])
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        m = f["model"]
        assert (m["embed_dim"], m["depth"], m["num_heads"], m["img_size"]) == (768, 4, 6, [64, 512])
        assert re.match(r"^https?://", c["source"])


def test_every_per_layer_metric_has_a_reader():
    bench = Bench()
    for m in SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]))
        base = m["name"].split(".")[0]
        assert base.endswith("_roofline") or "roofline" not in base
