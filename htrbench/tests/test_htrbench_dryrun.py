"""A tiny CPU run of each cell, through each driver, prints a well-formed
last line."""

import json

import pytest

from htrbench.manifest import Bench
from htrbench.run import emit, execute
from htrbench.tests.tiny import DRY_RUNS

BENCH = Bench()


def _last_line(capsys, cell, overrides, trace):
    emit(execute(cell, 2**31 + 3, 0.2, trace, "cpu", overrides))
    out, err = capsys.readouterr()
    assert err.strip().splitlines()[-1].startswith("htrbench: compared ")
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(DRY_RUNS))
@pytest.mark.parametrize("trace", [False, True])
def test_last_line(capsys, case, trace):
    cell, overrides = DRY_RUNS[case]
    res = _last_line(capsys, cell, overrides, trace)
    assert list(res)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for c in res["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
        allowed = {m["name"] for m in BENCH.per_layer(cell)}
        assert set(res["metrics"]) <= allowed
        assert ("train_mfu" if "train" in cell else "serve_mfu") in res["metrics"]
    else:
        assert set(res["metrics"]) == {m["name"] for m in BENCH.end_to_end(cell)}
