"""The shape of a run's last line."""

import json

from .tiny import run_tiny, tiny_cell


def test_result_line_keys_and_metrics():
    cell = tiny_cell("synth_full.train")
    res = run_tiny("synth_full.train")
    json.loads(json.dumps(res))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in cell.e2e}
    for m in cell.e2e:
        assert res["metrics"][m["name"]]["unit"] == m["unit"]
        assert res["metrics"][m["name"]]["value"] > 0 or m["name"] == "peak_gib"
    assert set(res["checks"]) == set(cell.workload["limits"])
    for row in res["checks"].values():
        assert set(row) == {"value", "limit"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


def test_traced_line_has_per_layer_metrics_and_breakdown():
    cell = tiny_cell("synth_full.serve")
    res = run_tiny("synth_full.serve", trace=True)
    names = {m["name"] for m in cell.per_layer}
    assert set(res["metrics"]) <= names and res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
