"""The harness finds configurations, traffic mixes, per-layer metrics and
limits by name: a cell made of new files and new entries alone runs."""

from __future__ import annotations

import json

from conftest import run_tiny

from ptzbench.registry import Registry


def test_every_committed_cell_resolves():
    from conftest import REPO

    reg = Registry(REPO)
    for w in reg.bench["workloads"]:
        cell = reg.cell(w["name"])
        assert cell.config["frontend"] in ("redetect", "klt")
        assert cell.mix["loop"] in ("closed", "open")
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(reg.reader(m["name"]))


def test_a_cell_added_as_files_only_runs(tiny_root):
    """A dummy configuration, traffic mix, per-layer metric and cell, added
    as new files and new entries of BENCHMARK.json: the harness runs it
    and reports the dummy metric."""
    pkg = tiny_root / "ptzbench"
    cfg = json.loads((pkg / "configs/tiny_redetect.json").read_text())
    cfg["slam"]["max_keypoints"] = 96
    (pkg / "configs/dummy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((pkg / "traffic/steady.json").read_text())
    mix["chunk"] = 8
    (pkg / "traffic/dummy_mix.json").write_text(json.dumps(mix))
    (pkg / "metrics/dummy_frames.py").write_text("def read(view):\n    return float(view.frames)\n")
    (pkg / "metrics/dummy_nothing.py").write_text("def read(view):\n    return None\n")
    (pkg / "limits/dummy_cfg.dummy_mix.json").write_text((pkg / "limits/redetect720.steady.json").read_text())
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy_cfg", "source": "x", "file": "ptzbench/configs/dummy_cfg.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg", "traffic": "dummy_mix", "chips": 1, "why": "x"})
    for name in ("dummy_frames", "dummy_nothing"):
        bench["per_layer"].append({"name": name, "unit": "frames", "better": "lower", "source": "device_trace",
                                   "layer": "x", "moves": "fps", "workloads": ["dummy_cfg.dummy_mix"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    reg = Registry(tiny_root)
    cell = reg.cell("dummy_cfg.dummy_mix")
    assert cell.config["slam"]["max_keypoints"] == 96 and cell.mix["chunk"] == 8
    res, lines = run_tiny(tiny_root, "dummy_cfg.dummy_mix", traced=True)
    assert res["correct"], lines
    assert res["metrics"]["dummy_frames"]["value"] > 0          # the trace's stretch: at least one call
    assert "dummy_nothing" not in res["metrics"]                # a reader that finds nothing: left out
    assert list(res)[-1] == "checks" and lines[-1].startswith("check ")


def test_untraced_run_reports_the_cells_end_to_end_metrics(tiny_root):
    res, _ = run_tiny(tiny_root, "tiny_redetect.steady")
    assert set(res["metrics"]) == {"setup_s", "fps"}
    assert res["metrics"]["fps"]["unit"] == "frames/s" and res["metrics"]["fps"]["value"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
