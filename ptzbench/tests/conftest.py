"""CPU tests of the benchmark harness: a tiny copy of the benchmark (the
committed data files, cut to 320 x 180 frames and small capacities) that
the harness runs on the CPU, where the program's plain route and the
reference are the same arithmetic. Tests that need the card carry the
``cuda`` marker and decide in the ``cuda_device`` fixture."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY = dict(width=320, height=180)
TINY_SLAM = dict(
    image_width=320, image_height=180, max_keypoints=128, max_rays=64, max_map_rays=512, max_keyframes=8,
    keyframe_interval=10,
)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def make_tiny_root(root: Path) -> Path:
    """A benchmark root with the committed metrics and limits, every
    configuration file at ``TINY`` and the mixes cut to match, and a cell
    ``tiny_<frontend>.<mix>`` for each cell the harness holds limits for:
    the committed cells, and ``klt720.steady``, calibrated and left out of
    ``BENCHMARK.json`` until the program relocalizes in KLT mode."""
    (root / "ptzbench").mkdir(parents=True)
    for kind in ("metrics", "limits", "traffic", "configs"):
        shutil.copytree(REPO / "ptzbench" / kind, root / "ptzbench" / kind, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    frontends = {}
    for path in sorted((REPO / "ptzbench/configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        cfg.update(TINY)
        cfg["slam"].update(TINY_SLAM)
        name = "tiny_" + cfg["frontend"]
        frontends[path.stem] = name
        (root / f"ptzbench/configs/{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "x", "file": f"ptzbench/configs/{name}.json", "reduced": [], "why": "x"})
    for path in (root / "ptzbench/traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["path"].update(f0=500.0, f=[[60.0, mix["path"]["stack"]]])
        mix["chunk"] = 1 if mix["loop"] == "open" else 24
        if mix["loop"] == "open":
            mix["rate_fps"] = 30.0
            mix["check"]["segment_calls"] = 24
        if mix.get("cuts"):
            mix["cuts"].update(main=[24, 36], away=[6, 9])
            mix["cuts"]["away_path"].update(frames=24, start_lo=[-0.4, -0.15, 400.0], start_hi=[0.4, 0.05, 700.0])
        mix["trace"]["frames"] = 24
        path.write_text(json.dumps(mix))
    for path in sorted((REPO / "ptzbench/limits").glob("*.json")):
        cfg_name, mix = path.stem.split(".")
        tiny = f"{frontends[cfg_name]}.{mix}"
        bench["workloads"].append({"name": tiny, "config": frontends[cfg_name], "traffic": mix, "chips": 1, "why": "x"})
        shutil.copy(path, root / f"ptzbench/limits/{tiny}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if path.stem in m.get("workloads", ()):
                m["workloads"].append(tiny)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench"))


def run_tiny(root: Path, cell: str, seconds: float = 1.5, traced: bool = False, seed: int = 2**31 + 7, **kw):
    """One run of a tiny cell on the CPU: (result, check lines)."""
    import time

    import torch

    from ptzbench import run
    from ptzbench.registry import Registry

    reg = Registry(root)
    return run.run_cell(reg, reg.cell(cell), seed, seconds, traced, torch.device("cpu"), t_import=time.perf_counter(), **kw)
