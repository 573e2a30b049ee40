"""The harness end to end at a tiny size on the CPU (the program's plain
kernels), and the discovery of configurations, traffic mixes, limits and
metric readers by name."""
import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import run
import workload as wl
from conftest import CELLS

ROOT = Path(__file__).resolve().parent.parent
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def cell_kind(name):
    """The kind of work of a cell: its traffic mix's unit."""
    return wl.load_cell(name)["traffic"]["unit"]


def _args(name, trace, seed=2**31 + 3, seconds=0.2):
    return argparse.Namespace(workload=name, seed=seed, seconds=seconds,
                              trace=trace)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_tiny_run(tiny, name, trace):
    result, lines = run.run(_args(name, trace), device="cpu",
                            cell=tiny(name))
    assert RESULT_KEYS <= set(result)
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    spec = wl.load_cell(name)["spec"]
    work = {w["name"]: w for w in spec["workloads"]}[name]
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in run.cell_metrics(spec, work, kind)}
    if trace:
        # span and counter metrics read on the CPU; trace metrics need
        # the card's profiler and are left out
        read = {m.split(".")[0] for m in result["metrics"]}
        assert {"update_ms", "gemm_launches"} <= read
        assert set(result["metrics"]) <= names
        if name.startswith("lu_"):
            assert {"panel_ms", "pivot_ms", "trsm_ms"} <= read
    else:
        kind = cell_kind(name)
        assert set(result["metrics"]) == names == {f"gflops.{kind}",
                                                   "setup_s"}
    for m, v in result["metrics"].items():
        assert v["value"] >= 0 and v["unit"]
    assert lines and all("limit" in line for line in lines)
    json.dumps(result)


@pytest.mark.parametrize("name", CELLS)
def test_discovery_by_name(name):
    cell = wl.load_cell(name)
    assert cell["config"]["name"] == cell["workload"]["config"]
    assert callable(wl.load_module("units", cell["traffic"]["unit"]).make)
    assert cell["limits"]
    for m in cell["spec"]["end_to_end"] + cell["spec"]["per_layer"]:
        reader = run.load_metric(m["name"])
        assert callable(reader.read)
    with pytest.raises(SystemExit):
        wl.load_cell("no_such.cell")
    with pytest.raises(ValueError):
        wl.load_module("units", "no_such_unit")


def test_lu_update_stream_needs_data_only(tiny):
    """The LU's update stream (a later cell) from the LU configuration
    and the update mix as they are: C - L21 U12, no transpose."""
    lu = tiny(CELLS[0])
    cell = dict(tiny(CELLS[1]), config=lu["config"])
    result, _ = run.run(_args("lu.updates", 0), device="cpu", cell=cell)
    assert result["correct"] is True and result["attempted"] > 0


UNIT = """
import workload as wl

class Count(wl.Unit):
    flops, answers = 1.0, 1

    def run(self):
        return 1

    def check(self, limits):
        return {"wrong": 0.0}, 0, {}

def make(cfg, traffic, seed, device):
    return Count()
"""
METRIC = """
def read(ctx):
    return ctx.units / ctx.window_s
"""


def test_new_unit_and_metric_are_files_only(tmp_path, monkeypatch):
    """A unit of work and an end-to-end metric that the harness has never
    seen, added as one file each, run with no edit of the harness."""
    for folder in ("units", "metrics"):
        (tmp_path / folder).mkdir()
        for f in (wl.BENCH / folder).glob("*.py"):
            (tmp_path / folder / f.name).write_text(f.read_text())
    (tmp_path / "units" / "count.py").write_text(UNIT)
    (tmp_path / "metrics" / "units_per_s.py").write_text(METRIC)
    monkeypatch.setattr(wl, "BENCH", tmp_path)
    spec = {"end_to_end": [
        {"name": "units_per_s", "unit": "1/s", "better": "higher"},
        {"name": "setup_s", "unit": "s", "better": "lower"}],
        "per_layer": []}
    cell = {"spec": spec, "workload": {"name": "x.count", "chips": 1},
            "config": {}, "traffic": {"unit": "count"},
            "limits": {"wrong": 0.0}}
    result, lines = run.run(_args("x.count", 0), device="cpu", cell=cell)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"units_per_s", "setup_s"}
    assert result["metrics"]["units_per_s"]["value"] > 0


def test_per_layer_selection():
    """Each cell's per-layer metrics move the end-to-end metric it
    reports; a quantity read in both cells is split by kind of cell."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    upd = {m["name"] for m in run.cell_metrics(
        spec, work["chol_p32e2_n1024.updates_b100"], "per_layer")}
    assert "panel_ms" not in upd and "update_roofline.updates" in upd
    lu = {m["name"] for m in run.cell_metrics(
        spec, work["lu_p32e2_n1024.factor_b300"], "per_layer")}
    assert not lu & upd
    assert lu | upd == {m["name"] for m in spec["per_layer"]}
    assert "update_roofline.factor" in lu and "panel_ms" in lu
    for m in spec["per_layer"]:
        assert run.load_metric(m["name"]).__file__.endswith(
            f"/metrics/{m['name'].split('.')[0]}.py")


def test_seed_fixes_the_inputs(tiny):
    cell = tiny(CELLS[0])
    big = 2**31 + 12345
    a = wl.make_words(cell["config"], cell["traffic"], big, "cpu")
    b = wl.make_words(cell["config"], cell["traffic"], big, "cpu")
    c = wl.make_words(cell["config"], cell["traffic"], big + 1, "cpu")
    assert a.equal(b) and not a.equal(c)


def test_refuses_without_a_card(tmp_path):
    """No card (this machine), or a checkout of the benchmark alone: a
    non-zero exit and nothing on standard output."""
    cmd = [sys.executable, "bench/run.py", "--workload", CELLS[0],
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    here = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    alone = subprocess.run(cmd, cwd=tmp_path, capture_output=True,
                           text=True, timeout=300)
    for proc in (here, alone):
        assert proc.returncode != 0
        assert proc.stdout.strip() == ""
