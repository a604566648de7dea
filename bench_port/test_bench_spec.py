"""BENCHMARK.json against the contract's shape, and every name resolving to
its files: a configuration, a traffic mix and its runner, each metric's
reader; a throwaway extra entry resolves from added files alone."""

import json
import re
import shutil

import pytest

from bench_rehearsal import with_later
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load()
MERGED = with_later(BENCH)  # with the cells that later.json keeps
WORKLOADS = [w["name"] for w in MERGED["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("bench", [BENCH, MERGED], ids=["BENCHMARK.json", "with later.json"])
def test_entries(bench):
    names = set()
    assert {c["name"] for c in bench["configs"]} == {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_port/") and len(c["source"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in bench["end_to_end"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves(workload):
    cell = spec.resolve(MERGED, workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:  # each per-layer metric's end-to-end metric is reported here
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]))
    assert callable(spec.runner(cell.traffic).run)


def test_extra_entries_resolve_from_added_files_alone(tmp_path):
    """A new configuration, traffic mix and per-layer metric: new files and
    new entries, no existing file edited."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench_port").rglob("*") if p.is_file()}
    cfg = json.loads((tmp_path / "bench_port/configs/kodak-q75-m4.json").read_text())
    (tmp_path / "bench_port/configs/kodak-q75-m6.json").write_text(
        json.dumps({**cfg, "name": "kodak-q75-m6", "method": 6}))
    mix = json.loads((tmp_path / "bench_port/traffic/encode-pipeline.json").read_text())
    (tmp_path / "bench_port/traffic/encode-pipeline-b64.json").write_text(
        json.dumps({**mix, "batch": 64}))
    (tmp_path / "bench_port/metrics/enc.extra_ms.py").write_text(
        "def read(r):\n    return 1.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({**bench["configs"][0], "name": "kodak-q75-m6",
                             "file": "bench_port/configs/kodak-q75-m6.json"})
    bench["workloads"].append({"name": "kodak-q75-m6.encode-b64", "config": "kodak-q75-m6",
                               "traffic": "encode-pipeline-b64", "chips": 1, "why": "m6 b64"})
    bench["per_layer"].append({"name": "enc.extra_ms", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "pipeline lane",
                               "moves": "encode_img_s", "workloads": ["kodak-q75-m6.encode-b64"]})
    for m in bench["end_to_end"]:
        if m["name"] == "encode_img_s":
            m["workloads"].append("kodak-q75-m6.encode-b64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve(bench, "kodak-q75-m6.encode-b64", tmp_path)
    assert cell.config["method"] == 6 and cell.traffic["batch"] == 64
    assert spec.reader("enc.extra_ms", tmp_path)(None) == 1.0
    assert "enc.extra_ms" in [m["name"] for m in cell.per_layer]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_missing_reader_is_named():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "enc.nowhere_ms", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "pipeline lane",
                               "moves": "encode_img_s"})
    with pytest.raises(KeyError, match="enc.nowhere_ms"):
        spec.resolve(bench, WORKLOADS[0])
