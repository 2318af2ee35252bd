"""`BENCHMARK.json` against the benchmark's contract, and the cells,
configurations and metric readers found by name, a throwaway cell
included."""

import json
import re
import shutil

import pytest

from perfbench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for e in BENCH["workloads"] + BENCH["configs"]:
        for key in ("why", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_and_finds_its_files(cell):
    c = spec.load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    assert c.entry["chips"] == 1
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
    conf = next(x for x in BENCH["configs"] if x["name"] == c.entry["config"])
    assert conf["file"] == f"perfbench/configs/{c.entry['config']}.json"
    assert conf["reduced"] == c.config["reduced"]
    for key in c.config["reduced"]:
        assert key in c.config and not key.endswith(("_dim", "_rank"))
    assert set(c.traffic["limits"]) and "cli" in c.traffic


def test_a_throwaway_cell_is_found_by_its_files(tmp_path):
    """A later change adds a cell as files: a configuration, a traffic
    mix and a metric reader, and an entry of BENCHMARK.json."""
    here = tmp_path / "perfbench"
    shutil.copytree(spec.HERE / "configs", here / "configs")
    shutil.copytree(spec.HERE / "workloads", here / "workloads")
    (here / "metrics").mkdir()
    (here / "metrics" / "answer_s.x.py").write_text(
        "def read(run):\n    return 42.0 if run else None\n")
    traffic = json.loads((here / "workloads" / "bulk-boot100.json")
                         .read_text())
    traffic["name"] = "bulk-tiny"
    (here / "workloads" / "bulk-tiny.json").write_text(json.dumps(traffic))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "throwaway", "config":
                               "ont-cdna-gencode-bulk", "traffic": "bulk-tiny",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "answer_s.x", "unit": "s",
                               "better": "lower", "source": "program_span",
                               "layer": "x", "moves": "reads_per_s",
                               "workloads": ["throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load_cell("throwaway", root=tmp_path, here=here)
    assert c.traffic["name"] == "bulk-tiny"
    # a metric that lists its cells reads nothing in a cell it does not
    # name
    assert [m["name"] for m in c.per_layer] == ["answer_s.x"]
    new = [m for m in c.per_layer if m["name"] == "answer_s.x"]
    got = spec.read_metrics(new, run=object(), here=here)
    assert got == {"answer_s.x": {"value": 42.0, "unit": "s"}}
    assert spec.read_metrics(new, run=None, here=here) == {}
    with pytest.raises(KeyError):
        spec.load_cell("missing", root=tmp_path, here=here)
