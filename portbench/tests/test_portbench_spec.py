"""The harness finds every piece of a cell by name, and a later change
adds a configuration, a mix, a per-layer metric and a cell as new files
alone; BENCHMARK.json keeps to the benchmark's contract."""
import json
import re
import shutil

import pytest

from portbench import spec
from portbench.tests import tiny

DOC = spec.benchmark(spec.BENCH_DIR.parent)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in DOC["workloads"]])
def test_cell_found_by_name(workload):
    cell = spec.cell(spec.BENCH_DIR.parent, workload)
    assert cell.config["name"] == workload.split(".")[0]
    assert cell.traffic["kind"] in ("serve", "train")
    spec.find_generator(cell.traffic["generator"])
    for m in cell.end_to_end:
        assert callable(spec.find_end_to_end(m["name"]))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.find_reader(m["name"]))
    assert cell.limits


def test_added_files_are_found_without_edits(tmp_path):
    root, bench = tiny.make(tmp_path)
    # a new configuration, mix, per-layer metric, limits and cell: files
    # and entries only
    cfg = json.loads((bench / "configs" / "starcoder2-3b-15L.json")
                     .read_text())
    cfg["name"] = "starcoder2-3b-8L"
    cfg["num_hidden_layers"] = 1
    (bench / "configs" / "starcoder2-3b-8L.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "serve_code.json").read_text())
    mix.pop("backlog")
    mix.update(generator="open_loop", rate_per_s=7.0)
    (bench / "traffic" / "serve_slow.json").write_text(json.dumps(mix))
    (bench / "metrics" / "answer.slow.py").write_text(
        "def read(rec):\n    return 42.0\n")
    (bench / "limits" / "starcoder2-3b-8L.serve_slow.json").write_text(
        json.dumps({"logit_gap": 1.0}))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "starcoder2-3b-8L.serve_slow",
                             "config": "starcoder2-3b-8L",
                             "traffic": "serve_slow", "chips": 1,
                             "why": "a slower mix"})
    doc["end_to_end"][0]["workloads"].append("starcoder2-3b-8L.serve_slow")
    doc["per_layer"].append({"name": "answer.slow", "unit": "rows",
                             "better": "higher", "source": "program_counter",
                             "layer": "device",
                             "moves": "serve_tokens_per_s",
                             "workloads": ["starcoder2-3b-8L.serve_slow"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = spec.cell(root, "starcoder2-3b-8L.serve_slow", bench)
    assert cell.config["num_hidden_layers"] == 1
    assert cell.traffic["rate_per_s"] == 7.0
    assert [m["name"] for m in cell.per_layer] == ["answer.slow"]
    assert spec.find_reader("answer.slow", bench)({}) == 42.0
    assert {m["name"] for m in cell.end_to_end} == {"serve_tokens_per_s",
                                                   "setup_s"}


def test_missing_pieces_raise(tmp_path):
    root, bench = tiny.make(tmp_path)
    with pytest.raises(KeyError):
        spec.cell(root, "no-such.cell", bench)
    shutil.rmtree(bench / "limits")
    with pytest.raises(FileNotFoundError):
        spec.cell(root, DOC["workloads"][0]["name"], bench)


def test_benchmark_json_keeps_to_the_contract():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["portbench"]
    assert DOC["command"][1] == "portbench/run.py"
    assert 1 <= DOC["run_seconds"] <= 51
    names = [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]]
    names += [c["name"] for c in DOC["configs"]]
    names += [w["name"] for w in DOC["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        data = json.loads((spec.BENCH_DIR.parent / c["file"]).read_text())
        assert set(c["reduced"]) == set(data["reduced"])
        assert 1 <= len(c["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in DOC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in DOC["end_to_end"]}
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in DOC["workloads"]:
        cell = spec.cell(spec.BENCH_DIR.parent, w["name"])
        assert any("mfu" in m["name"] for m in cell.per_layer)
