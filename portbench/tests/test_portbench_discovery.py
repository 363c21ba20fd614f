"""Every name in BENCHMARK.json finds its files, and the file keeps to the
benchmark file's format (keys, names, units, bounds)."""

import json
import re
from pathlib import Path

import pytest

from portbench import reference, run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_to_its_files(workload):
    cell = run.resolve(run.ROOT, workload)
    assert cell["config"]["name"] == cell["workload"]["config"]
    assert set(cell["config"]["limits"]) == {"lats_err", "gen_image_err", "mask_err", "image_err"}
    ref = reference.module(cell["config"])
    assert callable(ref.build) and callable(ref.batch_noise)
    loop = run.loop_module(cell["traffic"]["loop"])
    assert callable(loop.warm_up) and callable(loop.window)
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(run.metric_module(m["name"]).read)
    ends = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in ends and {n.split(".")[0] for n in ends} == {"setup_s", "img_per_s"}
    # every per-layer metric of the cell moves an end-to-end metric it reports
    assert cell["per_layer"] and all(m["moves"] in ends for m in cell["per_layer"])


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (run.ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    ends = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in ends for m in BENCH["per_layer"])


def test_a_missing_cell_is_refused():
    with pytest.raises(SystemExit):
        run.resolve(run.ROOT, "no_such_cell")


def test_without_a_card_the_run_prints_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
