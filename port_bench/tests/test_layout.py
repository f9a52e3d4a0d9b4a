"""The benchmark is driven by data: every file a name points to exists,
and BENCHMARK.json keeps to the contract's names and units."""

import json
import re

import pytest

from port_bench import harness

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_each_cell_is_its_workload_file(cell):
    loaded = harness.load_cell(cell["name"])
    assert {k: loaded.workload[k] for k in ("config", "traffic", "chips", "why")} == \
        {k: cell[k] for k in ("config", "traffic", "chips", "why")}
    assert loaded.cfg["name"] == cell["config"]
    for kind in ("programs", "reference", "work"):
        assert loaded.module(kind) is not None
    assert (harness.BENCH / "traffic_kinds" / f"{loaded.traffic['kind']}.py").exists()
    assert callable(loaded.module("programs").alter_row)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_each_config_is_its_file(cfg):
    data = json.loads((harness.REPO / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert data["limits"] and set(data["limits"]) <= {"loss_gap", "grad_gap", "grad_gap_median",
                                                      "update_gap", "update_gap_median",
                                                      "token_gap", "logit_gap"}
    assert cfg["file"].startswith(BENCH["paths"][0] + "/")


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_each_metric_has_a_reader_and_legal_names(metric):
    assert callable(harness.reader(metric["name"]))
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", []):
        assert (harness.BENCH / "workloads" / f"{cell}.json").exists()


def test_names_are_legal_and_unique():
    for group in ("configs", "workloads"):
        names = [c["name"] for c in BENCH[group]]
        assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_the_recurrence_set_names_kernels():
    reader = harness.reader("kernel_roofline_pct.recurrence")
    names = reader.__globals__["kernel_names"]("recurrence")
    assert {"gru_wide_fwd", "gru_wide_bwd", "hier_wave_fwd", "atb_tc", "rows_tc"} <= names
    # a kernel set holds names only; its work counts live under work/<set>/
    assert {p.suffix for p in (harness.BENCH / "kernel_sets" / "recurrence").iterdir()} == {".txt"}


def test_an_unknown_traffic_kind_is_refused():
    from port_bench import data

    with pytest.raises(ValueError, match="unknown traffic kind"):
        data.make_inputs({"kind": "no_such_kind"}, {}, 1, "cpu")
