"""BENCHMARK.json against the contract's shape, and every part found by
name in a file of its own."""
import json
import math
import re

import pytest

from bench_cases import small_cell
from harness import runner, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"][1].startswith("benchmark/")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(bench)) < 64 * 1024


def test_bounds_and_budget(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.benchmark()["workloads"]])
def test_cell_found_by_name(workload):
    cell = spec.find_cell(workload)
    assert cell.chips == 1
    assert {"n_qubits", "n_basis", "per_step", "mc_steps", "problem",
            "reference"} <= set(cell.config)
    assert {"grad_mode", "n_seeds", "epochs_per_job", "lr"} <= set(
        cell.traffic)
    assert {"loss_gap", "grad_gap", "change_gap"} <= set(cell.limits)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer


def test_metric_files_state_their_entries(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = spec.metric_reader(m["name"])
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
        assert mod.BETTER == m["better"]
        if "layer" in m:
            assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
        listed = m.get("workloads")
        assert (tuple(listed) if listed else None) == mod.WORKLOADS


def test_configs_name_their_files(bench):
    for c in bench["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert c["file"].startswith("benchmark/configs/")
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == []
        assert math.isclose(cfg["T"], math.pi * (1 / cfg["omega0"]
                                                 + 1 / cfg["omega1"]))
        assert cfg["n_steps"] == int(cfg["per_step"] * (cfg["T"] + 1))


def test_chain_patterns_come_from_files():
    pats = spec.chain_kernel_patterns()
    assert "forward_kernel<" in pats and "pass_backward<" in pats


DECLARED = [("graph", "random"), ("form", "sparse"), ("T", 3.0),
            ("n_steps", 31), ("n_controls", 13)]


@pytest.mark.parametrize("key,value", DECLARED)
def test_a_declared_key_that_was_not_built_is_refused(key, value):
    """The program's side and the reference each build what the
    configuration states, and refuse it where a declared key differs from
    what they built."""
    cell = small_cell("maxcut_ring12.seeds2048")
    config = dict(cell.config, **{key: value})
    problem = spec.problem_module(config["problem"])
    problem.build(cell.config, cell.traffic, "cpu")
    with pytest.raises(ValueError):
        problem.build(config, cell.traffic, "cpu")
    ref = spec.reference_module(config["reference"])
    ref.build(cell.config, "cpu")
    if key in ("graph", "T", "n_steps", "n_controls"):
        with pytest.raises(ValueError):
            ref.build(config, "cpu")


def test_a_cell_of_more_than_one_card_is_refused():
    for chips in (0, 2, 4):
        with pytest.raises(runner.NoCard, match="no launcher"):
            runner.look_for_card(chips)
