"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names: names and units of the allowed characters, each cell's metrics,
each metric's ``moves``, the configuration files against the port's
registered architectures."""
import dataclasses
import re

import pytest

from rmabench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rmabench"]
    assert BENCH["command"][:2] == ["python3", "rmabench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and \
        1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + list(CELLS) + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] == 1
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])


def test_end_to_end_metrics():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_reports_enough(cell):
    e2e = [m for m in BENCH["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert any(_reports(m, cell) for m in BENCH["per_layer"])


def test_per_layer_metrics_move_a_metric_their_cells_report():
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        assert m["moves"] in E2E, m
        for cell in m["workloads"]:
            assert _reports(E2E[m["moves"]], cell), (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_name_has_its_file():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert hasattr(harness.load_module("metrics", m["name"]), "read")
    for name, w in CELLS.items():
        spec = harness.load_json("workloads", f"{name}.json")
        assert spec["config"] == w["config"] and spec["traffic"] == \
            w["traffic"] and spec["why"] == w["why"]
        assert hasattr(harness.load_module("drivers", spec["driver"]),
                       "window")
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"] == f"rmabench/configs/{c['name']}.json"
        spec = harness.load_json("configs", f"{c['name']}.json")
        assert spec["reduced"] == c["reduced"] and spec["name"] == c["name"]
        assert set(c["reduced"]) <= set(spec["published"])
        assert hasattr(harness.load_module("reference", spec["reference"]),
                       "logits")


#: published key → the port's field (value as run)
PUBLISHED = {"hidden_size": "d_model", "intermediate_size": "d_ff",
             "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv_heads",
             "num_hidden_layers": "n_layers", "vocab_size": "vocab",
             "head_dim": "head_dim", "norm_epsilon": "norm_eps",
             "rms_norm_eps": "norm_eps"}


@pytest.mark.parametrize("name", ["starcoder2-3b-x15-dp4",
                                  "jamba-v0.1-52b-x8"])
def test_config_is_the_registered_arch(name):
    pytest.importorskip("repro_torch")
    from repro_torch.configs import get_config

    spec = harness.load_json("configs", f"{name}.json")
    model = spec["model"]
    reg = dataclasses.asdict(get_config(model["name"]))
    # the depth cut, and a capacity that never drops (stated under assumed)
    changed = {k for k in reg if reg[k] != model[k]}
    assert changed <= {"n_layers", "moe"}
    if "moe" in changed:
        diff = {k for k in reg["moe"] if reg["moe"][k] != model["moe"][k]}
        assert diff == {"capacity_factor"} and "capacity_factor" in \
            spec["assumed"]
        assert model["moe"]["capacity_factor"] == \
            model["moe"]["num_experts"] / model["moe"]["top_k"]
    for key, field in PUBLISHED.items():
        if key in spec["published"]:
            assert spec["published"][key] == model[field], key
    assert all(k in spec["assumed"] for k in spec["reduced"])
    harness.model_config(model)          # builds
