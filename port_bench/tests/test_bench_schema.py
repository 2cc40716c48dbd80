"""BENCHMARK.json against the benchmark's contract, and every name in it
found by name under port_bench/."""

import json
import re

import pytest

from port_bench.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
HOME = ROOT / "port_bench"


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32 and all(line(w) for w in SPEC["command"])
    assert SPEC["paths"] == ["port_bench"]
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p


def test_entries_have_their_keys_and_legal_names():
    for section, keys in KEYS.items():
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names)), section
        for e in SPEC[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, e
            assert NAME.fullmatch(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and line(w["why"])
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
    for m in SPEC["per_layer"]:
        assert line(m["layer"])


def test_counts_bounds_and_budget():
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(pairs) // 4)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in SPEC["end_to_end"]}
    assert cells <= e2e["setup_s"]
    for cell in cells:
        assert any(cell in ws for n, ws in e2e.items() if n != "setup_s"), cell
        assert any(cell in m.get("workloads", cells) for m in SPEC["per_layer"]), cell
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]], (m["name"], cell)
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers <= {"device", "policy", "goals", "kernels", "train step", "data",
                      "evaluation", "cache"} | layers
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_parts_found_by_name(cell):
    from port_bench.harness.bench import Bench
    bench = Bench(ROOT)
    w = bench.cell(cell)
    doc = bench.config(w["config"])
    assert doc["family"] in ("mdtv", "mdt") and bench.reference(doc) is not None
    traffic = bench.traffic(w["traffic"])
    assert hasattr(bench.kind(traffic["kind"]), "Runner")
    assert set(bench.limits(cell)) and all(v > 0 for v in bench.limits(cell).values())
    for m in bench.metrics_of(cell, "per_layer"):
        assert callable(bench.reader(m["name"]).read)


def test_config_files_hold_the_config_as_run():
    from port_bench.harness.agent import agent_config
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        assert path.is_relative_to(HOME) and c["reduced"] == []
        doc = json.loads(path.read_text())
        default = {"mdtv": "MDTVConfig", "mdt": "MDTConfig"}[doc["family"]]
        import mdt_policy_tpu_torch.agents as agents
        assert agent_config(doc) == getattr(agents, default)()


def test_files_under_paths_are_named_from_name_characters():
    for p in HOME.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", str(p.relative_to(ROOT))), p


MIXES = [json.loads(p.read_text()) for p in (HOME / "traffic").glob("*.json")]


@pytest.mark.parametrize("name", sorted({m["sentences"] for m in MIXES if "kind" in m}))
def test_stored_token_ids_are_the_clip_tokenizers(name):
    """The ids stored beside each instruction are what the CLIP BPE
    tokenizer gives its sentence (the port's copy of it, read here only to
    check the data)."""
    from mdt_policy_tpu_torch.utils.clip_tokenizer import tokenize
    from port_bench.harness.serving import goal_tokens
    doc = json.loads((HOME / "traffic" / name).read_text())
    assert list(doc["clip_ids"]) == list(doc["sentences"])
    want = tokenize(list(doc["sentences"].values()), 77)
    got = goal_tokens({"sentences": name}, HOME, 77)
    assert got.dtype == want.dtype and (got == want).all()
