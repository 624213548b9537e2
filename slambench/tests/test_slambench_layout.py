"""The benchmark's files: BENCHMARK.json against the contract, a metric
reader for every metric, discovery of new files by name, the check that
no JAX or reference module is loaded, and a run without a card.

    python -m pytest slambench/tests -q
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys


HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from slambench import harness, trace  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["slambench"] and b["command"][1] == "slambench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    n = 24   # the most cells a later PR may add: the check must still fit
    assert (2 + 14 * n) * (b["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    names = [c["name"] for c in b["configs"]]
    used = {w["config"] for w in b["workloads"]}
    assert set(names) == used and len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("slambench/")
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    assert len(json.dumps(b)) < 64 * 1024


def test_every_metric_has_a_reader():
    b = bench()
    for m in b["end_to_end"]:
        assert callable(harness.metric_module("end_to_end", m["name"]).read)
    for m in b["per_layer"]:
        mod = harness.metric_module("layers", m["name"])
        assert callable(mod.read)
        for target in getattr(mod, "SPANS", {}).values():
            owner, attr = trace.resolve(target)
            assert callable(getattr(owner, attr))
        for target, keep in getattr(mod, "CALLS", {}).values():
            owner, attr = trace.resolve(target)
            assert callable(getattr(owner, attr)) and callable(keep)


def test_every_cell_loads_its_files():
    for w in bench()["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["agents"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer


def test_new_config_traffic_and_layer_files_are_found_by_name(
        tmp_path, monkeypatch):
    """A later change adds a deployment, a mix and a per-layer metric as
    files plus entries in BENCHMARK.json, and edits no file."""
    root = tmp_path / "checkout"
    (root / "slambench" / "configs").mkdir(parents=True)
    (root / "slambench" / "traffic").mkdir()
    cfg = harness.load_json(os.path.join(ROOT, "slambench", "configs",
                                         "euroc_mono.json"))
    cfg["name"] = "new_rig"
    (root / "slambench" / "configs" / "new_rig.json").write_text(
        json.dumps(cfg))
    (root / "slambench" / "traffic" / "pair2.json").write_text(json.dumps(
        {"expect": {}, "warmup_frames": 2,
         "agents": [{"arc": [0, 30], "frames": 4, "room": 0}] * 2}))
    layers = tmp_path / "more_layers"
    layers.mkdir()
    (layers / "new_layer_ms.py").write_text(
        "SPANS = {'pgo': 'mam3slam_tpu_torch.solvers.pgo:"
        "optimize_essential_graph'}\n"
        "def read(trace, run):\n    return 1.5\n")
    import slambench.layers

    monkeypatch.setattr(slambench.layers, "__path__",
                        list(slambench.layers.__path__) + [str(layers)])
    b = bench()
    b["configs"].append({"name": "new_rig", "source": "x", "reduced": [],
                         "file": "slambench/configs/new_rig.json",
                         "why": "x"})
    b["workloads"].append({"name": "new_rig.pair2", "config": "new_rig",
                           "traffic": "pair2", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "new_layer_ms", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "pgo", "moves": "fps",
                           "workloads": ["new_rig.pair2"]})
    cell = harness.load_cell("new_rig.pair2", b, str(root))
    assert len(cell.traffic["agents"]) == 2
    assert [m["name"] for m in cell.per_layer] == ["new_layer_ms"]
    mod = harness.metric_module("layers", "new_layer_ms")
    assert mod.read(None, None) == 1.5
    rec = trace.Recorder(device=__import__("torch").device("cpu"))
    for name, target in mod.SPANS.items():
        rec.span(name, target)
    rec.remove()


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    base = harness.forbidden_modules()
    assert base == []
    for name, flagged in (("mam3slam_tpu_torch.fake", False),
                          ("mam3slam_tpu", True),
                          ("mam3slam_tpu.ops.fake", True),
                          ("jax", True), ("jaxlib.fake", True),
                          ("flax.fake", True), ("jaxtyping_fake", False),
                          ("jax_fake.sub", False)):
        monkeypatch.setitem(sys.modules, name, object())
        top = name.split(".")[0]
        assert (top in harness.forbidden_modules()) == flagged, name
        monkeypatch.delitem(sys.modules, name)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_and_the_references_nothing_of_the_program():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "slambench")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & {"jax", "jaxlib", "flax", "mam3slam_tpu"}, path
            if os.sep + "ref" + os.sep in path:
                assert "mam3slam_tpu_torch" not in tops, path


def test_run_without_a_card_prints_no_result(tmp_path):
    """Here torch has no CUDA device: the run exits non-zero and prints no
    result, from the checkout and from a directory that holds only
    BENCHMARK.json and the benchmark's folder."""
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    shutil.copytree(os.path.join(ROOT, "slambench"), bare / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, str(bare)):
        out = subprocess.run(
            [sys.executable, "slambench/run.py", "--workload",
             "kb8_fixture.loop1", "--seed", str(2**31 + 7), "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=120)
        assert out.returncode != 0
        assert "{" not in out.stdout
