"""The manifest keeps the benchmark's rules, and a cell, configuration,
traffic mix or metric added as files under new names is found with no other
file edited."""

import json
import shutil
from pathlib import Path

import pytest

from perfbench.harness import manifest as mf

ROOT = Path(__file__).resolve().parent.parent


def test_the_manifest_keeps_the_rules():
    man = mf.load(ROOT)
    assert mf.problems(man, ROOT) == []
    for m in man["end_to_end"] + man["per_layer"]:
        assert mf.NAME.match(m["name"]) and mf.UNIT.match(m["unit"])
    for w in man["workloads"]:
        assert all(mf.NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert mf.traffic(ROOT, w["traffic"])["kind"] == "train"
        assert set(mf.limits(ROOT, w["name"])) == {"loss_gap", "grad_gap", "delta_gap"}
    for path in (ROOT / mf.BENCH).rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" not in rel and ".pytest_cache" not in rel:
            assert mf.PATH.match(rel), rel


def _copy(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / mf.BENCH, root / mf.BENCH,
                    ignore=shutil.ignore_patterns("__pycache__"))  # fmt: skip
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_files_added_under_new_names_are_found(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / mf.BENCH).rglob("*") if p.is_file()}
    bench = root / mf.BENCH
    conf = json.loads((bench / "configs" / "qwen3-4b.json").read_text()) | {"num_hidden_layers": 4}
    (bench / "configs" / "qwen3-4b-l4.json").write_text(json.dumps(conf))
    traffic = mf.traffic(root, "train.16x512") | {"batch": 8, "seq_len": 1024}
    (bench / "workloads" / "train.8x1024.json").write_text(json.dumps(traffic))
    limits = mf.limits(root, "qwen3-4b.train.16x512")
    (bench / "limits" / "qwen3-4b-l4.train.8x1024.json").write_text(json.dumps(limits))
    (bench / "metrics" / "steps_done.py").write_text("def read(run):\n    return run.steps\n")
    man = mf.load(root)
    man["configs"].append({"name": "qwen3-4b-l4", "source": "https://huggingface.co/Qwen/Qwen3-4B",
                           "file": "perfbench/configs/qwen3-4b-l4.json",
                           "reduced": ["num_hidden_layers"], "why": "a test"})  # fmt: skip
    man["workloads"].append({"name": "qwen3-4b-l4.train.8x1024", "config": "qwen3-4b-l4",
                             "traffic": "train.8x1024", "chips": 1, "why": "a test"})  # fmt: skip
    man["per_layer"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "a test", "moves": "setup_s",
                             "workloads": ["qwen3-4b-l4.train.8x1024"]})  # fmt: skip
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    assert mf.problems(man, root) == []
    cell = mf.cell(man, "qwen3-4b-l4.train.8x1024")
    assert mf.config(root, man, cell["config"])["num_hidden_layers"] == 4
    assert mf.traffic(root, cell["traffic"])["seq_len"] == 1024
    assert mf.limits(root, cell["name"]) == limits
    assert mf.kind_module(root, mf.traffic(root, cell["traffic"])["kind"]).CHECK_STEPS == 3
    names = [m["name"] for m in mf.metrics_of(man, cell["name"], traced=True)]
    assert names == ["steps_done"]
    assert mf.reader(root, "steps_done")(type("Run", (), {"steps": 7})) == 7
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed


@pytest.mark.parametrize(
    "edit, complaint",
    [
        (lambda m: m["end_to_end"][0].update(unit="tokens per s"), "unit"),
        (lambda m: m["end_to_end"][0].update(bound=0.3), "bound"),
        (lambda m: m["end_to_end"].pop(), "setup_s"),
        (lambda m: m["paths"].append("../elsewhere"), "path"),
        (lambda m: m["workloads"][0].update(chips=2), "chips"),
        (lambda m: m["workloads"].append(dict(m["workloads"][0])), "twice"),
        (lambda m: m["per_layer"][0].update(moves="nothing"), "moves"),
        (lambda m: m["per_layer"][0].update(name="no_reader"), "missing"),
        (lambda m: m["configs"][0].update(name="a name"), "not a name"),
        (lambda m: m.update(extra=1), "top-level"),
    ],
)
def test_a_manifest_that_breaks_the_rules_is_refused(edit, complaint):
    man = mf.load(ROOT)
    edit(man)
    assert any(complaint in p for p in mf.problems(man, ROOT))
