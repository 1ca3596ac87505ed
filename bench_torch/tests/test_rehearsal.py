"""The harness without a card: every cell resolves to its files, a new
configuration, mix or metric is found by its name alone, names keep to the
contract's characters, the window's arithmetic, and a run without a card
or without the program prints no result."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

import harness
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_resolves_to_its_files():
    b = bench()
    for w in b["workloads"]:
        cell = harness.resolve(b, w["name"])
        assert cell["config"]["name"] == w["config"]
        assert set(cell["traffic"]) >= {
            "narrowphase", "rebuild_interval", "steps_per_epoch",
            "hist_flush_interval", "debug_audits"}
        assert cell["limits"]["numbers"]
        assert {m["name"] for m in cell["end_to_end"]} >= {
            "particle_steps_per_s", "peak_mem_gib", "setup_s"}
        assert cell["per_layer"], w["name"]
        for entry, mod in cell["per_layer"]:
            assert (mod.LAYER, mod.UNIT, mod.MOVES) == (
                entry["layer"], entry["unit"], entry["moves"])
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_names_and_units_keep_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for w in b["workloads"]:
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in b["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["layer"], m["layer"])
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024


def test_a_new_config_mix_and_metric_are_found_by_name(small_bench):
    """Files and BENCHMARK.json entries alone add a cell and a metric: the
    harness runs it on the CPU and reports the new metric."""
    (small_bench / "configs" / "tpore-tiny.json").write_text(
        (small_bench / "configs" / "tpore-1m.json").read_text()
        .replace('"tpore-1m"', '"tpore-tiny"'))
    mix = json.loads((small_bench / "traffic" / "sweep.json").read_text())
    mix.update(steps_per_epoch=20)
    (small_bench / "traffic" / "sweep-short.json").write_text(
        json.dumps(mix))
    (small_bench / "limits" / "tpore-tiny.sweep-short.json").write_text(
        (small_bench / "limits" / "tpore-1m.sweep.json").read_text())
    (small_bench / "metrics" / "span_calls_per_step.py").write_text(
        'LAYER = "Per-particle stage (Workload.advance)"\n'
        'UNIT = "calls/step"\nMOVES = "particle_steps_per_s"\n'
        'SPANS = ("Workload.advance",)\nKERNELS = ()\n\n\n'
        'def read(t):\n'
        '    return t.calls.get("Workload.advance", 0) / t.steps\n')
    path = small_bench.parent / "BENCHMARK.json"
    b = json.loads(path.read_text())
    b["configs"].append(dict(b["configs"][0], name="tpore-tiny",
                             file="bench_torch/configs/tpore-tiny.json"))
    b["workloads"].append({"name": "tpore-tiny.sweep-short",
                           "config": "tpore-tiny", "traffic": "sweep-short",
                           "chips": 1, "why": "a test"})
    b["per_layer"].append({
        "name": "span_calls_per_step", "unit": "calls/step",
        "better": "lower", "source": "program_span",
        "layer": "Per-particle stage (Workload.advance)",
        "moves": "particle_steps_per_s",
        "workloads": ["tpore-tiny.sweep-short"]})
    path.write_text(json.dumps(b))
    out = harness.run_cell(
        ["--workload", "tpore-tiny.sweep-short", "--seed", "4000000003",
         "--seconds", "0.2", "--trace", "1"], time.perf_counter(),
        device="cpu", bench_dir=small_bench)
    assert out["correct"] is True
    assert out["metrics"]["span_calls_per_step"]["value"] == 1.0
    assert list(out)[-1] == "checked"


def test_a_new_kind_is_found_by_name(small_bench):
    """A kind of workload is its two files, ``programs/<kind>.py`` and
    ``reference/<kind>.py``: a copy of the cube's under another name runs
    and is compared with no edit of a file that is there."""
    for part in ("programs", "reference"):
        shutil.copy(small_bench / part / "cube.py",
                    small_bench / part / "box_copy.py")
    cfg = json.loads((small_bench / "configs" / "cube.json").read_text())
    cfg.update(name="box", workload="box_copy")
    (small_bench / "configs" / "box.json").write_text(json.dumps(cfg))
    (small_bench / "limits" / "box.allpairs.json").write_text(
        (small_bench / "limits" / "cube.allpairs.json").read_text())
    path = small_bench.parent / "BENCHMARK.json"
    b = json.loads(path.read_text())
    b["configs"].append(dict(b["configs"][-1], name="box",
                             file="bench_torch/configs/box.json"))
    b["workloads"].append({"name": "box.allpairs", "config": "box",
                           "traffic": "allpairs", "chips": 1,
                           "why": "a test"})
    path.write_text(json.dumps(b))
    out = harness.run_cell(
        ["--workload", "box.allpairs", "--seed", "4000000007",
         "--seconds", "0.1", "--trace", "0"], time.perf_counter(),
        device="cpu", bench_dir=small_bench)
    assert out["correct"] is True
    assert sys.modules["reference.box_copy"].__file__ == str(
        small_bench / "reference" / "box_copy.py")


def test_window_rate_on_a_fake_clock():
    ticks = iter([10.0, 10.4, 10.9, 11.3, 99.0])
    steps, seconds = harness.measure_window(lambda: 100, 1.0,
                                            clock=lambda: next(ticks))
    # Whole epochs until a second has passed: three epochs, 1.3 s.
    assert steps == 300 and seconds == pytest.approx(1.3)
    n = 999_999
    assert n * steps / seconds == pytest.approx(999_999 * 300 / 1.3)


def _run(cwd, args):
    # No card is visible, on a host with one or without.
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "bench_torch/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


ARGS = ["--workload", "tpore-1m.pairs", "--seed", "4294967311",
        "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    got = _run(ROOT, ARGS)
    assert got.returncode != 0 and got.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    got = _run(tmp_path, ARGS)
    assert got.returncode != 0 and got.stdout == ""


def test_a_run_reads_nothing_of_the_jax_package(small_bench):
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(small_bench)!r}]\n"
        "import harness\n"
        "from pathlib import Path\n"
        "out = harness.run_cell(['--workload', 'cube.allpairs', '--seed',"
        " '7', '--seconds', '0.1', '--trace', '0'], time.perf_counter(),"
        f" device='cpu', bench_dir=Path({str(small_bench)!r}))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] in ('argon_monte_carlo_tpu', 'bench')]\n"
        "print(json.dumps({'bad': bad, 'correct': out['correct']}))\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=small_bench.parent)
    res = json.loads(got.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "correct": True}
