"""A cell, a configuration, a traffic mix and a metric are found by their
names alone: adding them means adding files and entries, no code."""
import json
import os
import shutil
import subprocess
import sys

from harness import core

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_new_cell_config_mix_and_metric_are_found_by_file_name(tmp_path):
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(bench_dir / "configs" / "medium.json"))
    cfg["generator"]["num_blocks"] = 5000
    (bench_dir / "configs" / "half.json").write_text(json.dumps(cfg))
    mix = json.load(open(bench_dir / "traffic" / "batch128.json"))
    mix["scenarios"] = 64
    (bench_dir / "traffic" / "batch64.json").write_text(json.dumps(mix))
    (bench_dir / "workloads" / "half.batch64.json").write_text(
        json.dumps({"limits": {"simplex_err": 1e-4}}))
    (bench_dir / "metrics" / "answered.batch.py").write_text(
        "def read(run):\n    return float(sum(r['ok'] for r in run['requests']))\n")
    bench["configs"].append({"name": "half", "source": "x", "file": "perfbench/configs/half.json",
                             "reduced": ["num_blocks"], "why": "test"})
    bench["workloads"].append({"name": "half.batch64", "config": "half", "traffic": "batch64",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("half.batch64")
    bench["per_layer"].append({"name": "answered.batch", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "serving", "moves": "iters_per_s",
                               "workloads": ["half.batch64"]})
    cell = core.Cell("half.batch64", benchmark=bench, bench_dir=str(bench_dir))
    assert cell.config["generator"]["num_blocks"] == 5000
    assert cell.traffic["scenarios"] == 64
    assert [m["name"] for m in cell.end_to_end] == ["iters_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["answered.batch"]
    reader = core.load_reader("metrics", "answered.batch", str(bench_dir))
    assert reader.read({"requests": [{"ok": True}, {"ok": False}]}) == 1.0


def test_every_cell_of_the_benchmark_resolves():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = core.Cell(w["name"])
        assert cell.end_to_end and cell.per_layer and cell.limits
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        for m in cell.end_to_end + cell.per_layer:
            assert callable(core.load_reader("metrics", m["name"]).read)


def test_a_run_loads_nothing_forbidden():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from harness import core, check, drive, instances, trace\n"
            "import reference.pgd, reference.al, bsls_tpu_torch\n"
            "for n in ('iters_per_s', 'request_p95_s', 'step_roofline.batch'):\n"
            "    core.load_reader('metrics', n)\n"
            "print(core.forbidden_modules())\n") % (BENCH, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
