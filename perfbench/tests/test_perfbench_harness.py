"""The harness finds cells, configurations and metrics by name; it needs a
card and the checkout's program; it loads nothing of JAX."""
import json
import subprocess
import sys
import textwrap

from perfbench.common import harness
from perfbench.tests import smoke


def test_benchmark_json_and_the_files_agree():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for entry in bench["workloads"]:
        cell = harness.load_cell(bench, entry["name"])
        assert cell.workload["why"] == entry["why"]
        assert cell.config["name"] == entry["config"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for metric in bench["per_layer"]:
        harness.load_reader(metric)
        assert metric["moves"] in [m["name"] for m in bench["end_to_end"]]


def test_a_new_cell_and_a_new_metric_need_new_files_only(smoke_base,
                                                         tmp_path):
    base = smoke.make_base(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    w = json.loads((base / "workloads" / "caps-smoke.batch.json")
                   .read_text())
    w.update(name="caps-smoke.bigger", traffic="bigger")
    w["params"]["n_micro"] = 3
    (base / "workloads" / "caps-smoke.bigger.json").write_text(json.dumps(w))
    (base / "metrics" / "waves_seen.bigger.py").write_text(textwrap.dedent(
        '''
        UNIT = "waves"

        def read(run):
            return float(run.counters["waves"]) or None
        '''))
    bench["workloads"].append({"name": "caps-smoke.bigger",
                               "config": "caps-smoke", "traffic": "bigger",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("caps-smoke.bigger")
    bench["per_layer"].append({
        "name": "waves_seen.bigger", "unit": "waves", "better": "higher",
        "source": "program_counter", "layer": "test",
        "moves": "images_per_s", "workloads": ["caps-smoke.bigger"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    line, ctx, out = smoke.run_cell(base, "caps-smoke.bigger", seconds=0.5)
    assert line["correct"] and out.counters["images"] % 48 == 0
    assert set(line["metrics"]) == {"images_per_s", "setup_s"}
    line, _, _ = smoke.run_cell(base, "caps-smoke.bigger", seconds=0.5,
                                traced=True)
    assert line["metrics"]["waves_seen.bigger"]["unit"] == "waves"
    assert list(line)[-1] == "checks"


def run_py(args, cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_no_result_and_a_failing_exit():
    r = run_py(["--workload", "caps-mn1.batch", "--seed", "1",
                "--seconds", "1"], harness.ROOT)
    assert r.returncode != 0 and r.stdout == ""


def test_without_the_program_no_result_and_a_failing_exit(tmp_path):
    import shutil
    shutil.copytree(harness.BASE, tmp_path / "perfbench")
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    r = run_py(["--workload", "caps-mn1.batch", "--seed", "1",
                "--seconds", "1"], tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def test_a_run_loads_nothing_of_jax(smoke_base):
    code = textwrap.dedent(f'''
        import sys
        sys.path[:0] = [{str(harness.ROOT)!r}, {str(harness.ROOT / "src")!r}]
        from pathlib import Path
        from perfbench.tests import smoke
        from perfbench.common import harness
        for name in ("caps-smoke.batch", "caps-smoke.train"):
            smoke.run_cell(Path({str(smoke_base)!r}), name, seconds=0.3)
        import perfbench.run
        print(sorted({{m.split(".")[0] for m in sys.modules}}
                     & {{"jax", "jaxlib", "flax", "repro", "benchmarks"}}))
        print(harness.forbidden_modules())
        ''')
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split("\n")[-3:-1] == ["[]", "[]"]
