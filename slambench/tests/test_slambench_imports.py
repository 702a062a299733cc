"""The import check: nothing the benchmark runs loads ``jax``, ``jaxlib``,
``flax`` or ``msst_tpu``, and the reference and the yardstick load nothing
of ``msst_torch`` either, compared by whole top-level module names."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SB = ROOT / "slambench"
JAX = {"jax", "jaxlib", "flax", "msst_tpu"}
# the yardstick: the reference and what feeds and judges it
YARDSTICK = ["ref", "kernel_work.py", "sim.py", "drive.py", "stats.py",
             "compare.py", "spans.py"]


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def _sources(paths):
    for p in paths:
        p = SB / p
        yield from (sorted(p.rglob("*.py")) if p.is_dir() else [p])


def test_no_source_imports_jax():
    files = [p for p in SB.rglob("*.py") if "tests" not in p.parts]
    assert files
    for f in files:
        assert not _imports(f) & JAX, f


def test_the_yardstick_imports_nothing_of_the_program():
    for f in _sources(YARDSTICK):
        assert "msst_torch" not in _imports(f), f


def _loaded_after(code: str) -> set:
    prog = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    loaded = _loaded_after(f"""
import time, torch
torch.set_num_threads(2)
from pathlib import Path
from slambench.tests.tiny import make_root
from slambench.cell import load_cell, load_json, run_cell
from slambench.run import forbidden_modules
root = make_root(Path({str(tmp_path)!r}), cells=("live",))
cell = load_cell(root, load_json(root / "BENCHMARK.json"), "tiny-live")
res = run_cell(cell, 3, 0.6, False, torch.device("cpu"), time.perf_counter())
assert res["correct"], res
assert not forbidden_modules()
""")
    assert "msst_torch" in loaded and not loaded & JAX


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    from slambench.tests.tiny import DRIVE, SENSOR, tiny_params

    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"sensor": SENSOR, "drive": DRIVE,
                               "params": tiny_params()}))
    loaded = _loaded_after(f"""
import json, torch
torch.set_num_threads(2)
import slambench.ref.models.liosam, slambench.kernel_work, slambench.spans
from slambench import compare
from slambench.drive import Drive
cell = {{"config": json.load(open({str(cfg)!r})),
         "traffic": {{"window": 1, "loop_closure": False, "boot_scans": 4,
                     "compare_scans": 2}}}}
drive = Drive(cell["config"], 6, 9, points=True, grids=False, workers=1)
poses, snap = compare.reference_run(cell, drive, 2, torch.device("cpu"))
assert poses.shape == (2, 4, 4)
""")
    assert not loaded & (JAX | {"msst_torch"})


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from slambench.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "msst_tpu_extra", sys)
    assert forbidden_modules() == ["jax.numpy"]


def test_run_exits_without_a_result_in_a_bare_directory(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(SB, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run(
        [sys.executable, "-m", "slambench.run", "--workload", "vlp16-live",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.card
def test_run_on_the_card_loads_no_jax(card):
    out = subprocess.run(
        [sys.executable, "-m", "slambench.run", "--workload", "vlp16-live",
         "--seed", "5", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
