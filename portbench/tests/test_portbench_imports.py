"""What the benchmark loads: no JAX and no JAX package in a run, nothing of
the program in the reference; and the command refuses to print a result
without a card or without the program."""

import ast
import os
import shutil
import subprocess
import sys

from portbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "sliceslice_tpu"}


def _python(code: str, cwd=spec.ROOT, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time\n"
        "from portbench.tests.conftest import run_tiny, CELLS\n"
        "for c in CELLS:\n"
        "    assert run_tiny(c, trace=True)[0]['correct']\n"
        "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))\n"
    )
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(out.stdout.split())
    assert "sliceslice_tpu_torch" in top and "torch" in top
    assert not top & FORBIDDEN


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sliceslice_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert not {"sliceslice_tpu_torch_x", "jaxtyping", "sliceslice_tpu"} & set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "sliceslice_tpu.ops", sys)
    assert "sliceslice_tpu" in run.forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    src = (spec.HERE / "reference.py").read_text()
    mods = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0] if node.level == 0 else ".")
    assert mods <= {"__future__", "typing", "numpy"}
    out = _python("import sys, portbench.reference\n"
                  "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    assert out.returncode == 0
    assert not set(out.stdout.split()) & (FORBIDDEN | {"sliceslice_tpu_torch", "torch"})


def test_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "i386-find", "--seed",
                          "3", "--seconds", "1", "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_with_only_the_benchmark_files(tmp_path):
    (tmp_path / "BENCHMARK.json").write_bytes((spec.ROOT / "BENCHMARK.json").read_bytes())
    for p in spec.load_benchmark()["paths"]:
        shutil.copytree(spec.ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "i386-find", "--seed",
                          "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "No module named 'sliceslice_tpu_torch'" in out.stderr
