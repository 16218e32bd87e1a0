"""The repo's lint gate (``scripts/lint.py``: syntax, unused imports, tabs,
trailing whitespace) held over the PyTorch port: every module of
``sliceslice_tpu_torch`` and ``chip_smoke.py``, one case per file.  The lint
script's own target list covers the JAX package; it is imported by path and
not edited."""

import importlib.util
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted(p.relative_to(REPO).as_posix()
               for p in [*(REPO / "sliceslice_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
               if "__pycache__" not in p.parts)


@pytest.fixture(scope="module")
def check_file():
    spec = importlib.util.spec_from_file_location("repo_lint", REPO / "scripts" / "lint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.check_file


def test_the_port_has_files_to_lint():
    assert "chip_smoke.py" in FILES and "sliceslice_tpu_torch/ops/pairwise.py" in FILES
    assert len(FILES) > 25


@pytest.mark.parametrize("path", FILES)
def test_port_file_lints_clean(check_file, path):
    assert check_file(REPO / path) == []
