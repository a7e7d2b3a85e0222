"""Nothing the run loads has the top-level name jax, jaxlib, flax or
visdial_tpu (whole names: visdial_tpu_torch is the port), in the run's
process and in a rank; the reference loads nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from vdbench import run
from vdbench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "vdbench")


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "visdial_tpu_torch_fake", object())
    assert "visdial_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "visdial_tpu.config", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax", "visdial_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax_and_reference_no_port():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & set(run.FORBIDDEN), path
            if os.sep + "reference" + os.sep in path:
                assert "visdial_tpu_torch" not in tops, path


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    return tiny.write(str(tmp_path_factory.mktemp("tiny")), ranks=2)


def _planted(tmp_path, only_ranks: bool) -> dict:
    """An environment whose sitecustomize puts a module named visdial_tpu
    in sys.modules (in every process, or in the ranks alone)."""
    site = tmp_path / "site"
    site.mkdir()
    cond = "os.environ.get('RANK') is not None" if only_ranks else "True"
    (site / "sitecustomize.py").write_text(
        "import os, sys, types\n"
        f"if {cond}:\n"
        "    sys.modules['visdial_tpu'] = types.ModuleType('visdial_tpu')\n")
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), ROOT]))


@pytest.mark.parametrize("cell,only_ranks", [
    ("tiny-gen.train", False), ("tiny-gen.train-dp2", True)])
def test_a_loaded_jax_package_fails_the_run(spec_path, tmp_path, cell, only_ranks):
    r = subprocess.run(
        [sys.executable, "-m", "vdbench.run", "--workload", cell, "--seed",
         "9", "--seconds", "0.5", "--trace", "0", "--spec", spec_path,
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=_planted(tmp_path, only_ranks))
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "visdial_tpu" in r.stderr
