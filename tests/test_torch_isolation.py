"""The port stands alone: no module of src/repro_torch/ (and no line of
chip_smoke.py, of the port's examples, examples/*_torch.py, of the
scripts tools/flash_fp32_timing.py, tools/cohort_mesh_check.py and
tools/dryrun_peak.py, or of tests/test_torch_small_mesh.py,
tests/test_torch_padded_split.py and tests/test_torch_coverage.py, which
run on a host without JAX)
imports jax or the JAX package, and importing the CLI
leaves jax out of sys.modules."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "flash_fp32_timing.py",
    ROOT / "tools" / "cohort_mesh_check.py", ROOT / "tools" / "dryrun_peak.py",
    ROOT / "tests" / "test_torch_small_mesh.py",
    ROOT / "tests" / "test_torch_padded_split.py",
    ROOT / "tests" / "test_torch_coverage.py"] + [
    ROOT / "examples" / f"{name}_torch.py" for name in (
        "quickstart", "scheme_comparison", "fl_pretrain_lm",
        "serve_decode")]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_roots(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
            f"{path.relative_to(ROOT)} imports {mod}"


@pytest.mark.parametrize("rel", ["launch/mesh.py", "sharding/rules.py",
                                 "launch/specs.py", "launch/roofline.py",
                                 "launch/dryrun.py", "sharding/constrain.py"])
def test_cohort_mesh_modules_are_checked(rel):
    """The mesh and rules modules, and the dry run's, which mirror JAX
    modules, are among the files checked above."""
    assert ROOT / "src" / "repro_torch" / rel in FILES


def test_importing_dryrun_starts_no_process_group_and_loads_no_jax():
    """The production mesh is a function: importing the dry run (and the
    roofline, specs and constrain modules) leaves torch.distributed
    uninitialised, as importing JAX's leaves device state untouched."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    code = ("import sys, torch.distributed as dist\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
            "import repro_torch.launch.specs, repro_torch.sharding.constrain\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')]\n"
            "print('LOADED', bad, dist.is_initialized())\n"
            "sys.exit(1 if bad or dist.is_initialized() else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_importing_cli_does_not_load_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    code = ("import sys, repro_torch.launch.train, repro_torch.interop\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')]\n"
            "print('LOADED', bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
