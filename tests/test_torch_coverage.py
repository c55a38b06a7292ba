"""The port's surface holds to the reference's: every module of
src/repro/ has its counterpart in src/repro_torch/, every public name of
a JAX module (top-level function, class, module constant, public method
of a public class, and, in a package's ``__init__.py``, each re-exported
name) exists in the counterpart module, and every ``--flag`` of a JAX CLI
parser is taken by the counterpart parser.

Neither package is imported: the sources are read with ``ast``, as
tests/test_torch_isolation.py reads them, so this file runs on a host
without JAX too.  A name the port changed for the card is listed in
RENAMED, a name that reads a JAX-only artefact in NO_COUNTERPART, each
with its reason; a stale entry of either map fails.

  python -m pytest -q tests/test_torch_coverage.py
"""
import ast
from pathlib import Path
from typing import Dict, Iterable, List, Set, Tuple

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "src" / "repro"
PORT_PKG = ROOT / "src" / "repro_torch"

# JAX module (dotted, under repro/) -> its counterpart under repro_torch/
MODULE_RENAMED = {"obs.jaxmon": "obs.torchmon"}

# "module:name" (a method as "module:Class.method") -> the port's name,
# for names the port changed for the card
RENAMED = {
    "obs.jaxmon:JaxStats": "TorchStats",
    "obs.jaxmon:jax_stats": "torch_stats",
    "obs:jax_stats": "torch_stats",
    "core.aggregation:make_flat_delta": "flat_delta",
    "core.aggregation:make_apply_delta": "apply_delta",
    "launch.mesh:HBM_PER_CHIP": "HBM_PER_CARD",
    "launch.mesh:ICI_BW": "NVLINK_BW",
    # each Pallas kernel became a hand-written CUDA kernel's wrapper
    "kernels.flash_attention:flash_attention": "flash_attention_cuda",
    "kernels.kmeans:lloyd_step": "lloyd_step_cuda",
    "kernels.kmeans:kmeans_assign": "kmeans_assign_cuda",
    # the library-convolution oracle: lax's in JAX, F.conv2d in the port
    "models.cnn:conv2d_lax": "conv2d_ref",
}

# "module:name" -> why the port has no such name
NO_COUNTERPART = {
    "launch.dryrun:collective_bytes":
        "parses XLA's HLO text; the port counts DTensor's collectives in "
        "its tally (launch/dryrun.py)",
    "launch.dryrun:RESULTS_DIR":
        "the port takes the directory as --results-dir",
}


# ----------------------------------------------------------------------
# reading a module's surface
# ----------------------------------------------------------------------

def _top_level(body: Iterable[ast.stmt]) -> Iterable[ast.stmt]:
    """Statements at a module's top level, through ``if`` and ``try``."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_level(node.body)
            yield from _top_level(node.orelse)
        elif isinstance(node, ast.Try):
            for part in (node.body, node.orelse, node.finalbody,
                         *(h.body for h in node.handlers)):
                yield from _top_level(part)
        else:
            yield node


def _targets(node: ast.stmt) -> List[str]:
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        targets = [node.target]
    else:
        return []
    out = []
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                out.append(n.id)
    return out


class Surface:
    """What one module's source defines: its public names (``public``),
    every name it binds (``bound``, imports included), its classes with
    their base names and members, and the ``--flags`` of its
    ``add_argument`` calls."""

    def __init__(self, source: str, is_package: bool = False):
        tree = ast.parse(source)
        self.public: Set[str] = set()
        self.bound: Set[str] = set()
        # class -> (base names, method names, field names)
        self.classes: Dict[str, Tuple[List[str], Set[str], Set[str]]] = {}
        for node in _top_level(tree.body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names = [node.name]
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names = []
                for a in node.names:
                    name = a.asname or a.name.split(".")[0]
                    self.bound.add(name)
                    if (is_package and isinstance(node, ast.ImportFrom)
                            and not name.startswith("_")):
                        self.public.add(name)
            else:
                names = _targets(node)
            for name in names:
                self.bound.add(name)
                if not name.startswith("_"):
                    self.public.add(name)
            if isinstance(node, ast.ClassDef):
                bases = [b.id for b in node.bases if isinstance(b, ast.Name)]
                methods = {s.name for s in node.body if isinstance(
                    s, (ast.FunctionDef, ast.AsyncFunctionDef))}
                fields = {t for s in node.body for t in _targets(s)}
                self.classes[node.name] = (bases, methods, fields)
        self.flags: Set[str] = set()
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_argument"):
                self.flags.update(
                    a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)
                    and a.value.startswith("--"))

    def public_methods(self, cls: str) -> Set[str]:
        return {m for m in self.classes[cls][1] if not m.startswith("_")}


def missing_names(jax: Surface, port: Surface, module: str) -> List[str]:
    """The "module:name" keys of ``jax``'s public names (and public
    methods of its public classes) that ``port`` lacks, after RENAMED
    and NO_COUNTERPART."""
    out = []
    for name in sorted(jax.public):
        key = f"{module}:{name}"
        if key in NO_COUNTERPART:
            continue
        port_name = RENAMED.get(key, name)
        if port_name not in port.bound:
            out.append(key)
            continue
        if name not in jax.classes:
            continue
        have = _class_members(port, port_name)
        for meth in sorted(jax.public_methods(name)):
            mkey = f"{module}:{name}.{meth}"
            if (mkey not in NO_COUNTERPART
                    and RENAMED.get(mkey, meth) not in have):
                out.append(mkey)
    return out


def _class_members(surface: Surface, cls: str) -> Set[str]:
    """Members of ``cls`` and of its bases in the same module."""
    if cls not in surface.classes:
        return set()
    bases, methods, fields = surface.classes[cls]
    out = methods | fields
    for base in bases:
        out |= _class_members(surface, base)
    return out


# ----------------------------------------------------------------------
# the two packages
# ----------------------------------------------------------------------

def _module_file(pkg: Path, dotted: str) -> Path:
    path = pkg.joinpath(*dotted.split(".")) if dotted else pkg
    return path / "__init__.py" if path.is_dir() else path.with_suffix(".py")


def _dotted(path: Path) -> str:
    """``path``'s module under its package, dotted: ``obs.jaxmon``, and
    ``obs`` for ``obs/__init__.py``."""
    rel = path.relative_to(JAX_PKG).with_suffix("")
    return ".".join(rel.parts[:-1] if rel.name == "__init__" else rel.parts)


JAX_MODULES = sorted(JAX_PKG.rglob("*.py"))
_CACHE: Dict[Path, Surface] = {}


def _surface(path: Path) -> Surface:
    if path not in _CACHE:
        _CACHE[path] = Surface(path.read_text(), path.name == "__init__.py")
    return _CACHE[path]


def _port_file(module: str) -> Path:
    """The port's file for the JAX module ``module`` (dotted)."""
    if module in MODULE_RENAMED:
        return PORT_PKG.joinpath(
            *MODULE_RENAMED[module].split(".")).with_suffix(".py")
    return _module_file(PORT_PKG, module)


def _ids(p: Path) -> str:
    return str(p.relative_to(JAX_PKG))


@pytest.mark.parametrize("path", JAX_MODULES, ids=_ids)
def test_every_module_has_its_counterpart(path):
    port = _port_file(_dotted(path))
    assert port.is_file(), (f"src/repro/{_ids(path)} has no counterpart "
                            f"{port.relative_to(ROOT)}")


@pytest.mark.parametrize("path", JAX_MODULES, ids=_ids)
def test_every_public_name_has_its_counterpart(path):
    port = _port_file(_dotted(path))
    if not port.is_file():
        pytest.fail(f"no counterpart module {port.relative_to(ROOT)}")
    missing = missing_names(_surface(path), _surface(port), _dotted(path))
    assert not missing, (f"{port.relative_to(ROOT)} lacks {missing} "
                         "(port them, or list them in RENAMED or "
                         "NO_COUNTERPART with a reason)")


CLI_MODULES = [p for p in JAX_MODULES if _surface(p).flags]


def test_the_cli_modules_are_found():
    assert {_dotted(p) for p in CLI_MODULES} >= {
        "launch.train", "launch.serve", "launch.dryrun", "launch.roofline"}


@pytest.mark.parametrize("path", CLI_MODULES, ids=_ids)
def test_every_cli_flag_has_its_counterpart(path):
    missing = sorted(_surface(path).flags
                     - _surface(_port_file(_dotted(path))).flags)
    assert not missing, (f"the port's {_dotted(path)} parser lacks "
                         f"{missing}")


def stale_entries(renamed: Dict[str, str],
                  no_counterpart: Dict[str, str]) -> List[str]:
    """Entries of the two maps that name no public JAX symbol, renames
    to a port name that does not exist or to the same name, and keys in
    both maps."""
    out = [f"{k}: in both maps" for k in sorted(set(renamed)
                                                & set(no_counterpart))]
    for key in sorted(set(renamed) | set(no_counterpart)):
        module, _, name = key.partition(":")
        cls, _, meth = name.partition(".")
        if name not in _names(_module_file(JAX_PKG, module), meth and cls):
            out.append(f"{key}: no such public JAX name")
        elif key in renamed:
            new = renamed[key]
            port_cls = renamed.get(f"{module}:{cls}", cls) if meth else ""
            want = f"{port_cls}.{new}" if meth else new
            if (want not in _names(_port_file(module), port_cls)
                    or new == (meth or name)):
                out.append(f"{key}: the port has no {new} to rename it to")
    return out


def _names(path: Path, cls: str = "") -> Set[str]:
    """A JAX module's public names, a port module's bound ones (the same
    for a package's re-exports), or, given ``cls``, "cls.member" for the
    class's public methods (JAX) or members (port); empty if no file."""
    if not path.is_file():
        return set()
    surface = _surface(path)
    if cls:
        members = (surface.public_methods(cls) if path.is_relative_to(JAX_PKG)
                   and cls in surface.classes
                   else _class_members(surface, cls))
        return {f"{cls}.{m}" for m in members}
    return surface.public if path.is_relative_to(JAX_PKG) else surface.bound


def test_no_stale_entries():
    assert stale_entries(RENAMED, NO_COUNTERPART) == []


def test_module_renames_are_live():
    for jax_mod, port_mod in MODULE_RENAMED.items():
        assert _module_file(JAX_PKG, jax_mod).is_file()
        assert _port_file(jax_mod).is_file()


# ----------------------------------------------------------------------
# the checker bites
# ----------------------------------------------------------------------

_JAX_SRC = '''
import jax
LIMIT = 4

def kept(x):
    return x

def dropped(x):
    return x

class Box:
    size: int
    def grow(self):
        pass
    def shrink(self):
        pass
    def _private(self):
        pass

def _helper():
    pass
'''

_PORT_SRC = '''
import torch
LIMIT = 4

def kept(x):
    return x

class Base:
    def grow(self):
        pass

class Box(Base):
    size: int
'''


def test_checker_reports_what_the_port_lacks():
    """A function and a method the port lacks are reported; an inherited
    method, a constant, a private name and the imports are not."""
    missing = missing_names(Surface(_JAX_SRC), Surface(_PORT_SRC), "toy")
    assert missing == ["toy:Box.shrink", "toy:dropped"]


def test_checker_reports_a_missing_reexport():
    jax = Surface("from repro.sim.runtime import CohortRuntime, make_runtime\n",
                  is_package=True)
    port = Surface("from repro_torch.sim.runtime import make_runtime\n",
                   is_package=True)
    assert missing_names(jax, port, "sim") == ["sim:CohortRuntime"]


def test_checker_reports_a_missing_flag():
    jax = Surface("p.add_argument('--rounds', type=int)\n"
                  "p.add_argument('-q', '--quiet')\n")
    port = Surface("p.add_argument('--rounds', type=int)\n")
    assert jax.flags - port.flags == {"--quiet"}


def test_checker_reports_stale_entries():
    assert stale_entries(
        {"optim.optimizers:sgd": "sgd_torch",
         "optim.optimizers:no_such_fn": "sgd",
         "launch.dryrun:collective_bytes": "collectives",
         "sim.runtime:SequentialRuntime.train_client": "train_one",
         "sim.runtime:SequentialRuntime.train_cohort_updates":
             "train_cohort",
         "sim.runtime:SequentialRuntime.no_such_method": "train_cohort"},
        {"launch.dryrun:collective_bytes": "HLO text"}) == [
        "launch.dryrun:collective_bytes: in both maps",
        "launch.dryrun:collective_bytes: the port has no collectives to "
        "rename it to",
        "optim.optimizers:no_such_fn: no such public JAX name",
        "optim.optimizers:sgd: the port has no sgd_torch to rename it to",
        "sim.runtime:SequentialRuntime.no_such_method: no such public JAX "
        "name",
        "sim.runtime:SequentialRuntime.train_client: the port has no "
        "train_one to rename it to"]
