"""The port covers the JAX package's public surface.

An AST scan of every module of `src/repro/` (apart from the three that
are not ported: `analysis/`, which scans both packages already,
`core/embed_init.py`, a deprecated re-export shim, and
`models/unrollctl.py`, XLA cost-probe unrolling) collects each public
function, class and method; each must exist under the same name in the
port's module of the same path (a method in the class or in a base
class of that module), or be one of the renames by design listed here,
whose counterpart must exist in turn."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
NOT_PORTED = ("analysis/", "core/embed_init.py", "models/unrollctl.py")

#: (reference module, name) -> (port module, counterpart), or None where
#: the reference's name has no counterpart by design, with the reason
RENAMES = {
    # the backends are named by what runs them: XLA -> torch, Pallas ->
    # the CUDA kernels ("torch" / "cuda" in the registry)
    ("encoder/backends.py", "XlaBackend"):
        ("encoder/backends.py", "TorchBackend"),
    ("encoder/backends.py", "PallasBackend"):
        ("encoder/backends.py", "CudaBackend"),
    # Pallas's interpret mode: a CUDA kernel has none (its plain version
    # runs on CPU tensors instead)
    ("kernels/gee_scatter.py", "resolve_interpret"): None,
    ("kernels/gee_scatter.py", "interpret_mode_name"): None,
    ("kernels/gee_scatter.py", "gee_scatter_pallas"):
        ("kernels/gee_scatter.py", "gee_scatter"),
    ("kernels/ops.py", "gee_pallas"): ("kernels/ops.py", "gee_cuda"),
    ("kernels/ops.py", "flash_attention"):
        ("kernels/flash_attention.py", "flash_attention"),
    # lax.scan over layers -> a Python loop over the stacked params
    ("models/transformer.py", "maybe_scan"):
        ("models/transformer.py", "scan_stack"),
}


def _ref_modules():
    return sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py")
                  if not p.relative_to(REF).as_posix().startswith(
                      NOT_PORTED))


def _public(path: Path) -> dict:
    """{public top-level function or class: its public methods (None for
    a function)}."""
    out = {}
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                not n.name.startswith("_"):
            out[n.name] = None
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            out[n.name] = {m.name for m in n.body if isinstance(
                m, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not m.name.startswith("_")}
    return out


def _defined(path: Path):
    """(names bound anywhere in the module, {class: the names its body
    and its same-module bases bind})."""
    tree = ast.parse(path.read_text())
    names, bodies, bases = set(), {}, {}
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            names.add(n.name)
        if isinstance(n, ast.ClassDef):
            bodies[n.name] = {m.name for m in n.body if isinstance(
                m, (ast.FunctionDef, ast.AsyncFunctionDef))} | {
                t.id for m in n.body if isinstance(m, ast.Assign)
                for t in m.targets if isinstance(t, ast.Name)}
            bases[n.name] = [b.id for b in n.bases if isinstance(b, ast.Name)]
        if isinstance(n, ast.Assign):
            names.update(t.id for t in n.targets if isinstance(t, ast.Name))
        if isinstance(n, (ast.Import, ast.ImportFrom)):
            names.update(a.asname or a.name.split(".")[0] for a in n.names)

    def members(cls, seen=()):
        out = set(bodies.get(cls, ()))
        for b in bases.get(cls, ()):
            if b in bodies and b not in seen:
                out |= members(b, seen + (cls,))
        return out

    return names, {c: members(c) for c in bodies}


def _gaps(module: str):
    port = PORT / module
    if not port.exists():
        return [(module, "<module>")]
    names, classes = _defined(port)
    gaps = []
    for name, methods in _public(REF / module).items():
        if name not in names:
            gaps.append((module, name))
        elif methods:
            gaps.extend((module, f"{name}.{m}")
                        for m in sorted(methods - classes.get(name, set())))
    return gaps


@pytest.mark.parametrize("module", _ref_modules())
def test_module_surface_is_ported(module):
    missing = [g for g in _gaps(module) if g not in RENAMES]
    assert not missing, f"no counterpart in src/repro_torch: {missing}"


@pytest.mark.parametrize("key", sorted(RENAMES))
def test_renames_are_needed_and_exist(key):
    """Each rename is a real gap by name, and its counterpart exists."""
    module, name = key
    assert key in _gaps(module)
    target = RENAMES[key]
    if target is not None:
        names, _ = _defined(PORT / target[0])
        assert target[1] in names, target


def test_every_reference_module_has_a_port_module():
    missing = [m for m in _ref_modules() if not (PORT / m).exists()]
    assert not missing, missing
