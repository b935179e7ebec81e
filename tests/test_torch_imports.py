"""The port stands alone: no module under src/repro_torch/ (and not
chip_smoke.py) imports jax or anything of the JAX package `repro`."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(ln, n) for ln, n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path}: imports {bad}"


def test_import_every_module_without_jax():
    """With jax made unimportable, every port module imports, and no
    module of the JAX package gets loaded on the way."""
    code = f"""
import pkgutil, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(ROOT / "src")!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    __import__(name)
# the numpy-only modules too (the transport keeps its own copies)
assert {{"repro_torch.transport." + m for m in ("errors", "framing", "rpc",
        "procs", "worker", "remote", "replica")}} <= set(names), names
# the training path (the data pipeline is numpy-only: the port's copy)
assert {{"repro_torch.training." + m for m in ("optimizer", "compression",
        "train_loop", "checkpoint", "fault_tolerance", "trees")}} | {{
        "repro_torch.data.pipeline", "repro_torch.launch.train"}} <= \
    set(names), names
# the sharding rules and the dry run
assert {{"repro_torch.sharding", "repro_torch.sharding.rules"}} | {{
        "repro_torch.launch." + m for m in ("mesh", "analytic", "costs",
        "dryrun", "report", "roofline", "hillclimb")}} <= set(names), names
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and (m == "repro" or m.startswith(("repro.", "jax")))]
assert not loaded, loaded
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20       # every module was seen
