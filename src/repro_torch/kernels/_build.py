"""Build and load the CUDA kernels: `nvcc` into a shared library with a
plain C interface, loaded with `ctypes`.

Each source ``csrc/<name>.cu`` becomes ``build/repro_torch/<name>-
<hash>.so`` under the repository root (the hash covers every source and
header in ``csrc/``, so an edited source is never served a stale
library).  The build runs at first use, in the process that needs it;
`build_all` starts one `nvcc` per source at once and waits for all.
Nothing is built or imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: `nvcc -Xptxas -v` output per source (registers, shared memory,
#: spills), kept for whoever wants to print it
ptxas_log: Dict[str, str] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "CUDA_HOME/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    return BUILD_DIR / f"{name}-{_digest()}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; returns
    (process, temporary path, final path) or None if already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    ptxas_log[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> List[str]:
    """Build every source, one nvcc each, all started together."""
    with _lock:
        names = sources()
        started = {n: _start(n) for n in names}
        errors = []
        for n, st in started.items():
            if st is None:
                continue
            try:
                _finish(n, st)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            st = _start(name)
            if st is not None:
                _finish(name, st)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def function(name: str, symbol: str, argtypes) -> "ctypes._CFuncPtr":
    """A launch function of ``csrc/<name>.cu`` with its C signature set
    (every pointer and the stream as c_void_p, or ctypes would pass a
    32-bit int); it returns the launch's cudaError_t."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        lib = load(name)
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def require(what: str, t, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` (a kernel reads raw pointers: nothing may be converted
    silently)."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def refuse_grad(name: str, *tensors) -> None:
    """Raise TypeError if an input requires grad: the kernel has no
    backward, and its output (written through a raw pointer) would be
    cut from the autograd graph without a word."""
    if any(t.requires_grad for t in tensors):
        raise TypeError(f"{name} has no gradient: its CUDA inputs must not "
                        "require grad (detach them first)")


def stream_of(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


#: launches per kernel wrapper: each wrapper adds one where it launches
#: its kernel, and nowhere else (its plain version does not count)
launches: Dict[str, int] = {"gee_scatter": 0, "topk_fused": 0,
                            "gee_delta_renorm": 0, "flash_attention": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
