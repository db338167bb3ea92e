"""Build and load the package's CUDA kernels.

``csrc/*.cu`` is compiled by nvcc, at first use, for sm_90a (Hopper): one
nvcc process per source, all started together, then one link into a shared
library with a plain C interface, loaded with ctypes. The
library lands in ``build/torch_kernels/<hash of sources and flags>/``
beside the package, so a fresh checkout builds its kernels itself and a
changed source never loads a stale library. No PyTorch headers are
compiled, which keeps the build to seconds.

A missing nvcc or a failed build raises with the compiler's output; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
#: The compiler's output from the build this process ran (ptxas register and
#: spill counts included); empty when the library was already built.
build_log = ""


def _nvcc_candidates() -> List[str]:
    """Where nvcc may be: $CUDA_HOME/bin, $PATH, the toolkit's default prefix."""
    out = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        out.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        out.append(found)
    out.append("/usr/local/cuda/bin/nvcc")
    return out


def find_nvcc() -> str:
    for path in _nvcc_candidates():
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and the CUDA "
        "toolkit's default prefix); the CUDA kernels cannot be built"
    )


def sources() -> List[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(srcs: List[pathlib.Path]) -> str:
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> str:
    """Run the commands side by side; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile(nvcc: str, srcs: List[pathlib.Path], target: pathlib.Path) -> str:
    target.parent.mkdir(parents=True, exist_ok=True)
    # Build in a private directory, then rename the library into place: a
    # process building at the same time never loads a half-written one.
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in srcs]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                        for src, obj in zip(srcs, objs)])
        lib = os.path.join(tmp, target.name)
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", lib, *objs]])
        os.replace(lib, target)
    return log


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.zresolve_launch.argtypes = [p, p, p, i, p, i, p, p, p]
    lib.zresolve_launch.restype = i
    lib.scatter_min_u32_launch.argtypes = [p, p, i, p, i, p]
    lib.scatter_min_u32_launch.restype = i
    lib.fuse_prep_launch.argtypes = [p, p, p, i, i, i, i, i, p, p, p]
    lib.fuse_prep_launch.restype = i
    lib.color3x3_launch.argtypes = [p, p, p, p, p, i, i, p, i, i, i, i, p]
    lib.color3x3_launch.restype = i
    lib.morph_launch.argtypes = [p, p, i, i, i, p]
    lib.morph_launch.restype = i
    lib.segsum_scratch_ints.argtypes = [i, i]
    lib.segsum_scratch_ints.restype = ctypes.c_longlong
    lib.segsum_launch.argtypes = [p, p, i, i, i, p, p, p, p]
    lib.segsum_launch.restype = i
    lib.segsum_runs_launch.argtypes = [p, p, p, i, i, i, p, p, p]
    lib.segsum_runs_launch.restype = i
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first call in this checkout."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        target = BUILD_ROOT / _digest(srcs) / "libpdf_torch_kernels.so"
        if not target.exists():
            build_log = _compile(find_nvcc(), srcs, target)
        _lib = _bind(ctypes.CDLL(str(target)))
        return _lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
