"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` is compiled by hand for Hopper into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/lib<name>-<hash>.so \
         src/repro_torch/kernels/csrc/<name>.cu

The build runs at the first launch of any kernel, one nvcc per source,
all started together, into `build/torch_kernels/` at the repository
root. The library's name carries a hash of its source and flags, so an
edited source rebuilds and a stale library is never loaded. There is no
fallback: a machine without nvcc, or a source that does not compile,
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("embedding_bag", "embedding_bag_fused", "dot_interact",
           "sage_aggregate")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
# every exported C function: its argument types (all return int status)
SIGNATURES = {
    "embedding_bag": {
        "embedding_bag_fwd": (_P, _P, _P, _I64, _I64, _I64, _I64, _I32,
                              _I32, _I32, _I32, _I32, _I64, _I64, _I32,
                              _I64, _I32, _P),
        "embedding_bag_bwd": (_P, _P, _P, _I64, _I64, _I64, _I64, _I32,
                              _I32, _I32, _I32, _I32, _I64, _I64, _I64,
                              _I64, _I32, _P),
    },
    "embedding_bag_fused": {
        "embedding_bag_fused_fwd": (_P, _P, _P, _I64, _I64, _I64, _I64, _I32,
                                    _I32, _I32, _I32, _I32, _I32, _I64,
                                    _P),
    },
    "dot_interact": {
        "dot_interact_fwd": (_P, _P, _I64, _I32, _I32, _I32, _I32, _I32,
                             _I32, _I64, _P),
        "dot_interact_bwd": (_P, _P, _P, _I64, _I32, _I32, _I32, _I32,
                             _I32, _I32, _I32, _I64, _P),
    },
    "sage_aggregate": {
        "sage_widen_w": (_P, _P, _I64, _P),
        "sage_aggregate_fwd": (_P, _P, _P, _P, _I64, _I32, _I32, _I32,
                               _I32, _I32, _I32, _I32, _I32, _I32, _I32,
                               _P),
        "sage_dw_max_clusters": (_I32, _P),
        "sage_aggregate_bwd": (_P, _P, _P, _I64, _P, _P, _P, _I64, _I32,
                               _I32, _I32, _I32, _I32, _P),
    },
}


def build_dir() -> Path:
    """`build/torch_kernels/` at the repository root (git-ignored)."""
    return Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch are built "
            "from src/repro_torch/kernels/csrc at first use")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:12]}.so"


def build_command(name: str, out: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


class _Libraries:
    """The loaded kernel libraries of this process, built on first use."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._libs: Dict[str, ctypes.CDLL] = {}
        self.log: Dict[str, str] = {}      # nvcc output per built source

    def get(self, name: str) -> ctypes.CDLL:
        with self._lock:
            if not self._libs:
                self._build_all()
            return self._libs[name]

    def _build_all(self) -> None:
        build_dir().mkdir(parents=True, exist_ok=True)
        paths = {name: library_path(name) for name in SOURCES}
        procs = {}
        for name, path in paths.items():
            if path.exists():
                continue
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                build_command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            self.log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            self._libs[name] = lib


LIBRARIES = _Libraries()


def build_all() -> Dict[str, str]:
    """Build (if needed) and load every kernel library; returns the nvcc
    output of each source built by this process."""
    LIBRARIES.get(SOURCES[0])
    return dict(LIBRARIES.log)
