"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` into its own shared library with a plain C
interface and loaded with `ctypes` (no PyTorch headers: a build takes
seconds, not minutes). Libraries go to `build/tcnerf_torch/` at the repo
root, named by a hash of the sources so an edited kernel is rebuilt. Nothing
is built or loaded at import time: the first launch on a CUDA tensor builds.

`build_all()` starts one `nvcc` per source, all together, and returns each
one's `-Xptxas -v` report (registers, shared memory, spills).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

from ..utils.profiling import RECORDER, span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tcnerf_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("tcnerf_torch: nvcc not found (needs the CUDA "
                           "toolkit on PATH or in /usr/local/cuda)")
    return path


class KernelLib:
    """One CUDA source -> one shared library, plus its launch counts.

    `counts[name]` is raised by one in the Python wrapper each time it
    launches kernel `name`, and nowhere else; the span recorder reads it as
    the counters `kernels.<source stem>.<name>` (`utils/profiling.py`)."""

    def __init__(self, source: str, functions: Dict[str, List]):
        self.source = source
        self.functions = functions        # C symbol -> argtypes
        self.counts: collections.Counter = collections.Counter()
        self._lib: Optional[ctypes.CDLL] = None
        RECORDER.read_counts(f"kernels.{Path(source).stem}", self.counts)

    def _digest(self) -> str:
        h = hashlib.sha1()
        for p in sorted(CSRC.glob("*.cu*")):      # .cu and shared .cuh
            h.update(p.name.encode())
            h.update(p.read_bytes())
        h.update(" ".join(ARCH_FLAGS).encode())
        return h.hexdigest()[:12]

    @property
    def path(self) -> Path:
        return BUILD_DIR / f"lib{Path(self.source).stem}-{self._digest()}.so"

    def compile_cmd(self, out: Path) -> List[str]:
        return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
                "-o", str(out), str(CSRC / self.source)]

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            if not self.path.exists():
                build_all([self])
            lib = ctypes.CDLL(str(self.path))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, name: str, *args) -> None:
        """Launch through C symbol `name`; raise if the launch failed."""
        err = getattr(self.lib(), name)(*args)
        if err != 0:
            raise RuntimeError(f"tcnerf_torch: {name} launch failed with "
                               f"cudaError {err}")


# host work only, and a first launch may build inside a measured range:
# a span, never a profiler range
@span("tcnerf.kernels.build", profile=False)
def build_all(libs) -> Dict[str, str]:
    """Compile every lib not yet built, one nvcc process each, in parallel.

    Returns {source: nvcc/ptxas output}. Raises if any compile fails.
    Runs under the span `tcnerf.kernels.build`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lib in libs:
        if lib.path.exists():
            continue
        tmp = lib.path.with_name(f"{lib.path.stem}.tmp{os.getpid()}.so")
        procs[lib.source] = (lib, tmp, subprocess.Popen(
            lib.compile_cmd(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    reports = {}
    failed = []
    for source, (lib, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[source] = out
        if proc.returncode != 0:
            failed.append(f"{source}:\n{out}")
        else:
            os.replace(tmp, lib.path)     # atomic: no half-written library
    if failed:
        raise RuntimeError("tcnerf_torch: nvcc failed\n" + "\n".join(failed))
    return reports


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (NULL for None) as a ctypes argument."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_handle(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
