"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries go to
``kernels/build/`` (git-ignored), named by a hash of the source, the
``csrc/*.cuh`` headers it includes, the generated headers and the flags,
so a changed source rebuilds and an unchanged one loads at once.  ``build_all`` starts one ``nvcc`` per source
at the same time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


class KernelSource:
    """One ``.cu`` file, its extra flags and the headers generated for it."""

    def __init__(self, name: str, flags: List[str],
                 headers: Optional[Callable[[], Dict[str, str]]] = None):
        self.name = name
        self.flags = flags
        self.headers = headers or (lambda: {})
        self.lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None
        self.ptxas: str = ""

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def _key(self, headers: Dict[str, str]) -> str:
        text = self.source.read_bytes()
        h = hashlib.sha256(text)
        for inc in re.findall(rb'#include "(\w+\.cuh)"', text):
            h.update((CSRC / inc.decode()).read_bytes())
        for k in sorted(headers):
            h.update(k.encode() + headers[k].encode())
        h.update(" ".join(ARCH + BASE_FLAGS + self.flags).encode())
        return h.hexdigest()[:16]

    def lib_path(self) -> Tuple[Path, Dict[str, str]]:
        headers = self.headers()
        return BUILD_DIR / f"lib{self.name}-{self._key(headers)}.so", headers

    def start(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` unless the library is already built."""
        path, headers = self.lib_path()
        if path.exists():
            log = path.with_suffix(".ptxas.txt")
            self.ptxas = log.read_text() if log.exists() else ""
            self.build_seconds = 0.0
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        inc = BUILD_DIR / f"include-{path.stem}"
        inc.mkdir(exist_ok=True)
        for fname, text in headers.items():
            (inc / fname).write_text(text)
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        cmd = ([nvcc()] + ARCH + BASE_FLAGS + self.flags
               + ["-I", str(inc), "-o", str(tmp), str(self.source)])
        self._t0 = time.perf_counter()
        self._tmp, self._path = tmp, path
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is not None:
            out, _ = proc.communicate()
            self.build_seconds = time.perf_counter() - self._t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
            self.ptxas = out
            self._path.with_suffix(".ptxas.txt").write_text(out)
            os.replace(self._tmp, self._path)
        path, _ = self.lib_path()
        lib = ctypes.CDLL(str(path))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def load(self) -> ctypes.CDLL:
        if self.lib is None:
            self.finish(self.start())
        return self.lib

    def resources(self) -> List[str]:
        """``-Xptxas -v`` summary lines: registers, spills, shared memory."""
        return [ln.strip() for ln in self.ptxas.splitlines()
                if re.search(r"registers|spill", ln)]


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build_all(sources: List[KernelSource]) -> None:
    """Build every source with one ``nvcc`` each, all started together;
    every ``nvcc`` is waited for before the first failure is raised."""
    procs = [(s, s.start()) for s in sources]
    error = None
    for s, p in procs:
        try:
            s.finish(p)
        except RuntimeError as e:
            error = error or e
    if error is not None:
        raise error


def check(err: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
