"""Build a hand-written CUDA source into a shared library, at first use.

Each kernel of the port is one ``csrc/<name>.cu`` file with a plain C
interface.  ``build`` compiles it with nvcc for ``sm_90a`` into
``build/torch_kernels/lib<name>-<digest>.so`` (keyed by the digest of the
source and the shared headers ``csrc/*.cuh``, so an edited source or
header is rebuilt and an unchanged one is not) and
``load`` opens it with ctypes.  Nothing is compiled when a module is
imported; a missing nvcc raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    os.pardir, "build", "torch_kernels"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc(name: str) -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            f"the {name} CUDA kernel is built at first use and needs nvcc "
            "(the CUDA toolkit); none was found")
    return path


def build(name: str) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns the
    library's path and nvcc's output ("" when nothing was compiled)."""
    source = os.path.join(CSRC, f"{name}.cu")
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    sha = hashlib.sha1()
    for path in [source] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            sha.update(f.read())
    digest = sha.hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(so):
        return so, ""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(name), *NVCC_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(tmp, so)
    return so, log


class Library:
    """One kernel's library, built and loaded once per process.
    ``configure`` sets the ctypes signatures of the loaded CDLL, and
    ``error_fn`` names its C function from a CUDA error code to its text;
    ``log`` keeps nvcc's output of the build (ptxas register and spill
    report)."""

    def __init__(self, name: str, configure,
                 error_fn: str = "kernel_error_string"):
        self.name = name
        self._configure = configure
        self._error_fn = error_fn
        self._lib = None
        self._lock = threading.Lock()
        self.log = ""

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                so, self.log = build(self.name)
                lib = ctypes.CDLL(so)
                err = getattr(lib, self._error_fn)
                err.restype = ctypes.c_char_p
                err.argtypes = [ctypes.c_int]
                self._configure(lib)
                self._lib = lib
            return self._lib

    def check(self, err: int) -> None:
        """Raise if a launch returned a CUDA error."""
        if err:
            raise RuntimeError(
                f"{self.name} kernel launch failed: "
                + getattr(self._lib, self._error_fn)(err).decode())
