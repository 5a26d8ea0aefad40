"""Build a CUDA source into a shared library and load it with ctypes.

The port's kernels have a plain C interface (pointers, sizes, a stream)
and no PyTorch headers, so one ``nvcc`` call per source builds in
seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <source>

The library lands in ``repro_torch/_build/`` (git-ignored), named by a
hash of the source, so an edited source builds anew and an unchanged one
is loaded as it is.  The compiler's output (``-Xptxas -v``: registers,
shared memory, spills per kernel) is kept beside it as ``.log``.  The
build happens at the first launch, never at import.  A failing ``nvcc``
raises :class:`KernelBuildError` with the compiler's output; nothing
falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelBuildError("nvcc not found on PATH, in $CUDA_HOME/bin or "
                           "in /usr/local/cuda/bin")


def library_path(name: str, source: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, source: pathlib.Path) -> pathlib.Path:
    """Compile ``source`` unless its library already exists; return it."""
    out = library_path(name, source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(f"nvcc failed ({proc.returncode}) on "
                               f"{source}:\n{log}")
    os.replace(tmp, out)                       # atomic: never a half library
    return out


def load(name: str, source: pathlib.Path) -> ctypes.CDLL:
    """Build ``source`` if its library is missing, then load it; each
    kernel module keeps the handle it binds (``functools.cache``)."""
    return ctypes.CDLL(str(build(name, source)))
