"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/kernels/`` beside the package (a
directory ``.gitignore`` lists), named by a hash of the source, the
``csrc/`` headers it includes (directly or through another header) and
the flags, so an edited source or header is rebuilt and an unchanged one
is not. Nothing
here runs at import: the CPU tests import every module, and only a call on
a CUDA tensor builds.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> Optional[str]:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(cuda_home, "bin", "nvcc")
                  if cuda_home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    return None


def _headers(source: bytes) -> list:
    """The ``csrc/`` headers ``source`` includes with ``#include "..."``,
    directly or through another header: each once, in the order a
    depth-first walk first reaches it (a cycle ends where it closes)."""
    seen, order = set(), []

    def walk(text: bytes):
        for name in re.findall(rb'#include\s+"([^"]+)"', text):
            if name in seen:
                continue
            seen.add(name)
            with open(os.path.join(CSRC, name.decode()), "rb") as f:
                body = f.read()
            order.append(body)
            walk(body)

    walk(source)
    return order


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` lands, named by a hash of the
    source, every ``csrc/`` header it includes (nested ones too) and the
    flags."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        source = f.read()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode())
    for header in _headers(source):
        digest.update(header)
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its build exists; returns the
    library's path. ``nvcc``'s ``-Xptxas -v`` report (registers, shared
    memory, spills) is kept beside it as ``.log``. Raises if there is no
    ``nvcc`` or the compile fails."""
    return build_all([name])[0]


def build_all(names) -> list:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built yet,
    one ``nvcc`` per source, all started together; returns the libraries'
    paths in order."""
    outs = [library_path(n) for n in names]
    todo = [(n, o) for n, o in zip(names, outs) if not os.path.exists(o)]
    if not todo:
        return outs
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build the CUDA kernel {todo[0][0]!r}: nvcc not found "
            f"(set CUDA_HOME or put nvcc on PATH)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = f"{out}.{os.getpid()}.tmp"
        procs.append((name, out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name!r} "
                          f"(rc {proc.returncode}):\n{stderr}")
            continue
        with open(out[:-3] + ".log", "w") as f:
            f.write(stdout + stderr)
        os.replace(tmp, out)   # atomic: a concurrent builder loads either
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(build(name))
        return _LIBS[name]
