"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

Each source exposes a plain C interface. It is compiled with ``nvcc`` for
``sm_90a`` into a shared library, at first use, from the repository's own
sources, and loaded with ``ctypes``. Libraries go to ``build/repro_torch/``
beside the package's ``src/`` directory (never the working directory) and
are keyed by a hash of the source, of every ``csrc/`` header it reaches
through ``#include "..."`` and of the flags, so an edited kernel or header
is rebuilt and an unchanged one is reused. ``defines`` (``NAME=VALUE``,
passed as ``-D``) build a variant of a source beside its library, under a
key of its own; the port's entry points load the plain builds only. The
compiler's output (``ptxas -v``: registers, shared memory and spills of
each kernel) is kept beside the library as ``ptxas_log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"the kernels in {CSRC}")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header of ``csrc/`` that it reaches
    through ``#include "..."`` lines, directly or through other headers."""
    root = CSRC.resolve()
    found, todo = [], [root / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_file() and dep.is_relative_to(root):
                todo.append(dep)
    return found


def _flags(defines: tuple[str, ...]) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (with ``defines``)
    lives."""
    digest = hashlib.sha256(" ".join(_flags(defines)).encode())
    for path in sources(name):
        digest.update(str(path.relative_to(CSRC.resolve())).encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def ptxas_log(name: str, defines: tuple[str, ...] = ()) -> Path:
    """The compiler's output of the build of ``csrc/<name>.cu``."""
    return library_path(name, defines).with_suffix(".log")


def ptxas_report(text: str) -> dict[str, tuple[int, int]]:
    """``{kernel: (registers, spill bytes stored)}`` from ``ptxas -v``
    output, kernels by their mangled names."""
    report: dict[str, list[int]] = {}
    name = None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
            report[name] = [0, 0]
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            report[name][0] = int(m.group(1))
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            report[name][1] = int(m.group(1))
    return {k: (r, sp) for k, (r, sp) in report.items()}


def build(name: str, defines: tuple[str, ...] = ()) -> Path:
    """The library of ``csrc/<name>.cu``, compiled first if it is missing;
    raises with the compiler's output if the build fails."""
    path = library_path(name, defines)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    ptxas_log(name, defines).write_text(proc.stdout)
    os.replace(tmp, path)  # atomic: readers never see a partial file
    return path


@functools.cache
def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build(name, defines)))
