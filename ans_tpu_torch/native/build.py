"""Build the host library, native/ans_native.cpp, with g++.

At first use g++ compiles the source into a shared library under
`ans_tpu_torch/_build/`, named by a hash of the source, the flags and what
`-march=native` resolves to on this machine, so that every machine (and
every edit of the source) gets its own build.  The compiler writes a
temporary file that is renamed into place, so processes that build at the
same time never load a half-written library.  Nothing falls back: without
g++, or when the build fails, `build` raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "ans_native.cpp"
BUILD_DIR = HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-ffp-contract=off")

build_seconds: float | None = None  # the g++ run of this process, if any


def find_cxx() -> str:
    """g++ from PATH."""
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError(
        "g++ not found on PATH: the host library of ans_tpu_torch is "
        "compiled from ans_tpu_torch/native/ans_native.cpp at first use, "
        "and the codecs have no other path")


def _target(cxx: str) -> str:
    """The target options that -march=native selects on this machine."""
    proc = subprocess.run([cxx, *CXX_FLAGS[:2], "-Q", "--help=target"],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{cxx} -march=native failed:\n{proc.stderr}")
    return proc.stdout


def library_path(cxx: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_target(cxx).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libansnative-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The path of the built library, compiling it when it is missing."""
    global build_seconds
    cxx = find_cxx()
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def compiler_version() -> str:
    """The first line of `g++ --version`."""
    return subprocess.run([find_cxx(), "--version"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
