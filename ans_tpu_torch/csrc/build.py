"""Build the CUDA kernels and bind them with ctypes.

Each kernel is one `csrc/<name>.cu` file with a plain C interface
(KERNELS lists them).  At first use, `nvcc` compiles it for Hopper
(sm_90a) into a shared library under `ans_tpu_torch/_build/`, named by a
hash of its sources and flags so that an edited source is rebuilt;
`ctypes` loads it.  `load_all` starts one `nvcc` per missing library,
all at once.  Nothing here falls back: without `nvcc` the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parent / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the kernel sources, csrc/<name>.cu, each exporting the C function <name>
KERNELS = ("encode_scan", "encode_scan_grouped", "place", "decode_search",
           "decode_direct", "decode_grouped", "bytesplit_encode",
           "svb_decode", "vbyte_decode", "op_probe")

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # name -> nvcc/ptxas report of this process


def find_nvcc() -> str:
    """nvcc from PATH, else $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels of ans_tpu_torch are "
        "compiled from ans_tpu_torch/csrc at first use, and a CUDA tensor "
        "has no other path")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The compiled library of csrc/<name>.cu, built on first use."""
    return load_all((name,))[name]


def load_all(names=KERNELS) -> dict[str, ctypes.CDLL]:
    """The libraries of `names`, building the missing ones in parallel
    (one nvcc process per source)."""
    missing = [name for name in dict.fromkeys(names)
               if name not in _libs and not _library_path(name).exists()]
    jobs = {}
    if missing:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in missing:
        out = _library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        jobs[name] = (out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (out, tmp, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed on {name}.cu:\n{err}")
            continue
        os.replace(tmp, out)
        build_log[name] = err
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _libs:
            lib = ctypes.CDLL(str(_library_path(name)))
            lib.lane_error_string.argtypes = [ctypes.c_int]
            lib.lane_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return {name: _libs[name] for name in names}


def function(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `name` of csrc/<name>.cu, typed; it returns a
    cudaError_t as int."""
    fn = getattr(load(name), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise when a launch returned a CUDA error."""
    if err:
        msg = load(name).lane_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def current_stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The common CUDA device of a kernel's tensors; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev
