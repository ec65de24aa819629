"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` for `sm_90a` into an object file, all
sources in parallel, and the objects are linked into one shared library
with a plain C interface, loaded with `ctypes`. The library lives in
`build/repro_torch/<hash of the sources and flags>/` at the repository
root, so an edited source rebuilds and an unchanged one loads at once.

Nothing here runs at import time: the first kernel launch on a CUDA tensor
triggers `library()`. On a machine without `nvcc` that raises a
`RuntimeError`; the CPU route never reaches it."""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "repro_torch")
# no --use_fast_math: embed_attn's cos arguments reach 1e5 (see its source)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# C signatures of the exported launchers; each returns a cudaError_t as int
SIGNATURES = {
    "repro_memory_update_table": [_P, _P, _I64, _I, _P, _I, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _P, _F, _I, _I, _P, _P, _P, _P],
    "repro_embed_attn": [_P, _I, _P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _P,
                         _P, _P, _I, _I, _P, _P],
    "repro_link_score": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the repro_torch CUDA kernels cannot be built on this machine")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> pathlib.Path:
    """Compile every source (one nvcc per file, all started together) and
    link them; returns the library path. Reuses an existing build whose
    hash matches."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "librepro_torch_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, _, p in procs:
        log, _ = p.communicate()
        (out_dir / (src.stem + ".log")).write_text(log)
        if verbose:
            print(f"[build] {src.name}:\n{log}", flush=True)
        if p.returncode != 0:
            failed.append(f"{src.name} (exit {p.returncode}):\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = out_dir / (lib_path.name + f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_args(name: str, device, specs) -> None:
    """Validate a launch's tensors before any pointer reaches the kernel.
    specs: (arg name, tensor, dtype, shape) with shape a tuple."""
    for arg, t, dtype, shape in specs:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor")
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected "
                            f"{dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def stream_ptr(device) -> int:
    """Raw handle of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
