"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, loaded with ``ctypes``.
Libraries are named by a digest of the source, the shared headers
(``csrc/*.cuh``) and the flags and go into
``speech_editing_tpu_torch/_build/`` (listed in ``.gitignore``), so a
library is built once per source version, at first use. ``build_all``
starts one ``nvcc`` per source, all at once, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("diffnet_block", "diffnet_block_bwd", "mel_kernel", "flash_attention",
           "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_functions: dict[tuple[ctypes.CDLL, str], object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every library not yet built, one nvcc each, in parallel.

    Returns {name: the compiler's report (ptxas registers, shared memory,
    spills)} for the libraries this call built. Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def kernel_function(name: str, symbol: str, argtypes: list):
    """C function ``symbol`` of ``csrc/<name>.cu``'s library, built first if
    missing, returning an int (a launch returns its ``cudaGetLastError()``)."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:    # threads of a server may reach a kernel's first call together
            lib = _loaded.get(name)
            if lib is None:
                build_all((name,))
                lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    fn = _functions.get((lib, symbol))   # keyed by library: a swapped-in build takes effect
    if fn is None:
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[lib, symbol] = fn
    return fn


# -- launch helpers shared by the wrappers -------------------------------------

def check_tensor(t, name: str, shape: tuple, device, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` (float32, or
    bfloat16 for the kernels that take it) and ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def current_stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check_status(status: int, kernel: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {status}")
