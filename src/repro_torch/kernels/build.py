"""Build and bind the CUDA kernels in ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a`` and linked into one shared library
with a plain C interface, loaded with :mod:`ctypes`.  The library lands in
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed on a
hash of the sources and flags, so a changed source builds anew.  A failed
build raises.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0 and only
then counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

_P, _I = ctypes.c_void_p, ctypes.c_longlong
# C entry point -> argument types before the trailing stream pointer.
SIGNATURES = {
    "frontier_gather_full": (_P, _P, _P, _I, _I, _I, _I, _I),
    "frontier_gather": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I),
    "frontier_scatter": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I),
    "bitmap_or_reduce": (_P, _P, _I, _I, _I),
}

#: Kernel launches per entry point since the last :func:`reset_launches`.
LAUNCHES = {name: 0 for name in SIGNATURES}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    )
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this source hash has none yet; return it.

    The compiler's resource report (``-Xptxas -v``) is kept beside the
    library as ``build.log``."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    out_dir = BUILD_ROOT / _digest(sources)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        units = [s for s in sources if s.suffix == ".cu"]
        objs = [Path(tmp) / (s.stem + ".o") for s in units]
        procs = [
            subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(units, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [s.name for s, p in zip(units, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(Path(tmp) / LIB_NAME),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out_dir / "build.log").write_text("\n".join(logs + [link.stdout]))
        os.replace(Path(tmp) / LIB_NAME, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, "repro_" + name)
            fn.argtypes = list(args) + [_P]
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``repro_<name>`` on ``device``'s current stream;
    raise if the launch failed, else count it."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, "repro_" + name)(*args, stream)
    if err:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} ({msg})")
    LAUNCHES[name] += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank ``ndim``
    on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected rank {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def vectorizable(eb: int, *tensors: torch.Tensor) -> bool:
    """Whether a kernel that walks blocks of ``eb`` slots may move 16 bytes
    at a time in ``tensors``: ``eb`` a multiple of 16 and every tensor's
    first element 16-byte aligned (so is every block's, then)."""
    return eb % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def route(t: torch.Tensor) -> str:
    """``"plain"`` for a CPU tensor, ``"cuda"`` for a CUDA tensor; any
    other device raises."""
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel for device {t.device}")
