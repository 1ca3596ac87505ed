"""The port's hand-written Hopper kernels: build, load, launch, count.

The CUDA C++ sources in ``csrc/`` are compiled at first use, one ``nvcc``
process for each source, all started together, and linked into a single
shared library with a plain C interface in
``argon_monte_carlo_tpu_torch/_build/`` (named by a hash of the sources and
flags, so an edit rebuilds).  The library is loaded with ``ctypes``;
nothing here runs when the package is imported, and nothing falls back:
a missing ``nvcc`` or a failed build raises.

Each exported function launches on PyTorch's current stream of the
tensors' device and returns ``cudaGetLastError()``; :func:`launch` makes
that device current for the call, raises on a non-zero code and then adds
one to ``launch_counts[name]``, so a run can show which kernels its main
path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Kernel name -> launches since the last reset.
launch_counts: Counter = Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Argument types of each exported amc_<name>, the stream last
# (tests/test_torch_pairs.py holds them against the C declarations).
_SIGNATURES = {
    "bin_and_table": [_P, _P, _I, _P, _P, _P, _I, _F, _F, _F, _F, _I, _I]
                     + [_P] * 8 + [_I, _P],
    "partner_sweep": [_P] * 6 + [_I] * 7 + [_F, _P, _P],
    "resolve_pairs": [_P] * 8 + [_I, _F, _F, _P, _P, _P],
    "flush_hist": [_P, _P, _I, _I, _I, _F] + [_P] * 8,
    "flush_hist_compacted": [_P, _P, _I, _P, _I, _I, _F] + [_P] * 7,
    "compact": [_P, _I, _I, _I, _P, _P, _P],
    "emit_pairs": [_P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _I] + [_P] * 9
                  + [_I, _P],
    "rebuild_sweep": [_P] * 9 + [_I] * 11 + [_P] * 5,
    "test_and_resolve": [_P] * 10 + [_I, _I, _I, _F, _F] + [_P] * 8,
    "research_dirty": [_P, _P, _P, _I, _I] + [_P] * 8
                      + [_I, _F, _F, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                         _F] + [_P] * 14,
    "pore_advance": [_P] * 9 + [_I, _I] + [_P] * 13,
    "allpairs_partner": [_P, _I, _F, _I] + [_P] * 4 + [_I, _P, _P],
    "pack_band": [_P, _I, _I, _I] + [_P, _P, _I, _I, _I] * 5 + [_P] * 4,
    "pack_indices": [_P, _I, _I] + [_P] * 5,
    "pack_band_pair": [_P, _P, _I, _P, _P, _I, _I, _I]
                      + [_P, _P, _I, _I, _I] * 5 + [_P] * 5,
}


class _Library:
    """The built library, loaded once per process."""

    handle: ctypes.CDLL | None = None
    build_seconds: float | None = None
    build_log: str = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built"
        )
    return found


def build() -> Path:
    """Compile csrc/*.cu into one shared library unless it is built: one
    ``nvcc -c`` process a source, run in parallel, then one link."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    tag = digest.hexdigest()[:16]
    out = BUILD_DIR / f"libamc_kernels_{tag}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    suffix = f"{tag}.{os.getpid()}"
    objects = [BUILD_DIR / f"{src.stem}.{suffix}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for src, obj in zip(sources, objects)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [src.name for src, proc in zip(sources, procs)
              if proc.returncode != 0]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append("link")
    _Library.build_seconds = time.perf_counter() - t0
    _Library.build_log = "".join(logs)
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(
            f"nvcc failed ({', '.join(failed)}):\n{_Library.build_log}"
        )
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    if _Library.handle is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, f"amc_{name}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _Library.handle = lib
    return _Library.handle


def build_info() -> tuple[float | None, str]:
    """(seconds of the build this process ran or None, nvcc's output)."""
    return _Library.build_seconds, _Library.build_log


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def optional_ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """``ptr(t)``, or the null pointer for an argument left out."""
    return ctypes.c_void_p(None) if t is None else ptr(t)


def launch(name: str, device: torch.device, *args) -> None:
    """Call ``amc_<name>`` on ``device``'s current stream, with ``device``
    made the current one for the call (a launch on a stream of another
    card than the current one fails); raise on a CUDA error, else count
    the launch.  Scalars are passed as Python ints and floats (ctypes
    converts them by the signature)."""
    fn = getattr(library(), f"amc_{name}")
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(device).cuda_stream)
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")
    launch_counts[name] += 1


def require_float32(dtype: str, devices) -> None:
    """Raise unless a run of working dtype ``dtype`` ("float32" or
    "float64") can use ``devices``: every kernel takes float32 only, so
    float64, the dtype of the CPU parity tests, runs on the CPU alone.
    Looks at the devices' types only and needs no card."""
    if dtype != "float32" and any(torch.device(d).type == "cuda"
                                  for d in devices):
        raise ValueError(
            f"dtype={dtype!r} on a CUDA device: the CUDA kernels take "
            f"float32 only; float64 is the CPU parity dtype (pass "
            f"device='cpu', or EngineConfig(dtype='float32'))")


def use_plain(t: torch.Tensor) -> bool:
    """Which side of a wrapper runs, decided by the tensor's device: the
    plain PyTorch version for a CPU tensor, the kernel for a CUDA tensor.
    Any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors on {t.device}: the plain version runs "
                         f"on the CPU and the kernel on CUDA")
    return t.device.type == "cpu"


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (the only layout the kernels take)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
