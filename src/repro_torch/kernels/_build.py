"""Build the hand-written CUDA kernels and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface. No source includes
PyTorch's headers, so a build takes seconds, not minutes. On first use
every missing library builds at once (one ``nvcc`` per source, all
started together) into ``_build/<key>/`` beside this file, where ``key``
hashes the sources and the flags: an edited source gets a fresh
directory, an unchanged tree reuses what is there.

Every C entry point takes its pointers and sizes, launches on the stream
it is given and returns ``cudaGetLastError()``; ``launch`` raises when
that is not 0. Nothing here falls back to the plain PyTorch version: a
failed build or launch is an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # registers, shared memory and spills per kernel, kept in
              # the build log
              "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}
_SMS: Dict[int, int] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default install location."""
    candidates = []
    home = os.environ.get("CUDA_HOME")
    if home:
        candidates.append(Path(home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of repro_torch build on the machine with the card")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def nvcc_command(exe: str, src: Path, out: Path) -> List[str]:
    return [exe, *NVCC_FLAGS, "-o", str(out), str(src)]


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all at once.

    Returns {kernel name: library path}. Raises RuntimeError with nvcc's
    output when any source fails to build.
    """
    out_dir = build_dir()
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in sources()}
    todo = [src for src in sources() if not libs[src.stem].exists()]
    if not todo:
        return libs
    exe = nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, failed = [], []
    try:
        for src in todo:
            tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
            procs.append((src.stem, tmp, subprocess.Popen(
                nvcc_command(exe, src, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        for name, tmp, proc in procs:
            log, _ = proc.communicate()
            (out_dir / f"{name}.log").write_text(log)
            if proc.returncode:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            else:
                # atomic: a concurrent builder never loads a half-written
                # library
                os.replace(tmp, libs[name])
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return libs


def build_logs() -> Dict[str, str]:
    """nvcc's output (with ptxas's register and spill report) per kernel
    built into the current build directory."""
    return {p.stem: p.read_text() for p in sorted(build_dir().glob("*.log"))}


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of ``device``'s card, read once: the
    plans that spread work over the SMs take it as an argument."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``lib<name>.so``, building on first use.
    The stream is always the last argument."""
    key = (name, symbol)
    fn = _FUNCS.get(key)
    if fn is None:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build_all()[name]))
        fn = getattr(lib, symbol)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return fn


def require(t: torch.Tensor, name: str, *, dtype: torch.dtype,
            ndim: int) -> None:
    """Check what a kernel takes: dtype, rank, contiguity, a CUDA device.
    CPU tensors belong to the plain versions (``kernels.ops``)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not t.is_cuda:
        raise ValueError(f"{name} must lie on a CUDA device, got {t.device}; "
                         "CPU tensors take the plain version through "
                         "repro_torch.kernels.ops")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} has {t.numel()} elements; the kernels "
                         "take 32-bit sizes")


def launch(fn: ctypes._CFuncPtr, name: str, device: torch.device,
           *args) -> None:
    """Call a C entry on ``device``'s current stream; raise if the launch
    was refused."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed to launch: "
                           f"{torch.cuda.CudaError(rc)}")
