"""Build the port's CUDA kernels at first use, load them with ctypes, and
check what a wrapper hands them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on its own into
``build/repro_torch_kernels/<hash>/lib<name>.so`` under the checkout, where
``<hash>`` covers every source in ``csrc/`` and the nvcc flags, so an edited
source never loads a stale library. ``build_all()`` starts one nvcc per
source at once; ``load(name)`` builds what is missing and returns the
``ctypes.CDLL``. A failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_libs: Dict[str, ctypes.CDLL] = {}
_bindings: Dict[str, Callable[[ctypes.CDLL], None]] = {}
_lock = threading.Lock()
build_log: Dict[str, str] = {}      # name -> nvcc's output (ptxas register/smem report)


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "need the CUDA toolkit to build")
    return found


def _so_path(name: str) -> Path:
    return BUILD_ROOT / _digest() / f"lib{name}.so"


def _start(name: str):
    out = _so_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"lib{name}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str] = None) -> Dict[str, float]:
    """Compile every missing library, one nvcc per source, all in parallel.
    Returns {name: seconds} for the sources built in this call."""
    names = list(names or sources())
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names if not _so_path(n).exists()}
    built = {}
    failures = []
    for name, (proc, tmp, out) in started.items():
        stdout, stderr = proc.communicate()
        build_log[name] = stdout + stderr
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{stderr}")
            continue
        os.replace(tmp, out)        # atomic: concurrent builders never see a partial .so
        built[name] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return built


def register_binding(name: str, bind: Callable[[ctypes.CDLL], None]):
    """``bind(lib)`` sets argtypes/restype of lib<name>.so once it loads."""
    _bindings[name] = bind


def load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _so_path(name).exists():
                build_all([name])
            lib = ctypes.CDLL(str(_so_path(name)))
            _bindings[name](lib)
            _libs[name] = lib
        return lib


# ---------------------------------------------------------------------------
# launch-side helpers shared by the wrappers

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh


_sm_counts: Dict[int, int] = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (read once)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


class LaunchCounter:
    """Number of kernel launches a wrapper made on the card."""

    def __init__(self):
        self.n = 0

    def reset(self):
        self.n = 0


def runs_plain(t) -> bool:
    """Whether a wrapper given ``t`` runs its kernel's plain version: a CPU
    tensor or a meta tensor (the dry-run's). A CUDA tensor always launches
    the kernel."""
    return t.device.type in ("cpu", "meta")


def checked_as_card(t) -> bool:
    """Whether a wrapper given ``t`` applies the checks the card's launch
    applies: on a CUDA tensor before it launches, on a meta tensor before
    it runs the plain version, so that a dry-run raises where the card
    would refuse. A CPU tensor skips them (the plain versions take fp64 and
    any head size)."""
    return t.device.type != "cpu"


def check_operand(name, t, dtype, device):
    """Raise unless ``t`` is what a kernel takes: on ``device``, of
    ``dtype``, contiguous and 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:         # 0 on the meta device: a meta tensor passes
        raise ValueError(f"{name} must be 16-byte aligned")
