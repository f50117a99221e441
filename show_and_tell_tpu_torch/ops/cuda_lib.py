"""Build, load and count the port's hand-written CUDA kernels.

The sources live in ``show_and_tell_tpu_torch/csrc/``. Each ``.cu`` file is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library with a plain
C interface, loaded with ``ctypes``. The libraries go to
``show_and_tell_tpu_torch/_build/`` (git-ignored), named by a hash of the
source, the shared header and the flags, so an edited source is rebuilt and an unchanged one is
reused. All sources build in parallel at first use, one ``nvcc`` each.

Nothing here runs at import time: the CPU tests import every module of the
port, and the CPU host has no ``nvcc``.

``LAUNCHES`` counts kernel launches by name. Each wrapper adds one right
after its kernel launched, and nowhere else, so a run can show that it went
through the kernels. A kernel with more than one design also counts the
launch under ``"<name>/<design>"`` (``count``), so a run can show which
design its shapes took (``designs``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = (
    "lstm_cell.cu", "additive_attention.cu", "beam_attention.cu", "decode_attention.cu", "tanh_probe.cu",
)
HEADERS = ("sat_common.cuh",)  # included by the sources; part of every library's hash
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp, _i = ctypes.c_void_p, ctypes.c_int
# C signatures: (argtypes), every function returns a cudaError_t as int
_SIGNATURES = {
    "lstm_cell.cu": {
        "sat_lstm_cell": (_vp,) * 7 + (_i,) * 5 + (_vp,),
        "sat_lstm_cell_sm90": (_vp,) * 7 + (_i,) * 4 + (_vp,),
    },
    "additive_attention.cu": {
        "sat_additive_attention": (_vp,) * 6 + (_i,) * 6 + (_vp,),
        "sat_additive_attention_onepass": (_vp,) * 6 + (_i,) * 7 + (_vp,),
    },
    "beam_attention.cu": {
        "sat_attention_scores": (_vp,) * 4 + (_i,) * 6 + (_vp,),
        "sat_attention_scores_stream": (_vp,) * 4 + (_i,) * 7 + (_vp,),
        "sat_attention_beam_st": (_vp,) * 6 + (_i,) * 5 + (_vp,),
        "sat_attention_beam_st_cluster": (_vp,) * 6 + (_i,) * 6 + (_vp,),
        "sat_attention_beam_grid2": (_vp,) * 6 + (_i,) * 6 + (_vp,),
    },
    "decode_attention.cu": {
        "sat_decode_attention": (_vp,) * 6 + (_i,) * 7 + (_vp,),
        "sat_attention_kmax": (),
    },
    "tanh_probe.cu": {
        "sat_tanh_probe": (_vp,) * 3 + (_i,) * 7 + (_vp,),
    },
}

LAUNCHES: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(src: str) -> str:
    text = b""
    for name in (src, *HEADERS):
        with open(os.path.join(CSRC, name), "rb") as fh:
            text += fh.read()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{src[:-3]}-{digest[:16]}.so")


def build_all() -> float:
    """Compile every source that has no up-to-date library, all at once.
    Returns the seconds spent. Raises with the compiler's output on error."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for src in SOURCES:
        out = _lib_path(src)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for src, out, tmp, p in procs:
        log, _ = p.communicate()
        with open(out[:-3] + ".log", "w") as fh:
            fh.write(log)
        if p.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_logs() -> Dict[str, str]:
    """The compiler's output (register and shared-memory use) per source."""
    logs = {}
    for src in SOURCES:
        path = _lib_path(src)[:-3] + ".log"
        if os.path.exists(path):
            with open(path) as fh:
                logs[src] = fh.read()
    return logs


def library(src: str) -> ctypes.CDLL:
    """The loaded library of one source, building all sources at first use."""
    with _lock:
        if src not in _libs:
            path = _lib_path(src)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES[src].items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libs[src] = lib
        return _libs[src]


def count(name: str, design: str) -> None:
    """One launch of kernel ``name`` by ``design``."""
    LAUNCHES[name] += 1
    LAUNCHES[f"{name}/{design}"] += 1


def designs(name: str) -> Dict[str, int]:
    """Launches of kernel ``name`` by design since ``LAUNCHES`` was cleared."""
    prefix = name + "/"
    return {k[len(prefix):]: n for k, n in LAUNCHES.items() if k.startswith(prefix) and n}


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def dtype_code(t: torch.Tensor) -> int:
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}") from None


def vectorizable(sizes, *tensors: torch.Tensor) -> bool:
    """Whether a kernel may load 16-byte vectors: every row length in
    ``sizes`` is a multiple of the vector width of the tensors' dtype and
    every tensor starts on a 16-byte boundary."""
    width = 16 // tensors[0].element_size()
    return all(n % width == 0 for n in sizes) and all(t.data_ptr() % 16 == 0 for t in tensors)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_operands(what: str, device: torch.device, **tensors: torch.Tensor) -> None:
    """Every operand on the CUDA ``device``, contiguous. Raises ValueError.
    A kernel has no backward of its own: with grad mode on, an operand that
    requires grad raises RuntimeError instead of giving an output that
    autograd would silently cut off (training goes through the ops' autograd
    Functions, which launch the kernels with grad mode off)."""
    if device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise RuntimeError(
            f"{what}: an operand requires grad and the kernel has no backward; "
            "run it under torch.no_grad() or through its autograd Function"
        )
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
