"""Build and load the optional C++ libraries: the scorers of the metric suite
and the batch image decoder of the data pipeline.

The sources are the repository's ``csrc/{ptb_tokenizer,bleu,cider,rouge,
meteor,image_loader}.cpp``. Each is compiled with ``g++`` (``csrc/Makefile``'s
flags, and its link flags: ``-ljpeg -lpng`` for the image decoder) at first
use into ``show_and_tell_tpu_torch/_build/native/`` (git-ignored),
named by a hash of the source and the flags, and loaded with ``ctypes`` from
there. The ``csrc/*.so`` that ``make`` builds beside the sources belong to
the JAX package and are never loaded here: ``dlopen`` of one path returns
one handle, and METEOR keeps its synonym and paraphrase tables in the
library's globals, so a shared handle would let a table swap in one package
change the other's scores.

Probe policy, as the JAX package's loader:

- positive results are cached per library (one ``CDLL`` ever);
- negative results are NOT latched: a later probe builds and loads again.
  Without ``g++`` a probe costs a hash of the source and one
  ``shutil.which``;
- any build, load or configure failure degrades to the pure-Python path
  silently. ``status()`` says which path each scorer takes.

``libimage_loader.so`` (``data/pipeline.py``) needs libjpeg's and libpng's
headers and libraries on the host; where they are missing its build fails
and the pipeline decodes with PIL.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(os.path.dirname(_PKG), "csrc")
BUILD_DIR = os.path.join(_PKG, "_build", "native")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
# soname -> its source in csrc/
SOURCES = {
    "libptb_tokenizer.so": "ptb_tokenizer.cpp",
    "libbleu.so": "bleu.cpp",
    "libcider.so": "cider.cpp",
    "librouge.so": "rouge.cpp",
    "libmeteor.so": "meteor.cpp",
    "libimage_loader.so": "image_loader.cpp",
}
# soname -> the libraries it links, after the source (csrc/Makefile)
LINK_FLAGS = {"libimage_loader.so": ("-ljpeg", "-lpng")}
# the metrics modules with a native path, and their libraries
SCORERS = ("tokenizer", "bleu", "cider", "rouge", "meteor")
SCORER_LIBS = tuple(so for so in SOURCES if so not in LINK_FLAGS)

_LIBS: Dict[str, ctypes.CDLL] = {}  # soname -> loaded+configured lib
_lock = threading.Lock()


def lib_path(soname: str) -> str:
    """Where the build of ``soname`` for the current source and flags lives."""
    with open(os.path.join(CSRC, SOURCES[soname]), "rb") as fh:
        text = fh.read()
    flags = CXX_FLAGS + LINK_FLAGS.get(soname, ())
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{soname[:-3]}-{digest[:16]}.so")


def build(sonames: Iterable[str] = SCORER_LIBS) -> float:
    """Compile every library in ``sonames`` (by default the scorers') that
    has no up-to-date build, all at once, one ``g++`` each. Returns the
    seconds spent. Raises when ``g++`` is missing or a compile fails, with
    the compiler's output.

    Processes that build at once (test workers) serialise on a file lock;
    each output is written to a temporary name and published by
    ``os.replace``, so a reader never sees a torn library."""
    t0 = time.perf_counter()
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH: the native libraries cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock_fh:
        fcntl.flock(lock_fh, fcntl.LOCK_EX)
        procs = []
        for soname in sonames:
            out = lib_path(soname)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [cxx, *CXX_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[soname]), *LINK_FLAGS.get(soname, ())]
            procs.append((soname, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed = []
        for soname, out, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"{soname}:\n{log}")
    if failed:
        raise RuntimeError("g++ failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load_csrc_lib(
    soname: str, configure: Optional[Callable[[ctypes.CDLL], None]] = None
) -> Optional[ctypes.CDLL]:
    """Build ``soname`` if needed, load it from ``BUILD_DIR``, run
    ``configure(lib)`` once (restype/argtypes setup, table pushes), and cache
    the result. Returns None when it cannot be built, loaded or configured."""
    with _lock:
        lib = _LIBS.get(soname)
        if lib is not None:
            return lib
        try:
            path = lib_path(soname)
            if not os.path.exists(path):
                build((soname,))
            lib = ctypes.CDLL(path)
            if configure is not None:
                configure(lib)
        except Exception:
            return None
        _LIBS[soname] = lib
        return lib


def status() -> Dict[str, str]:
    """``{scorer: "native" | "python"}``: the path each scorer of the suite
    takes now. Probes each library (building it on first use); the PTB
    tokenizer's native path is opt-in (``PTBTokenizer.tokenize(...,
    use_cpp=True)``) even where it is live."""
    import importlib

    out = {}
    for scorer in SCORERS:
        mod = importlib.import_module(f"show_and_tell_tpu_torch.metrics.{scorer}")
        probe = mod._cpp_tokenizer_available if scorer == "tokenizer" else mod._cpp_available
        out[scorer] = "native" if probe() else "python"
    return out
