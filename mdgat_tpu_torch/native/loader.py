"""ctypes bindings and lazy build of the native threaded keypoint loader.

Port of ``mdgat_tpu/native/loader.py``, with its own copy of ``loader.cc``.
At first use ``g++ -O3`` compiles the source into
``mdgat_tpu_torch/_build/`` (listed in ``.gitignore``), never beside it. The
file name carries a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads as it is; the library is written under
a private name and renamed, so a process building at the same time never
loads a half-written one.

When the build fails (no ``g++``), :func:`native_available` is False and
``SparseDataset.batches`` takes the numpy path, as the JAX package does:
this is host code, not a kernel, and both paths give the same bits.
``NativeLoader.batches_loaded`` counts the batches read here, as the kernel
wrappers count their launches.

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().with_name("loader.cc")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread"]

_lock = threading.Lock()
_libs = {}          # built library path -> loaded CDLL, None after a failure


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libmdgat_loader_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> Optional[ctypes.CDLL]:
    if not out.exists():
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
                tmp = os.path.join(work, "lib.so")
                subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, out)
        except (OSError, subprocess.CalledProcessError):
            return None
    lib = ctypes.CDLL(str(out))
    lib.mdgat_load_batch.restype = ctypes.c_int
    lib.mdgat_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """The loader library, built at first use; None when ``g++`` fails (a
    failed build is not retried in this process)."""
    out = library_path()
    with _lock:
        if out not in _libs:
            _libs[out] = _build(out)
        return _libs[out]


def native_available() -> bool:
    return load_library() is not None


class NativeLoader:
    """Threaded batched keypoint-file loader: ``load(paths)`` reads every
    file on a pool of ``n_threads`` C++ threads, applies the score filter
    and the fixed-size policy, and fills one batch of buffers."""

    batches_loaded = 0      # load() calls, in this process

    def __init__(self, max_kpts: int, ensure_kpts_num: bool,
                 score_min: float = 10.0, n_threads: int = 4):
        self.max_kpts = max_kpts
        self.ensure = ensure_kpts_num
        self.score_min = score_min
        self.n_threads = n_threads
        self.lib = load_library()
        if self.lib is None:
            raise RuntimeError("native loader unavailable (g++ build failed)")

    def load(self, paths: List[str]
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """``(kp [n, K, 3], score [n, K], desc [n, K, 33], counts [n])``
        float32 / int32 for ``n`` files; ``counts`` holds each file's valid
        keypoints (0: every row failed the score filter, zero-filled). A
        file that cannot be read raises ``IOError``."""
        n = len(paths)
        kp = np.empty((n, self.max_kpts, 3), np.float32)
        score = np.empty((n, self.max_kpts), np.float32)
        desc = np.empty((n, self.max_kpts, 33), np.float32)
        counts = np.empty((n,), np.int32)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        fp = ctypes.POINTER(ctypes.c_float)
        rc = self.lib.mdgat_load_batch(
            arr, n, self.max_kpts, int(self.ensure),
            ctypes.c_float(self.score_min), self.n_threads,
            kp.ctypes.data_as(fp), score.ctypes.data_as(fp),
            desc.ctypes.data_as(fp),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        if rc != 0:
            raise RuntimeError(f"mdgat_load_batch failed rc={rc}")
        if (counts < 0).any():
            bad = [paths[i] for i in np.nonzero(counts < 0)[0][:3]]
            raise IOError(f"native loader failed on {bad}")
        NativeLoader.batches_loaded += 1
        return kp, score, desc, counts
