"""Build and load the hand-written Hopper kernels of ``mdgat_tpu_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and links the objects into one
shared library with a plain C interface, under ``mdgat_tpu_torch/_build/``
(listed in ``.gitignore``). The file name carries a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads as it is.
The library is loaded with ``ctypes`` (no PyTorch headers: the build takes
seconds, not the minutes of ``torch.utils.cpp_extension``). Every pointer
and the stream go through as ``c_void_p``; each entry returns its
``cudaError_t``, which the wrappers turn into an exception.

Nothing here runs at import: the CPU tests import every module, and a
CPU-only installation has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

# io dtype codes of the C entry points (csrc/common.cuh: IoDtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argtypes (all return cudaError_t as int)
_SIGNATURES = {
    # q, k, v, mask, o, thr, lse, slab, slab_floats, B, H, N, M, Dh, topk,
    # scale, io_dtype, stream
    "mdgat_topk_attention": [_P] * 8 + [_L] + [_I] * 8 + [_F, _I, _P],
    # a1, a1_dtype, a1_heads, a2, K1, K2, w, bias, res, out, out_dtype,
    # out_heads, rows_per_batch, R, C, relu, w_trans, stream
    "mdgat_gemm": [_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                   _I, _I, _I, _P],
    # a, b, partial, partial_floats, dw, db, R, K1, C, rows_per_split,
    # splits, stream
    "mdgat_gemm_tn": [_P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, k, v, dout, mask, thr, lse, o_full, dq_full, dk_full, dv_full,
    # delta, slab, slab_floats, B, H, N, M, Dh, key_tile, stream
    "mdgat_mha_attention_bwd": [_P] * 13 + [_L] + [_I] * 6 + [_P],
    # Z, log_mu, log_nu, scalars, d_out, d_bin_row, d_bin_col, d_corner, dZ,
    # dalpha, hist, scratch, scratch_floats, B, N, M, iters, cluster, stream
    "mdgat_sinkhorn_bwd": [_P] * 12 + [_L] + [_I] * 5 + [_P],
    # Z, log_mu, log_nu, scalars, out, bin_row, bin_col, corner, scratch,
    # scratch_floats, B, N, M, iters, cluster, stream
    "mdgat_sinkhorn": [_P] * 9 + [_L] + [_I] * 5 + [_P],
    # N, M, cluster, count
    "mdgat_sinkhorn_active_clusters": [_I] * 3 + [_P],
    # x, msg, w1, b1, rowmask, h1, partial, partial_floats, sums, D, R,
    # rows_per_block, blocks, io_dtype, stream
    "mdgat_tl_h1": [_P] * 7 + [_L, _P] + [_I] * 5 + [_P],
    # x, h1, a, c, w2, b2, y, D, R, rows_per_block, blocks, io_dtype, stream
    "mdgat_tl_fwd2": [_P] * 7 + [_I] * 5 + [_P],
    # g, h1, w2, vec4, partial, partial_floats, sums, D, R, rows_per_block,
    # blocks, io_dtype, stream
    "mdgat_tl_bwd_sums": [_P] * 5 + [_L, _P] + [_I] * 5 + [_P],
    # h1, vec4, g, partial, partial_floats, out, D, R, rows_per_split,
    # splits, io_dtype, stream
    "mdgat_tl_dw2": [_P] * 4 + [_L, _P] + [_I] * 5 + [_P],
    # g, h1, w2, vec6, rowmask, dh1, D, R, rows_per_block, blocks, io_dtype,
    # stream
    "mdgat_tl_dh1": [_P] * 6 + [_I] * 5 + [_P],
    # dense, bin_row, bin_col, gt0, gt1, rm, cm, s0, s1, cnt0, cnt1, B, N, M,
    # cluster, band, gamma, stream
    "mdgat_gap_fwd": [_P] * 11 + [_I] * 5 + [_F, _P],
    # M, cluster, backward, count
    "mdgat_gap_active_clusters": [_I] * 3 + [_P],
    # dense, bin_row, bin_col, gt0, gt1, rm, cm, cnt0, cnt1, ds0, ds1, dd,
    # dbin_row, dbin_col, B, N, M, cluster, band, gamma, stream
    "mdgat_gap_bwd": [_P] * 14 + [_I] * 5 + [_F, _P],
}


def device_scratch(floats: int, device, what: str):
    """A float32 scratch tensor of ``floats`` elements on ``device`` for a
    kernel's wide arm, None for none. Refused with a ``ValueError`` that
    names the plain route when the card's free memory (and what PyTorch's
    allocator holds unused) cannot take it: device memory is the only limit
    of those arms."""
    if not floats:
        return None
    need = 4 * int(floats)
    free, _ = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    if need > free:
        raise ValueError(f"{what}: the kernel needs {need} bytes of device "
                         f"scratch and {free} are free; run this shape with "
                         f"use_kernels=False")
    return torch.empty(int(floats), dtype=torch.float32, device=device)


def _ptr(t):
    """A tensor's device address for a C entry, null for None."""
    return None if t is None else t.data_ptr()


class KernelLibrary:
    """The loaded ``.so`` plus what its build cost (``build_seconds`` is 0
    when an existing build was reused) and the compiler's resource report
    (``ptxas_log``: registers, shared memory and spills per kernel)."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 ptxas_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.ptxas_log = ptxas_log
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mdgat_error_string.argtypes = [_I]
        lib.mdgat_error_string.restype = ctypes.c_char_p

    def call(self, name: str, *args) -> None:
        err = getattr(self.lib, name)(*args)
        if err != 0:
            what = self.lib.mdgat_error_string(err).decode()
            raise RuntimeError(f"{name} failed: {what} (cudaError_t {err})")


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    # torch's lookup: $CUDA_HOME / $CUDA_PATH, then nvcc on PATH, then the
    # toolkit's default install prefix
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(nvcc)


_LOCK = threading.Lock()
_LIBRARY = None


def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process."""
    global _LIBRARY
    with _LOCK:
        if _LIBRARY is None:
            _LIBRARY = _build_and_load()
        return _LIBRARY


def _build_and_load() -> KernelLibrary:
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    tag = h.hexdigest()[:16]
    out = BUILD_DIR / f"libmdgat_kernels_{tag}.so"
    log_path = BUILD_DIR / f"libmdgat_kernels_{tag}.log"
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = [p for p in srcs if p.suffix == ".cu"]
        nvcc = _nvcc()
        t0 = time.perf_counter()
        # private names, then one rename: a process building at the same
        # time never loads a half-written library
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            objs = [os.path.join(work, p.stem + ".o") for p in cu]
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(p), "-o", o],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for p, o in zip(cu, objs)]
            logs = [proc.communicate()[0] for proc in procs]
            log_path.write_text("".join(logs))
            for p, proc, log in zip(cu, procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {p.name}:\n"
                                       + log[-8000:])
            tmp = os.path.join(work, "lib.so")
            link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError("nvcc link failed:\n" + link.stderr[-8000:])
            os.replace(tmp, out)
        seconds = time.perf_counter() - t0
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(ctypes.CDLL(str(out)), out, seconds, log)
