"""Build and load the port's CUDA kernels.

Every ``genmmrec_tpu_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
for ``sm_90a``, all of them at once, and the objects are linked into one
shared library with a plain C interface, at first use, and loaded with
``ctypes``. The library lands in ``build/kernels/`` at the
root of the checkout under a name keyed by a hash of the sources and flags,
so a changed source builds anew and an unchanged one is reused.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # per-kernel registers, shared memory and spills
]


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.isfile("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgenmmrec_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float, str]:
    """Compile the kernels if needed: one ``nvcc -c`` per source, started
    together, then one link. Returns (path, seconds, compiler output)."""
    out = library_path()
    if os.path.isfile(out):
        return out, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for obj, proc in jobs:
        log += proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(obj)
    try:
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp, *(obj for obj, _ in jobs)], capture_output=True, text=True
        )
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    finally:
        for obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, log


@functools.cache
def library():
    """The loaded kernel library, with argument types declared."""
    import ctypes

    path, _, _ = build()
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.segment_spmm_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.segment_spmm_f32.restype = i
    lib.segment_spmm_blocked_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
    lib.segment_spmm_blocked_f32.restype = i
    lib.segment_spmm_blocked_chunk.argtypes = []
    lib.segment_spmm_blocked_chunk.restype = i
    for fn in (lib.masked_topk_f32, lib.masked_topk_bf16):
        fn.argtypes = [p, p, i, p, p, i, i, i, p]
        fn.restype = i
    for fn in (lib.candidate_extract_f32, lib.candidate_extract_bf16):
        fn.argtypes = [p, p, p, i, p, p, i, i, i, i, p]
        fn.restype = i
    for fn in (lib.masked_group_max_f32, lib.masked_group_max_bf16):
        fn.argtypes = [p, p, i, p, i, i, p]
        fn.restype = i
    lib.fused_group_max_bf16.argtypes = [p, p, p, p, i, i, i, p]
    lib.fused_group_max_bf16.restype = i
    lib.fused_candidate_plan.argtypes = [p, p, i, i, i, i, p]
    lib.fused_candidate_plan.restype = i
    for fn in (lib.fused_candidates_bf16, lib.fused_candidates_unmasked_bf16):
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
    lib.kernel_error_string.argtypes = [i]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def launch(entry: str, what: str, device, *args) -> None:
    """Call the C entry point ``entry`` of the kernel library on ``args`` and,
    as its last argument, ``device``'s current stream, with ``device``
    current; raise if it reports a CUDA error. The raw stream handle and the
    skipped device switch keep a launch's host time at a few microseconds."""
    lib = library()
    fn = getattr(lib, entry)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
