"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with :mod:`ctypes` (no
PyTorch headers, so a build takes seconds). Libraries land in
``build/repro_torch/`` at the root of the checkout, named by a hash of their
sources and flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing is built when a module is imported: :func:`library` builds on
first use, and :func:`build_all` builds every kernel at once, one ``nvcc``
process per source, all started together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C entry points and their argument types, per kernel source
KERNELS = {
    "flash_attn": {"flash_attn_fwd":
                   (P, P, P, P, P, I, I, I, I, I, I, I, I, F, F, I, P)},
    "flash_attn_bwd": {"flash_attn_bwd":
                       (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                        F, F, I, P)},
    "decode_attn": {"decode_attn_fwd":
                    (P, P, P, P, P, I, I, I, I, I, I, F, F, I, P)},
    # q, k_pool, v_pool, block_table, cache_len, out, B, NP, page_size,
    # max_pages, H, KV, hd, window, softcap, scale, dtype, stream
    "paged_decode_attn": {"paged_decode_attn_fwd":
                          (P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, F, I,
                           P)},
    "fused_sample": {"fused_sample_rows":
                     (P, P, P, P, I, I, F, I, F, I, P)},
    "fused_is_grpo": {
        # h, w, targets, behaviour, adv, partial, loss, ratio, logp, lse,
        # ent, R, d, V, w_stride_k, w_stride_v, h_dtype, splits, softcap,
        # clip_low, clip_high, use_is, log_cap, entropy_coef, stream
        "fused_is_grpo_fwd": (P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                              I, I, F, F, F, I, F, F, P),
        # h, w, targets, lse, ebar, a, e, dl, dh, R, d, V, w_stride_k,
        # w_stride_v, h_dtype, softcap, stream
        "fused_is_grpo_bwd_dh": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                 F, P),
        # h, dl, dw, R, d, V, dw_stride_k, dw_stride_v, h_dtype, accumulate,
        # stream
        "fused_is_grpo_bwd_dw": (P, P, P, I, I, I, I, I, I, I, P),
        # h, w, targets, partial, logp, lse, R, d, V, w_stride_k,
        # w_stride_v, h_dtype, splits, softcap, stream
        "fused_logprob_fwd": (P, P, P, P, P, P, I, I, I, I, I, I, I, F, P),
    },
    # x, dt, A_log, B, C, D, state, y, B, T, di, N, B's batch and time
    # strides, C's, dtype, stream
    "ssm_scan": {"ssm_scan_fwd":
                 (P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P)},
    # r, k, v, w, u, state, y, B, T, H, hd, dtype, stream
    "wkv6": {"wkv6_fwd": (P, P, P, P, P, P, P, I, I, I, I, I, P)},
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    # kept beside the library: -Xptxas -v reports registers, spills, smem
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)       # atomic: a concurrent build never sees half a file


def build_all() -> Dict[str, float]:
    """Compile every kernel source in parallel; returns {name: seconds}
    (0.0 for a library that was already built)."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in KERNELS}
    secs = {name: 0.0 for name, job in jobs.items() if job is None}
    running = {name: job for name, job in jobs.items() if job is not None}
    while running:
        for name, job in list(running.items()):
            if job[0].poll() is not None:
                _finish(name, job)
                secs[name] = time.perf_counter() - t0
                del running[name]
        time.sleep(0.05)
    return secs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built on first use),
    with its C entry points' argument and return types declared."""
    job = _start(name)
    if job is not None:
        _finish(name, job)
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn_name, argtypes in KERNELS[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library of kernel source ``name``
    (what the card runs: ``HGMMA`` lines are wgmma)."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err}")


def forward_only(what: str, *tensors) -> None:
    """Raise where autograd would need the gradient of a forward-only kernel
    (grad enabled and an input that requires it): its result would carry no
    ``grad_fn``, and training would silently see a zero gradient. The scan
    kernels of the hymba and rwkv6 blocks are forward only, as the Pallas
    kernels they replace are."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: the CUDA kernel is forward only; training the hymba "
            "and rwkv6 families on the GPU needs the backward scan kernels "
            "(selective scan and WKV6), which are not ported yet")
