"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with :mod:`ctypes` (no
PyTorch headers, so a build takes seconds). Libraries land in
``build/repro_torch/`` at the root of the checkout, named by a hash of their
sources and flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing is built when a module is imported: :func:`library` builds on
first use, and :func:`build_all` builds every kernel at once, one ``nvcc``
process per source, all started together.

Kernels are launched from more than one thread (the overlapped trainer's
rollout producer and its consumer), so a first build takes a lock (two
threads building one source would write the same temporary file), and each
wrapper counts its launches through :func:`count`, under a lock, so the
counts stay exact.

The dry run (``launch/dryrun``) runs the steps on fake tensors
(``torch._subclasses.fake_tensor``: shapes, no data). A wrapper given a
fake tensor launches nothing: it returns empty outputs of the kernel's
shapes (its scratch allocated as on the card) and hands the kernel's FLOPs
and device-memory bytes to :func:`charge`, which passes them to every
active cost counter (:func:`cost_sink`, ``launch/op_cost.OpCost``). A
charge is not a launch: the launch counters stay as they are. A wrapper
with no charge refuses a fake tensor (:func:`refuse_fake`).
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
from contextlib import contextmanager
from typing import Callable, Dict, List


CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LL = ctypes.c_longlong
U = ctypes.c_uint

# C entry points and their argument types, per kernel source
KERNELS = {
    "flash_attn": {"flash_attn_fwd":
                   (P, P, P, P, P, I, I, I, I, I, I, I, I, F, F, I, P)},
    "flash_attn_bwd": {"flash_attn_bwd":
                       (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                        F, F, I, P)},
    # q, k_cache, v_cache, cache_len, out, lse (or null), workspace, its
    # float32 count, tickets, B, L, H, KV, hd, start, window, softcap,
    # scale, dtype, stream
    "decode_attn": {"decode_attn_fwd":
                    (P, P, P, P, P, P, P, LL, P, I, I, I, I, I, I, I, F, F,
                     I, P)},
    # q, k_pool, v_pool, block_table, cache_len, out, workspace, its float32
    # count, tickets, B, NP, page_size, max_pages, H, KV, hd, window,
    # softcap, scale, dtype, stream
    "paged_decode_attn": {"paged_decode_attn_fwd":
                          (P, P, P, P, P, P, P, LL, P, I, I, I, I, I, I, I,
                           I, F, F, I, P)},
    # keys, logits, tok, logp, R, V, temperature, top_k, top_p, greedy,
    # blocks per row (cluster), stream; the largest slice (int* out); the
    # clusters resident at once (V, cluster, int* out); the Gumbel draw
    # probe (k0, k1, out, n, K, stream)
    "fused_sample": {
        "fused_sample_rows": (P, P, P, P, I, I, F, I, F, I, I, P),
        "fused_sample_max_slice": (P,),
        "fused_sample_max_clusters": (I, I, P),
        "fused_sample_draw_probe": (U, U, P, I, I, P)},
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
        # the same without h_dtype: bf16 h, on the tensor cores
        "fused_is_grpo_bwd_dh_tc": (P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                    F, P),
        # h, dl, dw, R, d, V, dw_stride_k, dw_stride_v, h_dtype, accumulate,
        # stream
        "fused_is_grpo_bwd_dw": (P, P, P, I, I, I, I, I, I, I, P),
        # h, w, targets, partial, logp, lse, R, d, V, w_stride_k,
        # w_stride_v, h_dtype, splits, softcap, stream
        "fused_logprob_fwd": (P, P, P, P, P, P, I, I, I, I, I, I, I, F, P),
    },
    "ssm_scan": {
        # x, dt, A_log, B, C, D, state, y, B, T, di, N, B's batch and time
        # strides, C's, dtype, prefill_only, stream
        "ssm_scan_fwd":
            (P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P),
        # the same with the backward's boundary states stored (after y):
        # x, dt, A_log, B, C, D, state, y, boundaries, B, T, di, N, strides,
        # dtype, stream
        "ssm_scan_fwd_save":
            (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P),
        # x, dt, A_log, B, C, D, state0, dy, dstate (or null), dx, ddt, the
        # partials of dB/dC, dA_log and dD, dstate0, the chunk-boundary
        # states the forward stored, B, T, di, N, B's batch and time
        # strides, C's, dtype, stream
        "ssm_scan_bwd":
            (P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
             I, I, I, I, P),
        # the backward's chunk length (steps between boundary states); N,
        # dtype and a pointer for its dynamic shared memory (or null)
        "ssm_scan_bwd_chunk": (I, I, P),
        # the channels a block of the backward covers at state size N
        "ssm_scan_bwd_channels": (I,)},
    "wkv6": {
        # r, k, v, w, u, state, y, B, T, H, hd, dtype, prefill_only, stream
        "wkv6_fwd": (P, P, P, P, P, P, P, I, I, I, I, I, I, P),
        # the same with the backward's boundary states stored (after y):
        # r, k, v, w, u, state, y, boundaries, B, T, H, hd, dtype, stream
        "wkv6_fwd_save": (P, P, P, P, P, P, P, P, I, I, I, I, I, P),
        # r, k, v, w, u, state0, dy, dstate (or null), dr, dk, dv, dw, the
        # partials of du, dstate0, the chunk-boundary states the forward
        # stored, B, T, H, hd, dtype, stream
        "wkv6_bwd": (P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I,
                     I, P),
        # the same: hd, dtype and a pointer for the shared memory (or null)
        "wkv6_bwd_chunk": (I, I, P)},
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


_BUILD_LOCK = threading.Lock()    # held while nvcc writes a library
_LIBRARIES: Dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()


def build_all() -> Dict[str, float]:
    """Compile every kernel source in parallel; returns {name: seconds}
    (0.0 for a library that was already built)."""
    with _BUILD_LOCK:
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


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built on first use,
    by one thread at a time), with its C entry points' argument and return
    types declared."""
    lib = _LIBRARIES.get(name)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        if name not in _LIBRARIES:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn_name, argtypes in KERNELS[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIBRARIES[name] = lib
        return _LIBRARIES[name]


def count(fn, *extra: str, key: str = "launches") -> None:
    """Add one launch to the counter ``key`` of wrapper ``fn`` and to each
    counter named in ``extra``. A bare ``+= 1`` is a read and a write, and
    loses counts when two threads launch at once."""
    with _COUNT_LOCK:
        for k in (key,) + extra:
            setattr(fn, k, getattr(fn, k) + 1)


def library_log(name: str) -> str:
    """nvcc's output for the built library of kernel source ``name``: with
    ``-Xptxas -v``, each kernel's registers, spills and shared memory."""
    return _lib_path(name).with_suffix(".log").read_text()


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



# the active cost counters: module state, as the launch counters are, so a
# wrapper called deep inside a step reaches the counter around it
_SINKS: List[Callable[[str, float, float], None]] = []


@contextmanager
def cost_sink(fn: Callable[[str, float, float], None]):
    """``with cost_sink(fn):`` hands every kernel charge of the block to
    ``fn(kernel name, flops, bytes)``."""
    _SINKS.append(fn)
    try:
        yield fn
    finally:
        _SINKS.remove(fn)


def charge(name: str, flops: float, nbytes: float) -> None:
    """One launch of kernel ``name`` on fake tensors, its ``flops`` and
    device-memory bytes ``nbytes``, handed to every active
    :func:`cost_sink`. Counts no launch."""
    for sink in list(_SINKS):
        sink(name, float(flops), float(nbytes))


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (shapes, no data): the dry run's."""
    from torch._subclasses.fake_tensor import is_fake as _is_fake
    return _is_fake(t)


def refuse_fake(name: str, t) -> None:
    """Raise for a fake tensor at a wrapper that charges nothing: a kernel
    that no dry-run step launches, whose plain version must not stand in
    for it."""
    if is_fake(t):
        raise ValueError(
            f"{name}: fake tensors are the dry run's (launch/dryrun), and "
            f"this kernel is on none of its steps (the dense cache, steps "
            f"that return logits)")
