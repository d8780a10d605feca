"""Fused top-k / top-p sampling: wrapper of the hand-written CUDA kernel
``csrc/fused_sample.cu`` (the port of the Pallas ``fused_sample`` TPU kernel).

On a CPU tensor the wrapper runs the plain PyTorch version,
:func:`sample_rows_plain` (= ``sampling.sampler.sample_rows``); on a CUDA
tensor it launches the kernel or raises. The kernel runs one cluster of C
blocks of 1024 threads per row (:func:`cluster_size`), each block keeping
its slice of ceil(V / C) tempered logits in shared memory; a vocabulary
whose slices do not fit raises. Greedy (temperature <= 0) is the kernel's
argmax mode.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.hopper import build
from repro_torch.sampling.sampler import sample_rows as sample_rows_plain

# blocks per row (a thread-block cluster) tried, largest first: a launch
# takes the largest cluster whose R clusters the card runs at once (a second
# wave costs a whole kernel's time), else the smallest that fits;
# chip_smoke.py --ab sweeps them
CLUSTERS = (16, 8, 7, 6, 4, 2, 1)


def _check(keys, logits, top_p):
    if logits.dim() != 2 or keys.shape != (logits.shape[0], 2):
        raise ValueError(f"sample_rows: want keys (R, 2), logits (R, V); got "
                         f"{tuple(keys.shape)}, {tuple(logits.shape)}")
    if keys.dtype != torch.uint32 or logits.dtype != torch.float32:
        raise TypeError(f"sample_rows: want uint32 keys and float32 logits; "
                        f"got {keys.dtype}, {logits.dtype}")
    if keys.device != logits.device:
        raise ValueError("sample_rows: keys and logits on different devices")
    if not top_p > 0.0:
        raise ValueError(f"sample_rows: top_p must be > 0, got {top_p}")


def _index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None \
        else device.index


@functools.cache
def _max_slice(index: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = build.library("fused_sample").fused_sample_max_slice(
            ctypes.byref(out))
    build.check(err, "fused_sample_max_slice")
    return out.value


@functools.cache
def _max_clusters(index: int, V: int, cluster: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = build.library("fused_sample").fused_sample_max_clusters(
            V, cluster, ctypes.byref(out))
    build.check(err, "fused_sample_max_clusters")
    return out.value


def max_vocab(device, cluster: int = CLUSTERS[0]) -> int:
    """The largest vocabulary the kernel samples on CUDA ``device`` with
    ``cluster`` blocks per row: as many slices, each at most the shared
    memory a block can opt into, less the kernel's own."""
    return cluster * _max_slice(_index(device))


def max_clusters(device, V: int, cluster: int) -> int:
    """How many rows of V logits, ``cluster`` blocks each, the card samples
    at once (cudaOccupancyMaxActiveClusters; 0 if a slice does not fit)."""
    return _max_clusters(_index(device), V, cluster)


@functools.cache
def _cluster_size(index: int, R: int, V: int) -> int:
    fits = [C for C in CLUSTERS if _max_clusters(index, V, C) > 0]
    if not fits:
        raise ValueError(
            f"sample_rows kernel: a vocabulary of {V} does not fit in the "
            f"shared memory of {CLUSTERS[0]} blocks (at most "
            f"{CLUSTERS[0] * _max_slice(index)} logits)")
    one_wave = [C for C in fits if _max_clusters(index, V, C) >= R]
    return one_wave[0] if one_wave else fits[-1]


def cluster_size(device, R: int, V: int, greedy: bool = False) -> int:
    """The blocks per row of a launch over R rows of V logits (greedy keeps
    no slice in shared memory)."""
    return _cluster_size(_index(device), R, 0 if greedy else V)


def launch(keys, logits, *, temperature, top_p, top_k, cluster):
    """One kernel launch with ``cluster`` blocks per row (contiguous CUDA
    tensors, checked by :func:`sample_rows`); counts nothing. Returns
    ``(tokens, logps)``."""
    R, V = logits.shape
    greedy = temperature <= 0.0
    limit = max_vocab(logits.device, cluster)
    if not greedy and V > limit:
        raise ValueError(
            f"sample_rows kernel: a vocabulary of {V} does not fit in the "
            f"shared memory of {cluster} blocks (at most {limit} logits)")
    tok = torch.empty(R, dtype=torch.int32, device=logits.device)
    logp = torch.empty(R, dtype=torch.float32, device=logits.device)
    lib = build.library("fused_sample")
    with torch.cuda.device(logits.device):
        err = lib.fused_sample_rows(
            keys.data_ptr(), logits.data_ptr(), tok.data_ptr(),
            logp.data_ptr(), R, V, float(temperature), int(top_k),
            float(top_p), int(greedy), cluster,
            torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(err, "fused_sample_rows")
    return tok, logp


def sample_rows(keys, logits, *, temperature: float = 1.0, top_p: float = 1.0,
                top_k: int = -1):
    """keys: (R, 2) uint32 raw threefry keys, one per row; logits: (R, V)
    float32. Returns ``(tokens (R,) int32, logps (R,) float32)``, the logp
    under the tempered, truncated distribution (0 for greedy)."""
    _check(keys, logits, top_p)
    build.refuse_fake("sample_rows", logits)
    if logits.device.type == "cpu":
        return sample_rows_plain(keys, logits, temperature=temperature,
                                 top_p=top_p, top_k=top_k)
    if logits.device.type != "cuda":
        raise ValueError(f"sample_rows: unsupported device {logits.device}")
    if not (keys.is_contiguous() and logits.is_contiguous()):
        raise ValueError("sample_rows kernel needs contiguous keys and logits")
    R, V = logits.shape
    out = launch(keys, logits, temperature=temperature, top_p=top_p,
                 top_k=top_k,
                 cluster=cluster_size(logits.device, R, V, temperature <= 0))
    build.count(sample_rows)
    return out


sample_rows.launches = 0
