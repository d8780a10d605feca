"""Fused top-k / top-p sampling: wrapper of the hand-written CUDA kernel
``csrc/fused_sample.cu`` (the port of the Pallas ``fused_sample`` TPU kernel).

On a CPU tensor the wrapper runs the plain PyTorch version,
:func:`sample_rows_plain` (= ``sampling.sampler.sample_rows``); on a CUDA
tensor it launches the kernel or raises. Greedy (temperature <= 0) is the
kernel's argmax mode.
"""
from __future__ import annotations

import torch

from repro_torch.hopper import build
from repro_torch.sampling.sampler import sample_rows as sample_rows_plain


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


def sample_rows(keys, logits, *, temperature: float = 1.0, top_p: float = 1.0,
                top_k: int = -1):
    """keys: (R, 2) uint32 raw threefry keys, one per row; logits: (R, V)
    float32. Returns ``(tokens (R,) int32, logps (R,) float32)``, the logp
    under the tempered, truncated distribution (0 for greedy)."""
    _check(keys, logits, top_p)
    if logits.device.type == "cpu":
        return sample_rows_plain(keys, logits, temperature=temperature,
                                 top_p=top_p, top_k=top_k)
    if logits.device.type != "cuda":
        raise ValueError(f"sample_rows: unsupported device {logits.device}")
    if not (keys.is_contiguous() and logits.is_contiguous()):
        raise ValueError("sample_rows kernel needs contiguous keys and logits")
    R, V = logits.shape
    tok = torch.empty(R, dtype=torch.int32, device=logits.device)
    logp = torch.empty(R, dtype=torch.float32, device=logits.device)
    lib = build.library("fused_sample")
    with torch.cuda.device(logits.device):
        err = lib.fused_sample_rows(
            keys.data_ptr(), logits.data_ptr(), tok.data_ptr(),
            logp.data_ptr(), R, V, float(temperature), int(top_k),
            float(top_p), int(temperature <= 0.0),
            torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(err, "fused_sample_rows")
    sample_rows.launches += 1
    return tok, logp


sample_rows.launches = 0
