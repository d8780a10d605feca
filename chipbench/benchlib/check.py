"""The numbers that decide ``correct``, each against its limit.

* ``loss_gap``: the largest |program loss - reference loss| over the
  steps followed (the GRPO loss as the program reports it, ``pg_loss``).
* ``grad_gap``: the first gradient as the optimizer got it (the program's
  from its AdamW first moment after step 1, m / (1 - beta1)), by the worst
  leaf: |program norm - reference norm| over the larger of the reference's
  norm of that leaf and of the median leaf.
* ``delta_gap``: the same for each leaf's change from the initial weights
  after the steps followed.
* ``logp_gap``: the mean over every response token of the followed steps of
  |reference log-prob - behaviour log-prob the program's sampler recorded|,
  the reference scoring each token at the policy version that sampled it.
* ``logp_gap_p99``: the 99th percentile of the same gaps, so that a fault
  in a few of the slots, which the mean spreads thin, still shows.

The steps followed are the warm-up steps and the step after them (the
window's first, or the traced step in a traced run); ``delta_gap`` is
taken after the warm-up steps.

Leaves whose first gradient in the reference is under a thousandth of the
median leaf's are left out of ``grad_gap`` and ``delta_gap`` (Adam moves
them by round-off alone); none is at the configurations' sizes.
"""
from __future__ import annotations

import math

import numpy as np

NAMES = ("loss_gap", "grad_gap", "delta_gap", "logp_gap", "logp_gap_p99")


def leaf_gap(prog, ref, keep):
    ref = np.asarray(ref, np.float64)
    prog = np.asarray(prog, np.float64)
    med = float(np.median(ref[keep])) if keep.any() else 0.0
    den = np.maximum(ref, med)
    g = np.abs(prog - ref) / np.where(den > 0, den, 1.0)
    return float(g[keep].max()) if keep.any() else 0.0


def numbers(prog: dict, ref: dict) -> dict:
    """``prog``: ``loss`` (per step), ``first_grad`` and ``delta`` (per
    leaf, in the reference's order). ``ref``: :func:`reference.follow`'s
    result."""
    raw = np.asarray(ref["first_raw"], np.float64)
    keep = raw >= 1e-3 * float(np.median(raw))
    gaps = ref["logp_gaps"]
    finite = gaps[np.isfinite(gaps)]
    out = {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["loss"],
                                                    ref["loss"])),
        "grad_gap": leaf_gap(prog["first_grad"], ref["first_grad"], keep),
        "delta_gap": leaf_gap(prog["delta"], ref["delta"], keep),
        "logp_gap": float(finite.mean()) if finite.size else math.inf,
        "logp_gap_p99": (float(np.percentile(finite, 99)) if finite.size
                         else math.inf),
    }
    if finite.size != gaps.size:          # a token the reference never saw
        out["logp_gap"] = out["logp_gap_p99"] = math.inf
    info = {
        "logp_gap_max": float(finite.max()) if finite.size else math.inf,
        "tokens_compared": int(finite.size),
        "leaves_left_out": int((~keep).sum()),
        "loss_program": list(prog["loss"]),
        "loss_reference": list(ref["loss"]),
    }
    return out, info


def judge(nums: dict, limits: dict):
    """(correct, {name: {"value", "limit"}})."""
    checks = {n: {"value": nums[n], "limit": limits[n]} for n in NAMES}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
