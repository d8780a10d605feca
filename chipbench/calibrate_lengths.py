"""Response lengths that a cell's seeded EOS weights give.

    python3 chipbench/calibrate_lengths.py --workload qwen7b.short \
        --seed 1 [--contexts 256] [--device cuda]

Runs the plain reference forward (float32, no kernel of the program) over
``--contexts`` random prompts of the mix's lengths, and prints per
position: ``h0`` (coordinate 0 of the final-norm hidden state, which the
EOS logit reads), the EOS logit, the log-sum-exp of the other logits and
the EOS probability; then the response lengths those probabilities give
(each response draws, token by token, an EOS probability from the measured
ones: mean, p50, p99 and the share that reaches the mix's cap), against a
geometric law of mean ``response_mean`` cut at the cap. ``h0``'s mean is
what the configuration's file keeps as ``eos_design.h0``, or the cell's
workload file as ``eos_h0``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from benchlib import reference as R  # noqa: E402
from benchlib import weights as W  # noqa: E402
from benchlib.spec import load_cell  # noqa: E402
from benchlib.task import SeededTask  # noqa: E402


def lengths_from(p, cap, n, rng):
    """n responses, each token ending it with a probability drawn from
    ``p``; lengths cut at ``cap``."""
    out = np.empty(n, np.int64)
    for i in range(n):
        q = rng.choice(p, size=cap)
        hit = np.nonzero(rng.random(cap) < q)[0]
        out[i] = hit[0] + 1 if hit.size else cap
    return out


def summary(x, cap):
    return {"mean": float(x.mean()), "p50": float(np.percentile(x, 50)),
            "p99": float(np.percentile(x, 99)),
            "cap_share": float((x >= cap).mean())}


def calibrate(cfg, mix, seed, contexts, device):
    params = W.make_params(cfg, mix, seed, device)
    model = R.Model(cfg, params, R.Ops("f32"))
    task = SeededTask(cfg, mix, seed)
    eos = cfg["eos_token_id"]
    h0s, eos_l, lse_o = [], [], []
    with torch.no_grad():
        for _ in range(contexts):
            prompt, _ = task.sample_prompt()
            toks = torch.from_numpy(prompt.astype(np.int64)).to(device)
            h = model.hidden(toks, [(0, len(prompt))], remat=False)
            logits = h @ model.unembed()
            other = torch.cat([logits[:, :eos], logits[:, eos + 1:]], 1)
            h0s.append(h[:, 0].cpu().numpy())
            eos_l.append(logits[:, eos].cpu().numpy())
            lse_o.append(torch.logsumexp(other, 1).cpu().numpy())
    h0, el, lo = (np.concatenate(a) for a in (h0s, eos_l, lse_o))
    p = 1.0 / (1.0 + np.exp(lo - el))
    return h0, el, lo, p


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--contexts", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = load_cell(args.workload)
    cfg, mix = cell.config, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    h0, el, lo, p = calibrate(cfg, mix, args.seed, args.contexts,
                              args.device)
    rng = np.random.default_rng(args.seed)
    cap = mix["response_cap"]
    got = lengths_from(p, cap, 2000, rng)
    geo = np.minimum(rng.geometric(1.0 / mix["response_mean"], 2000), cap)
    out = {
        "workload": args.workload, "seed": args.seed,
        "positions": int(h0.size),
        "h0": {"mean": float(h0.mean()), "std": float(h0.std())},
        "eos_logit": {"mean": float(el.mean()), "std": float(el.std())},
        "lse_other": {"mean": float(lo.mean()), "std": float(lo.std())},
        "p_eos": {"mean": float(p.mean()), "p05": float(np.percentile(p, 5)),
                  "p95": float(np.percentile(p, 95)),
                  "target": 1.0 / mix["response_mean"]},
        "lengths": summary(got, cap), "geometric": summary(geo, cap),
        "h0_in_file": mix.get("eos_h0", cfg["eos_design"]["h0"]),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
