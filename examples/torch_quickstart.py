"""Quickstart of the PyTorch port: build a model, run forward / prefill /
decode, take one GRPO step with cross-stage IS correction. Runs on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.common.config import TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.tree import leaves
from repro_torch.configs import get_smoke_config
from repro_torch.core.copris import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import adam

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
dev = resolve_device(ap.parse_args().device)

# 1. any assigned architecture is a config away (full or reduced)
cfg = get_smoke_config("gemma2-2b")
print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
      f"pattern={cfg.block_pattern} device={dev}")

params = M.init_params(cfg, seed=0, device=dev)

# 2. full-sequence forward (training view)
g = torch.Generator().manual_seed(1)
tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                       dtype=torch.int32).to(dev)
with torch.no_grad():
    logits = M.forward_train(params, cfg, tokens)
print("train logits:", tuple(logits.shape))

# 3. serving view: prefill a ragged batch, then decode
with torch.no_grad():
    cache = M.init_cache(cfg, 2, 64, device=dev)
    lengths = torch.tensor([16, 10], dtype=torch.int32, device=dev)
    next_logits, cache = M.prefill(params, cfg, tokens, lengths, cache)
    tok = next_logits.argmax(-1).int()
    for i in range(4):
        next_logits, cache = M.decode_step(params, cfg, tok, cache,
                                           lengths + i)
        tok = next_logits.argmax(-1).int()
print("decoded 4 tokens:", tok.tolist())

# 4. one GRPO step with cross-stage importance sampling (params and AdamW
#    state are updated in place)
step = make_train_step(cfg, TrainConfig(lr=1e-4, remat=False))
mask = torch.ones(2, 16, device=dev)
mask[:, :4] = 0.0
batch = {
    "tokens": tokens,
    "loss_mask": mask,
    # plausible behaviour logps (≈ current policy ± noise) so ratios are O(1)
    "behaviour_logp": -torch.log(torch.tensor(float(cfg.vocab_size)))
    + 0.1 * torch.randn(2, 16, generator=g).to(dev),
    "advantages": torch.tensor([1.0, -1.0], device=dev),
}
for p in leaves(params):        # the masters the update differentiates
    p.requires_grad_(True)
params, opt, metrics = step(params, adam.init(params), batch, 1e-4)
print({k: float(v) for k, v in metrics.items() if k in
       ("pg_loss", "ratio_mean", "clip_frac", "grad_norm")})
print("quickstart OK")
