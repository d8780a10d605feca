"""Batched serving on the PyTorch port with the typed submit()/step() API
across architecture families (dense / SSM / MoE / hybrid), smoke-sized.
Demonstrates the incremental loop external callers own: submit requests,
step the engine one decode chunk at a time, stream a partial response
mid-flight, and late-submit while earlier requests are still decoding.
Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_serve_batch.py
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.launch.serve import GenerateRequest, make_serve_engine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
device = ap.parse_args().device

for arch in ("llama3.2-1b", "rwkv6-1.6b", "deepseek-moe-16b", "hymba-1.5b"):
    print(f"\n=== serving {arch} (smoke) ===")
    serve, cfg = make_serve_engine(arch, smoke=True, max_tokens=16,
                                   concurrency=3, device=device)
    rng = np.random.default_rng(0)
    rids = [serve.submit(GenerateRequest(prompt=rng.integers(
        0, cfg.vocab_size, 8))) for _ in range(4)]
    steps = 0
    while serve.pending:
        for r in serve.step():
            print(f"  req {r.request_id}: {len(r.tokens)} tokens "
                  f"({r.finish_reason})")
        steps += 1
        if steps == 1:                 # stream a partial, late-submit more
            partial = serve.peek(rids[-1])
            if partial is not None:
                print(f"  req {rids[-1]} streaming: {partial}")
            rids += [serve.submit(GenerateRequest(prompt=rng.integers(
                0, cfg.vocab_size, 8))) for _ in range(2)]
    stats = serve.close()
    print(f"  {len(rids)} requests in {steps} engine steps, "
          f"utilization {stats['utilization']:.2f}")
