"""Weight interchange: the JAX package's parameter pytree -> the port's
parameter dict.

The caller hands over the tree as numpy arrays — ``jax.device_get(params)``
of ``repro.models.model.init_params``, or ``repro.checkpoint.ckpt.load(path,
to_device=False)`` — so this module needs no JAX. The tree holds
``embed.tok`` (V, d), ``stack.prefix`` (a list of per-layer dicts),
``stack.body`` (one dict per ``block_pattern`` entry, every leaf stacked on a
leading repeats axis: the ``lax.scan`` layout), ``final_norm`` and, for
untied embeddings, ``lm_head``. The port's stack is the flat per-layer list
in execution order: prefix layers, then for each repeat r the pattern's
layers at index r.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.models.transformer import ATTN_KINDS


def _tensor(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(node, device, index=None):
    if isinstance(node, dict):
        return {k: _tree(v, device, index) for k, v in node.items()}
    a = np.asarray(node)
    return _tensor(a if index is None else a[index], device)


def params_from_jax(tree, cfg: ModelConfig, device=None):
    """JAX ``init_params`` pytree (numpy leaves) -> the port's parameters, in
    the tree's own dtype (float32 master weights), on ``device``."""
    dev = resolve_device(device)
    for kind in tuple(cfg.prefix_pattern) + tuple(cfg.block_pattern):
        if kind not in ATTN_KINDS:
            raise NotImplementedError(
                f"block kind {kind!r} is not ported yet")
    stack = tree["stack"]
    layers = [_tree(p, dev) for p in stack["prefix"]]
    body = list(stack["body"])
    if len(body) != len(cfg.block_pattern):
        raise ValueError(f"stack.body has {len(body)} pattern entries, "
                         f"config has {len(cfg.block_pattern)}")
    for r in range(cfg.num_repeats):
        for j in range(len(cfg.block_pattern)):
            layers.append(_tree(body[j], dev, index=r))
    params = {"embed": {"tok": _tensor(tree["embed"]["tok"], dev)},
              "layers": layers,
              "final_norm": _tensor(tree["final_norm"], dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _tensor(tree["lm_head"], dev)
    return params
