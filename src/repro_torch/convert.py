"""Weight interchange between the JAX package's parameter pytree and the
port's parameter dict, both ways, and the same for the AdamW state.

The caller hands over the tree as numpy arrays — ``jax.device_get(params)``
of ``repro.models.model.init_params``, or ``repro.checkpoint.ckpt.load(path,
to_device=False)`` — so this module needs no JAX. The tree holds
``embed.tok`` (V, d) (and the VLM's ``embed.media_proj`` (d_media, d)),
``stack.prefix`` (a list of per-layer dicts, nested for the recurrent and
MoE kinds: hymba's ``ssm``, rwkv's ``tm`` and ``cm``, the MoE's ``moe``
with its float32 ``router``, (E, d, f) expert stacks and ``shared`` block;
xattn's ``xattn`` with its ``gate``, and its scalar ``mlp_gate``),
``stack.body`` (one dict per ``block_pattern`` entry, every leaf stacked on a
leading repeats axis: the ``lax.scan`` layout), ``final_norm`` and, for
untied embeddings, ``lm_head``. The port's stack is the flat per-layer list
in execution order: prefix layers, then for each repeat r the pattern's
layers at index r. :func:`params_to_jax` and :func:`opt_state_to_jax` go
back to the JAX layout (numpy leaves, ``stack.body`` a tuple), so a
checkpoint written by the port loads into the JAX trainer and a JAX
checkpoint resumes in the port (:func:`opt_state_from_jax`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device


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
    stack = tree["stack"]
    layers = [_tree(p, dev) for p in stack["prefix"]]
    body = list(stack["body"])
    if len(body) != len(cfg.block_pattern):
        raise ValueError(f"stack.body has {len(body)} pattern entries, "
                         f"config has {len(cfg.block_pattern)}")
    for r in range(cfg.num_repeats):
        for j in range(len(cfg.block_pattern)):
            layers.append(_tree(body[j], dev, index=r))
    params = {"embed": _tree(tree["embed"], dev),
              "layers": layers,
              "final_norm": _tensor(tree["final_norm"], dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _tensor(tree["lm_head"], dev)
    return params


def _numpy(t):
    return t.detach().cpu().numpy().copy()


def params_to_jax(params, cfg: ModelConfig):
    """The port's parameters -> the JAX ``init_params`` pytree layout, with
    numpy leaves (``stack.body`` leaves stacked on a leading repeats
    axis)."""
    layers = params["layers"]
    n_pre = len(cfg.prefix_pattern)
    P = len(cfg.block_pattern)

    def to_np(node):
        if isinstance(node, dict):
            return {k: to_np(v) for k, v in node.items()}
        return _numpy(node)

    def stacked(nodes):
        if isinstance(nodes[0], dict):
            return {k: stacked([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack([_numpy(n) for n in nodes])

    body = tuple(stacked([layers[n_pre + r * P + j]
                          for r in range(cfg.num_repeats)])
                 for j in range(P))
    tree = {"embed": to_np(params["embed"]),
            "stack": {"prefix": [to_np(p) for p in layers[:n_pre]],
                      "body": body},
            "final_norm": _numpy(params["final_norm"])}
    if "lm_head" in params:
        tree["lm_head"] = _numpy(params["lm_head"])
    return tree


def opt_state_from_jax(tree, cfg: ModelConfig, device=None):
    """JAX ``adam.init``/``adam.update`` state ``{"m", "v", "step"}`` (numpy
    leaves) -> the port's AdamW state on ``device``."""
    dev = resolve_device(device)
    return {"m": params_from_jax(tree["m"], cfg, dev),
            "v": params_from_jax(tree["v"], cfg, dev),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=dev)}


def opt_state_to_jax(state, cfg: ModelConfig):
    """The port's AdamW state -> the JAX layout with numpy leaves."""
    return {"m": params_to_jax(state["m"], cfg),
            "v": params_to_jax(state["v"], cfg),
            "step": np.asarray(int(state["step"]), np.int32)}

