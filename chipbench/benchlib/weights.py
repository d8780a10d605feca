"""Seeded weights of a benchmark configuration, made on the device.

The tree has the port's layout (``{"embed": {"tok"}, "layers": [...],
"final_norm", "lm_head"}``) but is made here, from the seed alone: one
normal stream in float32, drawn in a few large calls of ``CHUNK`` values,
each from a ``torch.Generator`` on the device seeded by the run's weight
seed and the chunk's index. Each matrix takes its run of the stream, scaled
by 1/sqrt(fan_in) (the embedding by 0.02); norm scales are ones. Any one
leaf can be made again alone (:func:`initial_leaf`).

**How response lengths are set.** The weights give the end-of-sequence
token a steady probability at every position, so that response lengths
are close to geometric with the mix's mean. Coordinate 0 of the residual
stream holds a constant ``EOS_C``, written by the embedding only: every
layer's output projections leave it alone (their column 0 is zero) and
every layer's input norms ignore it (scale 0 there). At the final norm it
becomes ``h0 = EOS_C * sqrt(d) / sqrt(EOS_C**2 + r**2)``, where ``r`` is the
norm of the rest of the residual stream, which varies by a few percent
between positions. The unembedding reads coordinate 0 in the EOS column
alone, with the weight ``beta`` that puts the EOS logit ``log(p / (1 - p))``
above the log-sum-exp of the other logits, ``log(V - 1) + 1/2`` for logits
of unit variance; ``p = 1 / response_mean``. The mean of ``h0`` over
positions is measured by ``calibrate_lengths.py`` and kept in the
configuration's file (``eos_design.h0``); ``r`` shrinks as contexts grow,
so a cell whose mix has longer contexts keeps its own, measured at them
(``eos_h0`` in its workload file, which ``spec.load_cell`` puts in the
mix).
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 26          # stream values per generator call (256 MiB f32)
EOS_C = 0.3              # the constant of residual coordinate 0


def leaf_specs(cfg: dict):
    """[(path, shape, kind)] in the port's tree order; ``kind`` is
    "embed", "dense" or "norm". ``cfg`` is a configuration file."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, V = cfg["head_dim"], cfg["vocab_size"]
    out = [(("embed", "tok"), (V, d), "embed")]
    for i in range(cfg["num_hidden_layers"]):
        p = ("layers", i)
        out += [(p + ("ln1",), (d,), "norm"), (p + ("ln2",), (d,), "norm"),
                (p + ("attn", "wq"), (d, H * hd), "dense"),
                (p + ("attn", "wk"), (d, KV * hd), "dense"),
                (p + ("attn", "wv"), (d, KV * hd), "dense"),
                (p + ("attn", "wo"), (H * hd, d), "dense"),
                (p + ("mlp", "wi"), (d, f), "dense"),
                (p + ("mlp", "wg"), (d, f), "dense"),
                (p + ("mlp", "wo"), (f, d), "dense")]
    out.append((("final_norm",), (d,), "norm"))
    if not cfg["tie_word_embeddings"]:
        out.append((("lm_head",), (d, V), "dense"))
    return out


def path_name(path) -> str:
    return ".".join(str(p) for p in path)


def eos_beta(cfg: dict, mix: dict) -> float:
    """The unembedding weight that gives EOS the probability
    1 / response_mean at every position."""
    p = 1.0 / mix["response_mean"]
    target = math.log(p / (1.0 - p)) + math.log(cfg["vocab_size"] - 1) + 0.5
    return target / mix.get("eos_h0", cfg["eos_design"]["h0"])


def _offsets(specs):
    """The start of each random leaf's run in the stream (None for norms),
    and the stream's length."""
    offs, n = [], 0
    for _, shape, kind in specs:
        if kind == "norm":
            offs.append(None)
            continue
        offs.append(n)
        n += math.prod(shape)
    return offs, n


def _chunk(seed: int, c: int, device):
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + c) % (1 << 62))
    return g


def _stream(seed, lo, hi, device, total):
    """Values [lo, hi) of the stream, made chunk by chunk."""
    out = torch.empty(hi - lo, dtype=torch.float32, device=device)
    c = lo // CHUNK
    while c * CHUNK < hi:
        a, b = c * CHUNK, min((c + 1) * CHUNK, total)
        z = torch.randn(b - a, generator=_chunk(seed, c, device),
                        dtype=torch.float32, device=device)
        s, e = max(a, lo), min(b, hi)
        out[s - lo:e - lo] = z[s - a:e - a]
        c += 1
    return out


def _finish(path, t, kind, cfg, beta):
    """Scale a leaf made of normal values and apply the EOS design, in
    place."""
    name = path[-1]
    if kind == "norm":
        t.fill_(1.0)
        if path[0] == "layers":        # layers never read coordinate 0
            t[0] = 0.0
        return t
    if kind == "embed":
        t.mul_(0.02)
        t[:, 0] = EOS_C
        return t
    t.mul_(1.0 / math.sqrt(t.shape[-2]))
    if path[0] == "layers" and name == "wo":
        t[..., 0] = 0.0                # layers never write coordinate 0
    if path == ("lm_head",):
        eos = cfg["eos_token_id"]
        t[0, :] = 0.0
        t[:, eos] = 0.0
        t[0, eos] = beta
    return t


def make_params(cfg: dict, mix: dict, seed: int, device):
    """The whole tree, float32 on ``device``."""
    specs = leaf_specs(cfg)
    offs, total = _offsets(specs)
    beta = eos_beta(cfg, mix)
    flat = [torch.empty(shape, dtype=torch.float32, device=device)
            for _, shape, _ in specs]
    c = 0
    while c * CHUNK < total:
        a, b = c * CHUNK, min((c + 1) * CHUNK, total)
        z = torch.randn(b - a, generator=_chunk(seed, c, device),
                        dtype=torch.float32, device=device)
        for leaf, off in zip(flat, offs):
            if off is None or off >= b or off + leaf.numel() <= a:
                continue
            s, e = max(a, off), min(b, off + leaf.numel())
            leaf.view(-1)[s - off:e - off] = z[s - a:e - a]
        del z
        c += 1
    for (path, _, kind), leaf in zip(specs, flat):
        _finish(path, leaf, kind, cfg, beta)
    return unflatten_paths(specs, flat)


def initial_leaf(cfg: dict, mix: dict, seed: int, device, index: int):
    """Leaf ``index`` (in :func:`leaf_specs` order) as :func:`make_params`
    makes it, made alone."""
    specs = leaf_specs(cfg)
    offs, total = _offsets(specs)
    path, shape, kind = specs[index]
    if kind == "norm":
        t = torch.empty(shape, dtype=torch.float32, device=device)
    else:
        n = math.prod(shape)
        t = _stream(seed, offs[index], offs[index] + n, device,
                    total).view(shape)
    return _finish(path, t, kind, cfg, eos_beta(cfg, mix))


def unflatten_paths(specs, flat):
    """A nested dict/list tree from (path, ...) specs and their leaves."""
    root: dict = {}
    for (path, _, _), leaf in zip(specs, flat):
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(nxt, int):
                node = node.setdefault(key, [])
            elif isinstance(key, int):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, {})
        last = path[-1]
        if isinstance(node, list):
            while len(node) <= last:
                node.append({})
            node[last] = leaf
        else:
            node[last] = leaf
    return root


def get_path(tree, path):
    for key in path:
        tree = tree[key]
    return tree
