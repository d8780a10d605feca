"""The plain reference of a benchmark cell: the model, the IS-GRPO loss and
AdamW in float32 PyTorch (TF32 off), with no kernel, cache or padding.

It imports nothing of the program. It makes the initial weights itself
(``weights.make_params``, from the same seed as the run), takes the
trajectories the program's rollout produced (prompt, response tokens, the
behaviour log-prob the sampler recorded for each token and the policy
version that sampled it), computes every reward, advantage, log-prob, loss,
gradient and update again, and follows the program's first steps:

* at each version j it scores every response token that version j sampled
  (in the step-j batch and in the partials that later batches resumed), so
  the recorded behaviour log-probs of the rollout (prefill and decode
  through the cache, the sampler) are judged at the version that made them;
* it computes step j's loss over the step-j batch, split into the
  program's microbatches (rows in the batch's order, each microbatch its
  own token mean, the mean over microbatches), its gradient, the global
  norm clip and the AdamW update, giving version j + 1.

Layers are run over blocks of whole trajectories (a token budget per
block); attention runs per trajectory, causal, in blocks of queries; the
unembedding and the loss run only at response positions, in row chunks
recomputed in the backward (``torch.utils.checkpoint``).

``mode="fp8"`` is the control: the same computation with both operands of
every matrix product (the projections, the MLP, the unembedding, q, k, v
and the attention probabilities) rounded to float8 e4m3 with a per-tensor
scale, the gradient passed straight through the rounding.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchlib import weights as W
from benchlib.task import reward_of

Q_CHUNK = 1024          # queries per attention block
ROW_CHUNK = 2048        # response rows per unembedding chunk
TOKEN_BUDGET = 12288    # tokens per block of trajectories


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        amax = t.detach().abs().amax().clamp_min(1e-30)
        s = 448.0 / amax
        return (t * s).to(torch.float8_e4m3fn).to(t.dtype) / s

    @staticmethod
    def backward(ctx, g):
        return g


class Ops:
    """The reference's arithmetic in one precision."""

    def __init__(self, mode: str):
        if mode not in ("f32", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    def q(self, t):
        return _RoundFP8.apply(t) if self.mode == "fp8" else t

    def mm(self, a, w):
        return self.q(a) @ self.q(w)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x (n, heads, hd), pos (n,): the llama convention (halves rotated)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    inv = torch.tensor(inv, dtype=torch.float32, device=x.device)
    ang = pos[:, None].float() * inv
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(ops, q, k, v):
    """Causal attention of one sequence: q (L, H, hd), k/v (L, KV, hd)."""
    L, H, hd = q.shape
    rep = H // k.shape[1]
    k = ops.q(k.repeat_interleave(rep, dim=1))
    v = ops.q(v.repeat_interleave(rep, dim=1))
    q = ops.q(q)
    outs = []
    for a in range(0, L, Q_CHUNK):
        b = min(L, a + Q_CHUNK)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * hd ** -0.5
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = torch.arange(b, device=q.device)[None]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        p = ops.q(torch.softmax(s, dim=-1))
        outs.append(torch.einsum("hqk,khd->qhd", p, v[:b]))
    return torch.cat(outs)


class Model:
    """The configuration's forward over a block of whole trajectories."""

    def __init__(self, cfg: dict, params, ops: Ops):
        self.cfg, self.p, self.ops = cfg, params, ops
        self.H, self.KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.hd, self.eps = cfg["head_dim"], cfg["rms_norm_eps"]

    def _layer(self, lp, x, pos, segs):
        ops = self.ops
        n = x.shape[0]
        h = rms_norm(x, lp["ln1"], self.eps)
        a = lp["attn"]
        q = rope(ops.mm(h, a["wq"]).view(n, self.H, self.hd), pos,
                 self.cfg["rope_theta"])
        k = rope(ops.mm(h, a["wk"]).view(n, self.KV, self.hd), pos,
                 self.cfg["rope_theta"])
        v = ops.mm(h, a["wv"]).view(n, self.KV, self.hd)
        o = torch.cat([attention(ops, q[s:s + L], k[s:s + L], v[s:s + L])
                       for s, L in segs]).reshape(n, self.H * self.hd)
        x = x + ops.mm(o, a["wo"])
        h2 = rms_norm(x, lp["ln2"], self.eps)
        m = lp["mlp"]
        g = F.silu(ops.mm(h2, m["wg"])) * ops.mm(h2, m["wi"])
        return x + ops.mm(g, m["wo"])

    def hidden(self, tokens, segs, *, remat: bool):
        """Final-norm hidden states (n, d) of concatenated trajectories;
        ``segs`` [(start, length)]."""
        pos = torch.cat([torch.arange(L, device=tokens.device)
                         for _, L in segs])
        x = self.p["embed"]["tok"][tokens]
        for lp in self.p["layers"]:
            if remat:
                x = checkpoint(self._layer, lp, x, pos, segs,
                               use_reentrant=False)
            else:
                x = self._layer(lp, x, pos, segs)
        return rms_norm(x, self.p["final_norm"], self.eps)

    def unembed(self):
        p = self.p
        return p["embed"]["tok"].T if self.cfg["tie_word_embeddings"] \
            else p["lm_head"]

    def token_logp(self, h, targets):
        """log p(targets) of rows h (r, d), float32."""
        logits = self.ops.mm(h, self.unembed())
        return logits.gather(1, targets[:, None])[:, 0] \
            - torch.logsumexp(logits, dim=-1)


def per_token_loss(logp, behaviour, adv, tc: dict):
    """The clipped cross-stage IS objective of each token, negated."""
    cap = math.log(tc["is_ratio_cap"])
    lr_ = torch.clamp(logp - behaviour, -cap, cap)
    ratio = torch.exp(lr_)
    clipped = torch.clamp(ratio, 1.0 - tc["clip_low"], 1.0 + tc["clip_high"])
    return -torch.minimum(ratio * adv, clipped * adv)


def advantages(rewards: np.ndarray, group: int):
    r = torch.tensor(rewards, dtype=torch.float32).reshape(-1, group)
    mean = r.mean(1, keepdim=True)
    std = r.std(1, keepdim=True, correction=0)
    return ((r - mean) / (std + 1e-6)).reshape(-1)


def _blocks(trajs, budget=TOKEN_BUDGET):
    out, cur, n = [], [], 0
    for i, t in enumerate(trajs):
        L = len(t["prompt"]) + len(t["response"])
        if cur and n + L > budget:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += L
    if cur:
        out.append(cur)
    return out


def _block_inputs(trajs, idx, device):
    toks, segs, rows, tgts, s = [], [], [], [], 0
    for i in idx:
        t = trajs[i]
        full = np.concatenate([t["prompt"], t["response"]]).astype(np.int64)
        P, L = len(t["prompt"]), len(full)
        toks.append(full)
        segs.append((s, L))
        # the row predicting response token j sits at position P - 1 + j
        rows.append(s + np.arange(P - 1, L - 1))
        tgts.append(full[P:])
        s += L
    cat = lambda xs: torch.from_numpy(np.concatenate(xs)).to(device)  # noqa
    return cat(toks), segs, cat(rows), cat(tgts)


def score(model, trajs, idx, device, *, loss_args=None):
    """Response-token log-probs of trajectories ``idx`` (a list of numpy
    arrays, in order), and with ``loss_args = (weights, adv, tc)`` the
    backward of sum(weight * per-token loss) and that sum."""
    toks, segs, rows, tgts = _block_inputs(trajs, idx, device)
    grad = loss_args is not None
    with torch.set_grad_enabled(grad):
        h = model.hidden(toks, segs, remat=grad)[rows]
        parts, loss = [], torch.zeros((), device=device)
        if grad:
            wts, adv, tc = loss_args
            beh = torch.from_numpy(np.concatenate(
                [trajs[i]["logp"] for i in idx])).to(device)

            def chunk(hc, tg, bc, ac, wc):
                lp = model.token_logp(hc, tg)
                return lp, (per_token_loss(lp, bc, ac, tc) * wc).sum()

            for a in range(0, h.shape[0], ROW_CHUNK):
                b = min(h.shape[0], a + ROW_CHUNK)
                lp, lc = checkpoint(chunk, h[a:b], tgts[a:b], beh[a:b],
                                    adv[a:b], wts[a:b], use_reentrant=False)
                parts.append(lp.detach())
                loss = loss + lc
            loss.backward()
        else:
            for a in range(0, h.shape[0], ROW_CHUNK):
                b = min(h.shape[0], a + ROW_CHUNK)
                parts.append(model.token_logp(h[a:b], tgts[a:b]))
    lp = torch.cat(parts).cpu().numpy()
    out, s = [], 0
    for i in idx:
        R = len(trajs[i]["response"])
        out.append(lp[s:s + R])
        s += R
    return out, float(loss.detach())


def follow(cfg: dict, mix: dict, tc: dict, weight_seed: int, batches,
           device, *, delta_after: int, mode: str = "f32"):
    """Follow the program's first ``len(batches)`` steps. ``batches[j]``:
    the step-j batch, a list of trajectories (dicts of numpy arrays
    ``prompt``, ``response``, ``logp``, ``stage`` and the group's
    ``salt``), in the batch's order. Returns a dict with each step's loss,
    the per-leaf norms of the first (clipped) gradient, of each leaf's
    change after the first ``delta_after`` steps, of each leaf's first raw
    gradient, every
    response token's log-prob at the version that sampled it (``logps``, in
    the batches' order) and its gap to the recorded behaviour log-prob."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _follow(cfg, mix, tc, weight_seed, batches, device,
                       delta_after, mode)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _follow(cfg, mix, tc, weight_seed, batches, device, delta_after, mode):
    specs = W.leaf_specs(cfg)
    params = W.make_params(cfg, mix, weight_seed, device)
    flat = [W.get_path(params, path) for path, _, _ in specs]
    names = [W.path_name(path) for path, _, _ in specs]
    for p in flat:
        p.requires_grad_(True)
    model = Model(cfg, params, Ops(mode))
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    b1, b2 = tc["betas"]
    gaps = [[None] * len(b) for b in batches]
    losses, first_grad, first_raw, delta_norms = [], None, None, None
    G = mix["group_size"]
    for j, batch in enumerate(batches):
        # behaviour of version j's tokens in the partials later batches
        # resumed: scored at version j, no gradient
        for jj in range(j + 1, len(batches)):
            later = batches[jj]
            idx = [i for i, t in enumerate(later) if (t["stage"] == j).any()]
            for blk in _blocks([later[i] for i in idx]):
                sel = [idx[i] for i in blk]
                lps, _ = score(model, later, sel, device)
                for i, lp in zip(sel, lps):
                    _gap(gaps[jj], i, later[i], lp, j)
        # step j: loss and gradient over its batch, microbatch by microbatch
        N, k = len(batch), tc["microbatches"]
        n = N // k
        rewards = np.array([reward_of(t["response"], t["salt"])
                            for t in batch], np.float32)
        adv_row = advantages(rewards, G)
        wts_row = np.zeros(N, np.float64)
        for mb in range(k):
            rows = range(mb * n, (mb + 1) * n)
            denom = max(1, sum(len(batch[i]["response"]) for i in rows))
            for i in rows:
                wts_row[i] = 1.0 / (k * denom)
        total = 0.0
        for blk in _blocks(batch):
            Rs = [len(batch[i]["response"]) for i in blk]
            adv = torch.cat([adv_row[i].expand(R) for i, R in zip(blk, Rs)])
            wts = torch.tensor(np.repeat(wts_row[blk], Rs), dtype=torch.float32)
            lps, lsum = score(model, batch, blk, device,
                              loss_args=(wts.to(device), adv.to(device), tc))
            total += lsum
            for i, lp in zip(blk, lps):
                _gap(gaps[j], i, batch[i], lp, j)
        losses.append(total)
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in flat]
            gn = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(tc["grad_clip"] / torch.clamp(gn, min=1e-9),
                                max=1.0) if tc["grad_clip"] > 0 else 1.0
            if j == 0:
                first_raw = [float(g.norm()) for g in grads]
                first_grad = [float((g * scale).norm()) for g in grads]
            t = j + 1
            lr = tc["lr"] * min(1.0, (j + 1) / max(tc["warmup_steps"], 1))
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            for p, g, mm_, vv in zip(flat, grads, m, v):
                g = g * scale
                mm_.mul_(b1).add_((1.0 - b1) * g)
                vv.mul_(b2).add_((1.0 - b2) * g.square())
                delta = (mm_ / bc1) / (torch.sqrt(vv / bc2) + tc["eps"])
                delta = delta + tc["weight_decay"] * p
                p.sub_(lr * delta)
                p.grad = None
            if t == delta_after:
                delta_norms = []
                for i, p in enumerate(flat):
                    p0 = W.initial_leaf(cfg, mix, weight_seed, device, i)
                    delta_norms.append(float((p - p0).norm()))
                    del p0
    del params, flat, m, v, model
    ref_lp = np.concatenate([g for b in gaps for g in b])
    beh = np.concatenate([t["logp"].astype(np.float64)
                          for b in batches for t in b])
    return dict(names=names, loss=losses, first_grad=first_grad,
                first_raw=first_raw, delta=delta_norms, logps=ref_lp,
                logp_gaps=np.abs(ref_lp - beh))


def _gap(store, i, traj, lp, version):
    """Keep the log-probs of the tokens that ``version`` sampled in
    trajectory i (NaN where no version has scored a token yet)."""
    if store[i] is None:
        store[i] = np.full(len(traj["response"]), np.nan, np.float64)
    sel = traj["stage"] == version
    store[i][sel] = lp[sel].astype(np.float64)
