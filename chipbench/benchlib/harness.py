"""One run of one cell: the program under test driven through whole
CoPRIS training steps, measured, then judged against the reference.

1. A ``repro_torch`` ``CoPRISTrainer`` is built for the cell (sequential,
   ``mode="copris"``, the fused loss, bf16 compute over float32 masters,
   the dense KV cache) on weights made here from the seed and a task that
   makes the mix's prompts.
2. Set-up: the warm-up steps, whole ``step()`` calls, until the partial
   buffer has carried trajectories over once (two steps); the program's
   outputs the reference follows are kept from them.
3. With ``trace``, one more step under ``torch.profiler``, with
   ``record_function`` spans wrapped around the calls into the trainer,
   the rollout engine and the update. Then the window: whole ``step()``
   calls until ``seconds`` have passed, untraced. The outputs of the step
   after the warm-up (the window's first, or the traced one) are kept too.
4. The program's state is freed and the reference follows the warm-up
   steps and the step after them (``reference.follow``); ``check``
   decides ``correct``.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchlib import check, flops, reference
from benchlib import trace as tracemod
from benchlib import weights as W
from benchlib.spec import Cell, benchmark_entries, metric_reader
from benchlib.task import SeededTask

WARMUP_STEPS = 2
SPAN = "chipbench."
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def derive_seeds(seed: int) -> dict:
    s = np.random.SeedSequence(int(seed) % (1 << 64)).generate_state(
        3, dtype=np.uint32)
    return {"weights": int(s[0]) & 0x7FFFFFFF, "task": int(s[1]),
            "trainer": int(s[2]) & 0x7FFFFFFF}


def port_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file: its
    registry entry with the file's sizes."""
    from repro_torch.configs import get_config
    base = get_config(cfg["arch"])
    kw = dict(name=cfg["name"], num_layers=cfg["num_hidden_layers"],
              d_model=cfg["hidden_size"],
              num_heads=cfg["num_attention_heads"],
              num_kv_heads=cfg["num_key_value_heads"],
              head_dim=cfg["head_dim"], d_ff=cfg["intermediate_size"],
              vocab_size=cfg["vocab_size"], rope_theta=cfg["rope_theta"],
              rms_eps=cfg["rms_norm_eps"],
              tie_embeddings=cfg["tie_word_embeddings"],
              dtype=cfg["compute_dtype"], param_dtype="float32")
    return dataclasses.replace(base, **kw)


def build_trainer(cell: Cell, seeds: dict, device):
    from repro_torch.common.config import RolloutConfig, TrainConfig
    from repro_torch.core.copris import CoPRISTrainer
    cfg, mix = cell.config, cell.traffic
    ro = RolloutConfig(
        batch_size=mix["batch_size"], group_size=mix["group_size"],
        max_prompt_len=mix["prompt_len"][1],
        max_response_len=mix["response_cap"], temperature=1.0, top_p=1.0,
        top_k=-1, concurrency=mix["concurrency"], mode="copris",
        decode_chunk=mix["decode_chunk"], kv_backend="dense")
    tc = cell.train
    tcfg = TrainConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                          for k, v in tc.items()},
                       overlap=False, fused_loss=True,
                       seed=seeds["trainer"])
    task = SeededTask(cfg, mix, seeds["task"])
    params = W.make_params(cfg, mix, seeds["weights"], device)
    return CoPRISTrainer(port_config(cfg), ro, tcfg, task,
                         eos_id=cfg["eos_token_id"], params=params,
                         device=device)


def batch_flops(cfg: dict, batch) -> int:
    """Model FLOPs of the trajectories of one trained batch."""
    return sum(flops.trajectory_flops(cfg, int(L), int(L - P))
               for L, P in zip(batch["total_lens"], batch["prompt_lens"]))


def _capture(groups):
    out = []
    for g in groups:
        for t in g.trajectories:
            out.append(dict(prompt=np.asarray(t.prompt_tokens, np.int32),
                            response=np.asarray(t.response_tokens, np.int32),
                            logp=np.asarray(t.behaviour_logps, np.float32),
                            stage=np.asarray(t.stage_ids, np.int32),
                            salt=g.answer))
    return out


def _leaf_norms(tree, specs, scale=1.0):
    return [float(W.get_path(tree, path).detach().float().norm()) * scale
            for path, _, _ in specs]


def _delta_norms(trainer, cell, seeds, specs, device):
    out = []
    with torch.no_grad():
        for i, (path, _, _) in enumerate(specs):
            p0 = W.initial_leaf(cell.config, cell.traffic, seeds["weights"],
                                device, i)
            out.append(float((W.get_path(trainer.params, path).detach()
                              - p0).norm()))
    return out


class _Spans:
    """``record_function`` spans wrapped, at run time, around the calls
    into the program's layers, and the decode work each traced chunk
    needed."""

    def __init__(self, trainer):
        from torch.autograd.profiler import record_function
        self.rf = record_function
        self.on = False
        self.positions = 0          # cached positions the active rows read
        self.rows = 0               # active row-steps
        eng = trainer.engine
        self._wrap(trainer, "_train_step", "update")
        self._wrap(eng, "collect", "collect")
        self._wrap(eng, "step_stage", "engine_step")
        self._wrap(eng, "_prefill_batch", "prefill")
        self._wrap(eng, "_decode_chunk", "decode_chunk",
                   pre=lambda: eng.cache_len.copy(), post=self._decode)

    def _wrap(self, obj, name, span, pre=None, post=None):
        fn = getattr(obj, name)
        rf = self.rf

        def wrapped(*a, **k):
            before = pre() if (pre is not None and self.on) else None
            with rf(SPAN + span):
                out = fn(*a, **k)
            if post is not None and self.on:
                post(before, out)
            return out

        setattr(obj, name, wrapped)

    def _decode(self, cache_len, out):
        was_active = out[2]                             # (D, pool)
        d = np.arange(was_active.shape[0])[:, None]
        pos = (cache_len[None, :].astype(np.int64) + d + 1) * was_active
        self.positions += int(pos.sum())
        self.rows += int(was_active.sum())


def _step_line(kind, out, secs, batch):
    return (f"{kind} step: {secs:.3f} s rollout {out['rollout_time']:.3f} "
            f"update {out['update_time']:.3f} tokens "
            f"{int(batch['total_lens'].sum())} rows {batch['tokens'].shape} "
            f"mean_resp {out['mean_resp_len']:.1f} "
            f"multi_stage {out['multi_stage_trajs']}")


def _lengths_line(resp, cap):
    resp = np.asarray(resp)
    return {"responses": int(resp.size), "mean": float(resp.mean()),
            "p50": float(np.percentile(resp, 50)),
            "p99": float(np.percentile(resp, 99)),
            "cap_share": float((resp >= cap).mean())}


def warm_up(cell: Cell, seeds: dict, device, log=print):
    """Build the trainer and run the warm-up steps. Returns the trainer,
    the batches trained on (for the reference) and the program's numbers:
    each step's loss, the first gradient's and the change's per-leaf
    norms."""
    specs = W.leaf_specs(cell.config)
    trainer = build_trainer(cell, seeds, device)
    b1 = trainer.tcfg.betas[0]
    batches, prog_loss = [], []
    for j in range(WARMUP_STEPS):
        t0 = time.perf_counter()
        out = trainer.step()
        log(_step_line("warm-up", out, time.perf_counter() - t0,
                       trainer.last_batch), file=sys.stderr)
        prog_loss.append(out["pg_loss"])
        batches.append(_capture(trainer.last_groups))
        if j == 0:
            first_grad = _leaf_norms(trainer.opt_state["m"], specs,
                                     1.0 / (1.0 - b1))
    if not any((t["stage"] < WARMUP_STEPS - 1).any() for t in batches[-1]):
        log("warning: no trajectory was carried over during warm-up",
            file=sys.stderr)
    delta = _delta_norms(trainer, cell, seeds, specs, device)
    return trainer, batches, {"loss": prog_loss, "first_grad": first_grad,
                              "delta": delta}


def keep_step(trainer, out, batches, prog):
    """Keep what the reference follows of the step just run."""
    batches.append(_capture(trainer.last_groups))
    prog["loss"].append(out["pg_loss"])


def run(cell: Cell, seed: int, seconds: float, trace: bool, *,
        t_start: float, device="cuda", log=print):
    """Returns the result dict (the last line a run prints)."""
    seeds = derive_seeds(seed)
    cfg, mix = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    trainer, batches, prog = warm_up(cell, seeds, device, log)
    if cuda:
        log(f"set-up peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB", file=sys.stderr)
    spans = _Spans(trainer) if trace else None
    summary = None
    sync()
    setup_s = time.perf_counter() - t_start
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    traced = None
    if trace:
        # one step under the profiler, before the window: the window's
        # steps stay untraced
        spans.on = True
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with spans.rf(SPAN + "step"):
                out = trainer.step()
            sync()
        spans.on = False
        keep_step(trainer, out, batches, prog)
        traced = dict(batch=trainer.last_batch, positions=spans.positions,
                      rows=spans.rows)
        t_tr = time.perf_counter()
        summary = tracemod.from_profiler(prof, SPAN, "step")
        del prof
        log(f"traced step {out['step_time']:.3f} s, reduced in "
            f"{time.perf_counter() - t_tr:.1f} s; " + "; ".join(
                f"{k} {v:.4f}" for k, v in sorted(
                    summary.by_kernel.items(), key=lambda kv: -kv[1])[:12]),
            file=sys.stderr)
        if cuda:
            torch.cuda.reset_peak_memory_stats()

    stats0 = trainer.engine.stats_snapshot()
    outs = []
    t_win = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        out = trainer.step()
        t1 = time.perf_counter()
        outs.append(dict(out=out, batch=trainer.last_batch))
        if len(batches) == WARMUP_STEPS:
            keep_step(trainer, out, batches, prog)
        log(_step_line("window", out, t1 - t0, trainer.last_batch),
            file=sys.stderr)
        if t1 - t_win >= seconds:
            break
    window_s = t1 - t_win
    stats1 = trainer.engine.stats_snapshot()
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    # --- end-to-end metrics -------------------------------------------
    tokens = sum(int(o["batch"]["total_lens"].sum()) for o in outs)
    model_flops = sum(batch_flops(cfg, o["batch"]) for o in outs)
    resp = np.concatenate([o["batch"]["total_lens"] - o["batch"]["prompt_lens"]
                           for o in outs])
    lengths = _lengths_line(resp, mix["response_cap"])
    log("lengths " + " ".join(f"{k}={v}" for k, v in lengths.items()),
        file=sys.stderr)
    e2e = {"train_tok_per_s": tokens / window_s,
           "step_s": window_s / len(outs),
           "mfu": 100.0 * model_flops / window_s / flops.PEAK_BF16_FLOPS,
           "setup_s": setup_s}
    ctx = SimpleNamespace(
        cfg=cfg, mix=mix, steps=[o["out"] for o in outs], window_s=window_s,
        stats={k: stats1.get(k, 0) - stats0.get(k, 0)
               for k in stats1 if isinstance(stats1[k], (int, float))},
        trace=summary, traced=traced, peak_window=peak_window, flops=flops)
    e2e_spec, layer_spec = benchmark_entries(cell.root)
    if trace:
        metrics = {}
        for m in layer_spec:
            read = metric_reader(m["name"], cell.root)
            val = None if read is None else read(ctx)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in e2e_spec}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(max(peak_setup, peak_window)),
    }
    if trace:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
    attempted = sum(len(o["batch"]["total_lens"]) for o in outs)
    failed = sum(int(o["out"].get("env_failures", 0))
                 + int(o["out"].get("env_timeouts", 0)) for o in outs)

    # --- the program's state freed, the reference follows ----------------
    trainer.close()
    del trainer, outs, spans, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference.follow(cfg, mix, cell.train, seeds["weights"], batches,
                           device, delta_after=WARMUP_STEPS)
    nums, info = check.numbers(prog, ref)
    correct, checks = check.judge(nums, cell.limits)
    log(f"reference followed {len(batches)} steps in "
        f"{time.perf_counter() - t_ref:.1f} s; " + " ".join(
            f"{k}={v}" for k, v in info.items()), file=sys.stderr)
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    return result


def forbidden_modules():
    """Top-level names of loaded modules that no run may load."""
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def fmt_checks(checks) -> list:
    return [f"check {n}: {c['value']!r} limit {c['limit']!r}"
            for n, c in checks.items()]
