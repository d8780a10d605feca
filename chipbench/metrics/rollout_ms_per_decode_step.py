"""Rollout engine: the rollout's milliseconds over the decode steps it ran
in the window (the steps' ``rollout_time`` over the engine's
``decode_steps``): decode, the host replay, refill prefills and all."""


def read(ctx):
    steps = ctx.stats.get("decode_steps", 0)
    if not steps:
        return None
    return 1000.0 * sum(s["rollout_time"] for s in ctx.steps) / steps
