"""Trainer: the rollout's seconds a window step (the step's own
``rollout_time``, a collect timed to its last device work)."""


def read(ctx):
    steps = [s["rollout_time"] for s in ctx.steps if "rollout_time" in s]
    return sum(steps) / len(steps) if steps else None
