"""Trainer: the longest window step by the step's own ``step_time``."""


def read(ctx):
    steps = [s["step_time"] for s in ctx.steps if "step_time" in s]
    return max(steps) if steps else None
