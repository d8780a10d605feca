"""Trainer: the update's seconds a window step (the step's own
``update_time``: packing, the loss and its backward, AdamW, the publish,
to its last device work)."""


def read(ctx):
    steps = [s["update_time"] for s in ctx.steps if "update_time" in s]
    return sum(steps) / len(steps) if steps else None
