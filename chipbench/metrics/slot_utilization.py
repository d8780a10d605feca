"""Rollout engine: the share of slot-steps that decoded a live trajectory
over the window (engine counters ``active_slot_steps`` / ``slot_steps``)."""


def read(ctx):
    slots = ctx.stats.get("slot_steps", 0)
    if not slots:
        return None
    return 100.0 * ctx.stats.get("active_slot_steps", 0) / slots
