"""Rollout engine: the share of the positions the window's prefills
computed that were padding (engine counters ``prefill_positions``, the
rows times the bucketed length of each batched prefill, and
``prefill_tokens``): rows padded to the longest row, row counts to a power
of two."""


def read(ctx):
    positions = ctx.stats.get("prefill_positions", 0)
    if not positions:
        return None
    return 100.0 * (positions - ctx.stats["prefill_tokens"]) / positions
