"""Rollout engine: the share of the window's prefilled tokens that
re-prefilled a resumed partial trajectory from its start (engine counters
``reprefill_tokens`` / ``prefill_tokens``): what the partial rollout pays
again for ending a stage early."""


def read(ctx):
    if "reprefill_tokens" not in ctx.stats or not ctx.stats.get(
            "prefill_tokens"):
        return None
    return 100.0 * ctx.stats["reprefill_tokens"] / ctx.stats["prefill_tokens"]
