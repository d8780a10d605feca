"""Device: the traced step's model FLOPs (``flops.trajectory_flops`` of
its batch) over the traced window's length at the card's dense bf16
peak."""


def read(ctx):
    if ctx.trace is None or ctx.traced is None or ctx.trace.window_s <= 0:
        return None
    b = ctx.traced["batch"]
    f = sum(ctx.flops.trajectory_flops(ctx.cfg, int(L), int(L - P))
            for L, P in zip(b["total_lens"], b["prompt_lens"]))
    return 100.0 * f / ctx.trace.window_s / ctx.flops.PEAK_BF16_FLOPS
