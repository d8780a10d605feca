"""Kernels: the fused IS-GRPO loss's share of its roofline in the traced
step.

The operations are the loss's forward, dh and dw at the rows it trains
(the response tokens of the step's batch: ``flops.loss_kernel_flops``),
at the card's dense bf16 peak; the time is the device time of the loss's
kernels in the trace (forward partials and their combine, dl, dh, dw)."""

KERNELS = ("fwd_partial_tc", "fwd_combine_kernel", "bwd_dl_tc", "bwd_dh_tc",
           "bwd_dw_tc", "fwd_partial_kernel", "bwd_dl_kernel", "gemm_kernel")


def read(ctx):
    if ctx.trace is None or ctx.traced is None:
        return None
    secs = ctx.trace.kernel_seconds(KERNELS)
    if secs <= 0:
        return None
    rows = int(ctx.traced["batch"]["loss_mask"].sum())
    need = ctx.flops.loss_kernel_flops(ctx.cfg, rows)
    return 100.0 * need / ctx.flops.PEAK_BF16_FLOPS / secs
