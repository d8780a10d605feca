"""Kernels: the decode attention's share of its roofline in the traced step.

The bytes are those the step's decode needed (``flops.decode_attn_bytes``:
K and V of every cached position each active row read, at every decode
step of every chunk, in every layer); the time is the device time of the
``decode_kernel`` launches in the trace. Its bound is the card's memory
bandwidth."""

KERNELS = ("decode_kernel",)


def read(ctx):
    if ctx.trace is None or ctx.traced is None or not ctx.traced["rows"]:
        return None
    secs = ctx.trace.kernel_seconds(KERNELS)
    if secs <= 0:
        return None
    need = ctx.flops.decode_attn_bytes(ctx.cfg, ctx.traced["positions"],
                                       ctx.traced["rows"])
    return 100.0 * need / ctx.flops.PEAK_HBM_BYTES / secs
