"""Device: the most device memory the allocator held during the window
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(ctx):
    if not ctx.peak_window:
        return None
    return ctx.peak_window / 2 ** 30
