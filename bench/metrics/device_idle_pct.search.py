"""Share of the traced stretch of a search-paced cell in which no operation
ran on the device: ``1 - (union of kernel, copy and set intervals) /
stretch``, from the ``torch.profiler`` trace."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_pct()
