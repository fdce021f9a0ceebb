"""Milliseconds of the index handle's update calls per acknowledged update:
the benchmark's span around each ``StreamingIndex.insert`` and ``delete``
call, ended by a device synchronisation, over the window."""


def read(ctx):
    lanes = sum(len(u.inserted) + len(u.deleted) for u in ctx.updates)
    if not lanes:
        return None
    return 1e3 * sum(u.seconds for u in ctx.updates) / lanes
