"""Milliseconds of the update engine's write phase per acknowledged update:
the change of ``repro_torch.core.batched.PHASE_SECONDS["write"]`` over the
window (the program's own clock, read at synchronised phase boundaries)."""


def read(ctx):
    lanes = sum(len(u.inserted) + len(u.deleted) for u in ctx.updates)
    if not lanes or ctx.write_s is None:
        return None
    return 1e3 * ctx.write_s / lanes
