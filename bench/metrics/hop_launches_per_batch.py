"""Launches of the fused hop kernels (the ``beam_hop*`` launch counters of
``repro_torch.kernels.ops.launch_counts``) per query batch of the window:
the super-steps a batch takes."""


def read(ctx):
    recs = [r for r in ctx.queries if r["phase"] == "window"
            and r["launches"] is not None]
    keys = {k for r in recs for k in r["launches"] if k.startswith("beam_hop")}
    if not recs or not keys:
        return None
    total = sum(v for r in recs for k, v in r["launches"].items()
                if k in keys)
    return total / len(recs)
