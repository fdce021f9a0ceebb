"""Mean hops (beam expansions) a query of the window took: the sum of
``SearchResult.n_hops`` over the window's query batches, over the queries."""


def read(ctx):
    recs = [r for r in ctx.queries if r["phase"] == "window"
            and r["hops"] is not None]
    n = sum(r["n"] for r in recs)
    if not n:
        return None
    return sum(r["hops"] for r in recs) / n
