"""Seconds of the port's spans ``svsig/align`` (batched realignment of
every SV read: chaining and fills, whole-span NW fallback) and
``svsig/repair`` (host split-gap DP) in signature extraction, per Mb of
read bases; opened on the caller thread, so wall seconds."""

SPANS = ('svsig/align', 'svsig/repair')


def read(ctx):
    mb = ctx.get("evidence_bases", 0) / 1e6
    s = sum(ctx["spans"].get(n, 0.0) for n in SPANS)
    if not mb or not any(n in ctx["spans"] for n in SPANS):
        return None
    return s / mb
