"""Seconds of the port's span ``cns/overlap_cands`` (overlap seeding and
chaining of every template pair of a consensus round) per Mb of SV read
bases taken in; opened on the caller thread, so wall seconds."""

SPANS = ('cns/overlap_cands',)


def read(ctx):
    mb = ctx.get("cns_bases", 0) / 1e6
    s = sum(ctx["spans"].get(n, 0.0) for n in SPANS)
    if not mb or not any(n in ctx["spans"] for n in SPANS):
        return None
    return s / mb
