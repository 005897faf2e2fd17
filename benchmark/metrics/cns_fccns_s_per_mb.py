"""Seconds of the port's span ``cns/finish`` (the fccns consensus DP of
every template, on the host) per Mb of SV read bases taken in; opened on
the caller thread, so wall seconds."""

SPANS = ('cns/finish',)


def read(ctx):
    mb = ctx.get("cns_bases", 0) / 1e6
    s = sum(ctx["spans"].get(n, 0.0) for n in SPANS)
    if not mb or not any(n in ctx["spans"] for n in SPANS):
        return None
    return s / mb
