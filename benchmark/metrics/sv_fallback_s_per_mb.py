"""Seconds of the port's span ``align/global_fallback`` (the host
whole-span NW, a part of ``svr/realign`` and ``svsig/align``) per Mb of
read bases; opened on the caller thread, so wall seconds."""

SPANS = ('align/global_fallback',)


def read(ctx):
    mb = ctx.get("evidence_bases", 0) / 1e6
    s = sum(ctx["spans"].get(n, 0.0) for n in SPANS)
    if not mb or not any(n in ctx["spans"] for n in SPANS):
        return None
    return s / mb
