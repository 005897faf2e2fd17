"""Seconds of the port's span ``svr/realign`` (one SV span's realignment
in SV-read selection: host pair chains and anchors, anchored extension,
whole-span NW fallback) per Mb of read bases; opened on the caller
thread, so wall seconds."""

SPANS = ('svr/realign',)


def read(ctx):
    mb = ctx.get("evidence_bases", 0) / 1e6
    s = sum(ctx["spans"].get(n, 0.0) for n in SPANS)
    if not mb or not any(n in ctx["spans"] for n in SPANS):
        return None
    return s / mb
