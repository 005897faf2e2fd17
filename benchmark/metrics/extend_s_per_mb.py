"""Thread-seconds of the port's span ``map/extend`` (anchored extension)
per Mb of read bases."""

SPANS = ('map/extend',)


def read(ctx):
    mb = ctx.get("evidence_bases", 0) / 1e6
    s = sum(ctx["spans"].get(n, 0.0) for n in SPANS)
    if not mb or not any(n in ctx["spans"] for n in SPANS):
        return None
    return s / mb
