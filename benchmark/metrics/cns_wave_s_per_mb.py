"""Thread-seconds of the port's span ``cns/align_wave`` (overlap
alignments on the card) per Mb of SV read bases taken in."""

SPANS = ('cns/align_wave',)


def read(ctx):
    mb = ctx.get("cns_bases", 0) / 1e6
    s = sum(ctx["spans"].get(n, 0.0) for n in SPANS)
    if not mb or not any(n in ctx["spans"] for n in SPANS):
        return None
    return s / mb
