"""Seconds of SV-read selection and signature extraction outside their
realignments, per Mb of read bases: the spans ``svr/select`` +
``svsig/extract`` less ``svr/realign``, ``svsig/align`` and
``svsig/repair`` (classification, effective identity, the signature scan,
sequence extraction).  All are opened on the caller thread, so these are
wall seconds and they subtract."""

STAGES = ('svr/select', 'svsig/extract')
PARTS = ('svr/realign', 'svsig/align', 'svsig/repair')


def read(ctx):
    mb = ctx.get("evidence_bases", 0) / 1e6
    spans = ctx["spans"]
    if not mb or not all(n in spans for n in STAGES):
        return None
    s = sum(spans[n] for n in STAGES) - sum(spans.get(n, 0.0)
                                            for n in PARTS)
    return s / mb
