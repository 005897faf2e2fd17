"""Read bases per second of ``select_sv_reads`` + ``extract_signatures``
(host clock around the calls)."""


def read(ctx):
    if not ctx.get("svsig_s"):
        return None
    return ctx["evidence_bases"] / ctx["svsig_s"]
