"""Read bases per second of ``mapper.map_all`` (host clock around the
calls)."""


def read(ctx):
    if not ctx.get("map_s"):
        return None
    return ctx["evidence_bases"] / ctx["map_s"]
