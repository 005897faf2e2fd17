"""Read bases taken from reads to SV signatures per second of the window:
every chunk the window ran, over all the time it took."""


def read(ctx):
    if "evidence_bases" not in ctx:
        return None
    return ctx["evidence_bases"] / ctx["window_s"]
