"""Bases of the SV reads that both consensus rounds took in, per second
of the window, over every whole call."""


def read(ctx):
    if "cns_bases" not in ctx:
        return None
    return ctx["cns_bases"] / ctx["window_s"]
