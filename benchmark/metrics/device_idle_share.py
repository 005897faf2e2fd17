"""Share of the traced window in which no kernel, copy or memset ran on
the card (1 - busy / window), in percent."""


def read(ctx):
    if "trace" not in ctx:
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
