"""Seconds from the process' start to the window: inputs from the seed,
the program's index and warm-up, kernel builds included."""


def read(ctx):
    return ctx["setup_s"]
