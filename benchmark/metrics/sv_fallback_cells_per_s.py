"""DP cells of the whole-span NWs of the global fallback (``FILL_STATS``
``fallback_cells``, every band attempt) per second of its span
``align/global_fallback``."""


def read(ctx):
    s = ctx["spans"].get("align/global_fallback", 0.0)
    cells = ctx["fill_stats"].get("fallback_cells")
    if not cells or s <= 0:
        return None
    return cells / s
