"""Share of the whole-span NW's cells of the global fallback that the
card filled (``FILL_STATS``: ``fallback_device_cells`` over
``fallback_cells``, every band attempt), in percent; nothing where the
window sent no pair to the NW or the program has no such counter."""


def read(ctx):
    st = ctx["fill_stats"]
    if not st.get("fallback_cells") or "fallback_device_cells" not in st:
        return None
    return 100.0 * st["fallback_device_cells"] / st["fallback_cells"]
