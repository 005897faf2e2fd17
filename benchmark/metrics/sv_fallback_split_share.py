"""Share of the card's whole-span NW cells of the global fallback whose
lanes ``fill_block`` split over a thread-block cluster of several CTAs
(``FILL_STATS``: ``fallback_split_cells`` over ``fallback_device_cells``,
every band attempt), in percent; nothing where the card filled no NW cell
in the window or the program has no such counter."""


def read(ctx):
    st = ctx["fill_stats"]
    if not st.get("fallback_device_cells") or "fallback_split_cells" not in st:
        return None
    return 100.0 * st["fallback_split_cells"] / st["fallback_device_cells"]
