"""Share of the window's DP cells that the card filled (``FILL_STATS``:
device cells over device and host cells), in percent."""


def read(ctx):
    st = ctx["fill_stats"]
    total = st.get("device_cells", 0) + st.get("host_cells", 0)
    if not total:
        return None
    return 100.0 * st["device_cells"] / total
