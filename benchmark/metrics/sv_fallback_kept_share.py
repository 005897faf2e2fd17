"""Share of the whole-span NWs of the global fallback whose answer
replaced the anchored alignment (``FILL_STATS``: ``fallback_kept`` over
``fallback_fills``), in percent."""


def read(ctx):
    st = ctx["fill_stats"]
    if not st.get("fallback_fills"):
        return None
    return 100.0 * st.get("fallback_kept", 0) / st["fallback_fills"]
