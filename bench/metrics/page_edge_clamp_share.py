"""Share of the window's decoding ticks whose horizon the page edge
clamped (%): a slot one token short of its mapped pages holds the whole
batch to one step.  From the engine's counters, window close less
opening."""


def read(run):
    c = getattr(run, "counters", None)
    if not c or not c.get("decode_ticks"):
        return None
    return 100.0 * c["clamp_page_edge"] / c["decode_ticks"]
