"""Share of the edge slots shipped in the window that hold a real edge:
Pack's edge layouts (``SchedulerStats.edges_shipped`` over
``edge_slots_shipped``, read at the window's open and close). A batch's
slots follow its largest subgraph, so the rest is the other subgraphs'
padding. None where the program ships no edge layout or has no such
counters."""


def snapshot(system):
    st = system.engine.scheduler.stats
    if not hasattr(st, "edge_slots_shipped"):
        return None
    return {"edges": st.edges_shipped, "slots": st.edge_slots_shipped}


def read(rec):
    a, b = rec.before.get("edge_fill_pct"), rec.after.get("edge_fill_pct")
    if a is None or b is None:
        return None
    slots = b["slots"] - a["slots"]
    return 100.0 * (b["edges"] - a["edges"]) / slots if slots > 0 else None
