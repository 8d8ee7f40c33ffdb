"""table_fills_per_query: the device table cache's fills (a read, encode
and upload of a scan's table, or a restore from the spill pool) in the
traced window, per statement completed in it; 0 while every table the mix
reads stays resident. Layer: device stage (its table cache)."""


def read(w):
    if not w.queries or "table_cache" not in w.counters:
        return None
    return w.counters["table_cache"].get("fills", 0) / len(w.queries)
