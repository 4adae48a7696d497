"""Engine admission (``PagedKVEngine.admit`` -> ``prefill_paged``): the
median time from an admission's call to its first token on the host (the
scheduler reads it there, so the span is synchronised)."""
from measure import median


def read(ctx):
    m = median([a["t_arr"] - a["t_in"] for a in ctx["admits"]])
    return None if m is None else m * 1e3
