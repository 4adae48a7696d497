"""Engine decode (``PagedKVEngine.decode`` -> ``decode_step``): the median
time from a decode's call to its tokens on the host."""
from measure import median


def read(ctx):
    m = median([d["t_arr"] - d["t_in"] for d in ctx["decodes"]])
    return None if m is None else m * 1e3
