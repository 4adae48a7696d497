"""Kernel 2 (``kernels/csrc/splitmax_decode.cu``, paged and fused, every
decode step's attention): the least time of the launches in the traced
span (``counts.py``, from each slot's length there, one launch a layer)
over their device time."""
import counts
from devtrace import kernel_seconds


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    c = ctx["config"]
    h, hkv = c["num_attention_heads"], c["num_key_value_heads"]
    d = c["hidden_size"] // h
    bk = ctx["conf"]["serve"]["block_k"]
    bound = sum(c["num_hidden_layers"]
                * counts.decode_attn_bound_s(x["lens"], h, hkv, d, bk)
                for x in ctx["decodes"]
                if tr["t_start"] <= x["t_in"] < tr["t_stop"])
    dev = kernel_seconds(tr, r"\bdecode_kernel<")
    return 100.0 * bound / dev if bound and dev else None
