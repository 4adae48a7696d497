"""Kernel 1 (``kernels/csrc/splitmax_attn.cu``, every prefill's attention):
the least time of the launches in the traced span (``counts.py``, from the
prompts admitted there, one launch a layer) over their device time."""
import counts
from devtrace import kernel_seconds


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    c = ctx["config"]
    h, hkv = c["num_attention_heads"], c["num_key_value_heads"]
    d = c["hidden_size"] // h
    bound = sum(c["num_hidden_layers"]
                * counts.prefill_attn_bound_s(h, hkv, a["prompt_len"], d)
                for a in ctx["admits"]
                if tr["t_start"] <= a["t_in"] < tr["t_stop"])
    dev = kernel_seconds(tr, r"splitmax_attn_kernel")
    return 100.0 * bound / dev if bound and dev else None
