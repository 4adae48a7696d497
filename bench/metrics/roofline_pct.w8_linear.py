"""The decode step's int8 linears (``kernels/csrc/w8_linear.cu``: every
attention and MLP projection of a layer at a decode step's few rows): the
least time, each decode in the traced span reading its layers' int8
weights once at 3.35 TB/s, over the device time of the kernels named
``w8_linear`` there.  The weights alone are counted, a floor, so the share
cannot pass 100% while those linears run through the kernel.  None where
the kernel never ran (a program without it)."""
import counts
from devtrace import kernel_seconds


def layer_weight_bytes(c) -> int:
    """One layer's int8 linear weights: q, k, v and o, and the SwiGLU's
    three matrices."""
    d, h, hkv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // h
    return d * hd * (h + 2 * hkv) + h * hd * d + 3 * d * c["intermediate_size"]


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    dev = kernel_seconds(tr, r"w8_linear")
    if not dev:
        return None
    c = ctx["config"]
    n = sum(tr["t_start"] <= x["t_in"] < tr["t_stop"] for x in ctx["decodes"])
    bound = n * c["num_hidden_layers"] * layer_weight_bytes(c) / counts.HBM_BW
    return 100.0 * bound / dev if bound else None
