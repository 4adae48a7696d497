"""The whole step's share of the bf16 peak: useful model FLOPs of the
prompts prefilled and the tokens decoded in the traced span (``counts.py``:
two per active parameter, head included, and the attention's two products
at each token's context), over the span's seconds times 989 TFLOP/s.  A
MoE model's dispatch over idle expert slots is not useful work.  The span,
not the whole window: the profiler's stop, which reads the trace, stalls
the host inside the window."""
import counts


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    c = ctx["config"]
    inside = lambda x: tr["t_start"] <= x["t_in"] < tr["t_stop"]  # noqa: E731
    flops = sum(counts.prompt_flops(c, a["prompt_len"])
                for a in ctx["admits"] if inside(a))
    flops += sum(counts.token_flops(c, n) for d in ctx["decodes"]
                 if inside(d) for n in d["live"])
    if not flops:
        return None
    return 100.0 * flops / (tr["window_s"] * counts.PEAK_FLOPS_BF16)
