"""The int8 linears' roofline reader (``metrics/roofline_pct.w8_linear.py``):
its bytes worked by hand for the cell's configuration, and None where the
trace holds no ``w8_linear`` kernel (a program without it)."""
import pytest

import bench_tiny  # noqa: F401  (puts bench/ and src/ on the path)
import spec


def _ctx(by_name, n_decodes=3, outside=2):
    bench = spec.load_benchmark()
    conf = spec.load_config(bench, "deepseek-67b-int8")
    tr = {"t_start": 10.0, "t_stop": 20.0, "by_name": by_name}
    decodes = ([{"t_in": 10.0 + i} for i in range(n_decodes)]
               + [{"t_in": 25.0 + i} for i in range(outside)])
    return {"trace": tr, "config": conf["config"], "decodes": decodes}


def test_bytes_by_hand():
    read = spec.metric_reader("roofline_pct.w8_linear")
    # a layer: q 8192 x 8192, k and v 8192 x 1024, o 8192 x 8192, in and
    # gate 8192 x 22016, out 22016 x 8192, one int8 byte a weight
    layer = 8192 * 8192 * 2 + 8192 * 1024 * 2 + 3 * 8192 * 22016
    assert layer == 692_060_160
    bound = 3 * 95 * layer / 3.35e12                   # 3 decodes in the span
    assert bound == pytest.approx(0.0588766, rel=1e-5)
    ctx = _ctx({"void (anonymous namespace)::w8_linear_kernel<2>(int)": 0.06,
                "void (anonymous namespace)::w8_linear_reduce_kernel(int)":
                    0.02,
                "void decode_kernel<true>(int)": 1.0})
    assert read(ctx) == pytest.approx(100 * bound / 0.08)


def test_none_without_the_kernel():
    read = spec.metric_reader("roofline_pct.w8_linear")
    assert read(_ctx({"void decode_kernel<true>(int)": 1.0})) is None
    assert read(_ctx({})) is None
    assert read({"trace": None}) is None
