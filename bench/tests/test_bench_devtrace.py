"""The device trace's arithmetic: busy time as the union of device
intervals, idle gaps labelled by the harness span the host was in, kernel
time by name."""
import bench_tiny  # noqa: F401  (puts bench/ and src/ on the path)
import devtrace


def test_summary_by_hand():
    ms = 1_000_000
    dev = [(0, 2 * ms, "void decode_kernel<true>(int)"),
           (1 * ms, 3 * ms, "ampere_gemm"),
           (5 * ms, 6 * ms, "void splitmax_attn_kernel<4>(int)"),
           (10 * ms, 11 * ms, "void decode_kernel<true>(int)")]
    host = [(3 * ms, 5 * ms, "admit"), (9 * ms, 10 * ms, "decode")]
    s = devtrace.summarize(dev, host, 0.012, 1.0, 1.012)
    assert abs(s["busy_s"] - 0.005) < 1e-12
    assert abs(devtrace.kernel_seconds(s, r"\bdecode_kernel<") - 0.003) < 1e-12
    assert abs(devtrace.kernel_seconds(s, "splitmax_attn_kernel") - 0.001) < 1e-12
    (g1, s1), (g2, s2) = s["idle_gaps"]
    assert g1.startswith("scheduler") and abs(s1 - 0.004) < 1e-12
    assert g2.startswith("admit") and abs(s2 - 0.002) < 1e-12
    assert s["device_ops"][0] == ["void decode_kernel<true>", 0.003]
