"""The frozen operation and byte counts, against values worked out by
hand for one shape."""
import pytest

import json

import bench_tiny  # noqa: F401  (puts bench/ and src/ on the path)

import counts
import spec


def _moe_config():
    """The MoE configuration kept for a later cell (no entry yet)."""
    return json.loads((bench_tiny.BENCH / "configs" / "deepseek-moe-16b.json")
                      .read_text())["config"]


def test_prefill_bound_by_hand():
    # 64/8 heads of 128, a 1024-token prompt
    pairs = 64 * 1024 * 1025 // 2                      # 33,587,200
    ops = pairs * 4 * 128                              # 17,196,646,400
    n_bytes = (64 * 1024 * 128 + 2 * 8 * 1024 * 128 + 4 * 64 * 1024 * 128
               + 4 * 512)                              # 44,042,240
    assert ops == 17_196_646_400 and n_bytes == 44_042_240
    want = max(n_bytes / 3.35e12, ops / 1979e12)       # bytes: 13.147 us
    assert counts.prefill_attn_bound_s(64, 8, 1024, 128) == pytest.approx(want)
    assert want == pytest.approx(13.1469e-6, rel=1e-4)


def test_decode_bound_by_hand():
    lens = [300, 33, 1]
    # q and out f32 (3 slots x 64 heads x 128), K and V int8 at 334
    # positions, 10 + 2 + 1 table entries, lengths and two scales a slot
    n_bytes = 4 * 3 * 64 * 128 * 2 + 2 * 8 * 128 * 334 + 4 * 13 + 4 * 9 + 2048
    assert n_bytes == 882_776
    got = counts.decode_attn_bound_s(lens, 64, 8, 128, 32)
    assert got == pytest.approx(n_bytes / 3.35e12)


def test_active_params_by_hand():
    bench = spec.load_benchmark()
    dense = spec.load_config(bench, "deepseek-67b-int8")["config"]
    per_layer = 8192 * 8192 * 2 + 8192 * 1024 * 2 + 3 * 8192 * 22016
    assert counts.active_params(dense) == 95 * per_layer + 8192 * 102400
    assert counts.active_params(dense) == 66_584_576_000
    moe = _moe_config()
    attn = 4 * 2048 * 2048
    moe_layer = 2048 * 64 + 3 * 2048 * 1408 * (6 + 2)
    want = 28 * attn + 3 * 2048 * 10944 + 27 * moe_layer + 2048 * 102400
    assert counts.active_params(moe) == want == 2_618_818_560


def test_token_and_prompt_flops():
    c = _moe_config()
    n = counts.active_params(c)
    assert counts.token_flops(c, 10) == 2 * n + 4 * 28 * 16 * 128 * 10
    assert counts.prompt_flops(c, 3) == pytest.approx(
        sum(counts.token_flops(c, i + 1) for i in range(3)))
