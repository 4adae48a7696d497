"""The int8-weight linear kernel's CPU side (``kernels/w8_linear.py``): its
plain version against today's ``layers.linear_apply`` bit for bit, the
route ``linear_apply`` takes (a pure function of what a call can observe,
fed fake tensors for the card), the split of K as a function of (K, N)
alone, and the paths that keep the dequant (``dequantized``, the
tokenwise verify) unchanged.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""
import functools
from types import SimpleNamespace

import pytest
import torch

from repro_torch.core import quantization as qlib
from repro_torch.kernels import w8_linear
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def _int8(k, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    w_q, w_s = qlib.quantize_weight(torch.randn((k, n), generator=gen))
    return {"w_q": w_q, "w_s": w_s}


def _old_linear(params, x, dtype):
    """``linear_apply``'s int8 path as it was: dequant, then ``x @ w``."""
    return x.to(dtype) @ L.linear_weight(params, dtype).to(dtype)


@pytest.mark.parametrize("shape", [(1, 64, 32), (3, 1, 128), (16, 1, 256),
                                   (2, 5, 48)])
def test_plain_version_equals_linear_apply_bit_for_bit(shape):
    b, s, k = shape
    p = _int8(k, 80, seed=k)
    x = torch.randn((b, s, k), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    got = w8_linear.w8_linear_plain(x.reshape(-1, k), p["w_q"], p["w_s"])
    want = L.linear_apply(p, x, dtype=torch.bfloat16)
    assert torch.equal(got.reshape(b, s, 80), want)
    assert torch.equal(want, _old_linear(p, x, torch.bfloat16))


def _fake(shape, dtype, cuda=True):
    """What the route reads of a tensor: device, dtype, shape, numel, dim."""
    n = 1
    for d in shape:
        n *= d
    return SimpleNamespace(is_cuda=cuda, dtype=dtype, shape=torch.Size(shape),
                           numel=lambda: n, dim=lambda: len(shape))


def _fake_params(k=8192, n=1024, scale=(1, 1), cuda=True):
    return {"w_q": _fake((k, n), torch.int8, cuda),
            "w_s": _fake(scale, torch.float32, cuda)}


@pytest.mark.parametrize("case,takes", [
    ("cuda bf16, 16 rows", True),
    ("cuda bf16, the cutoff's rows", True),
    ("cuda bf16, one row", True),
    ("cpu", False),
    ("weight on cpu", False),
    ("f32", False),
    ("no dtype", False),
    ("rows above the cutoff", False),
    ("prefill rows", False),
    ("mesh bound", False),
    ("scale per column", False),
    ("k not a multiple of 16", False),
    ("a float weight", False),
])
def test_route_takes_the_kernel_only_where_specified(monkeypatch, case,
                                                     takes):
    bound = object()
    p, dt = _fake_params(), torch.bfloat16
    x = _fake((16, 1, 8192), torch.bfloat16)
    if case == "cuda bf16, the cutoff's rows":
        x = _fake((L.W8_ROWS, 8192), torch.bfloat16)
    elif case == "cuda bf16, one row":
        x = _fake((1, 1, 8192), torch.bfloat16)
    elif case == "cpu":
        p, x = _fake_params(cuda=False), _fake((16, 1, 8192), dt, cuda=False)
    elif case == "weight on cpu":
        p = _fake_params(cuda=False)
    elif case == "f32":
        dt = torch.float32
    elif case == "no dtype":
        dt = None
    elif case == "rows above the cutoff":
        x = _fake((L.W8_ROWS + 1, 8192), torch.bfloat16)
    elif case == "prefill rows":
        x = _fake((1, 1024, 8192), torch.bfloat16)
    elif case == "mesh bound":
        monkeypatch.setattr(L, "current_axis_rules", lambda: bound)
    elif case == "scale per column":
        p = _fake_params(scale=(1, 1024))
    elif case == "k not a multiple of 16":
        p, x = _fake_params(k=8200), _fake((16, 1, 8200), torch.bfloat16)
    elif case == "a float weight":
        p = {"w": _fake((8192, 1024), torch.bfloat16)}
    assert L.w8_kernel_takes(p, x, dt) is takes


def _launch_recorder(monkeypatch, calls):
    """``w8_linear.launch`` replaced by the plain version (the kernel's
    function), each call's arguments kept in ``calls``."""
    def launch(x, w_q, w_s):
        calls.append((x, w_q, w_s))
        return w8_linear.w8_linear_plain(x, w_q, w_s)
    monkeypatch.setattr(L.w8_linear, "launch", launch)


def test_linear_apply_calls_the_kernel_where_the_route_says(monkeypatch):
    """Where the route is taken, ``linear_apply`` hands the int8 weight to
    the kernel's launcher (the plain version here, on the CPU) and writes
    no dequantized weight (no ``linear_weight`` call)."""
    p = _int8(64, 48)
    x = torch.randn((4, 1, 64), generator=torch.Generator().manual_seed(2)
                    ).to(torch.bfloat16)
    want = L.linear_apply(p, x, dtype=torch.bfloat16)
    calls = []
    monkeypatch.setattr(L, "w8_kernel_takes", lambda *a: True)
    _launch_recorder(monkeypatch, calls)
    monkeypatch.setattr(L, "linear_weight", None)
    got = L.linear_apply(p, x, dtype=torch.bfloat16)
    assert len(calls) == 1 and calls[0][1] is p["w_q"]
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,n,rows,splits", [
    (8192, 8192, 2048, 4), (8192, 1024, 256, 32), (8192, 22016, 4096, 2),
    (22016, 8192, 5504, 4), (2048, 5632, 384, 6), (64, 16, 64, 1),
    (4096, 16384, 2048, 2), (80, 32, 128, 1)])
def test_split_of_k_is_a_function_of_k_and_n(k, n, rows, splits):
    got = w8_linear.split_rows(k, n)
    assert got == rows and got % 64 == 0 and -(-k // got) == splits
    assert (splits - 1) * got < k <= splits * got


def test_cuda_wrapper_refuses_cpu_tensors():
    p = _int8(64, 32)
    x = torch.zeros((2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        w8_linear.w8_linear_cuda(x, p["w_q"], p["w_s"])
    assert w8_linear.takes(64, 32) and not w8_linear.takes(72, 32)
    assert not w8_linear.takes(64, 40) and not w8_linear.takes(0, 32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, None])
def test_dequantized_is_unchanged(dtype):
    """``dequantized`` still writes ``{"w": f32(w_q) * w_s}`` rounded once to
    ``dtype``, and keeps a float weight as it is."""
    p = _int8(96, 40, seed=3)
    out = L.dequantized({"a": p, "b": {"w": p["w_s"]}}, dtype)
    want = (p["w_q"].to(torch.float32) * p["w_s"]).to(dtype or torch.float32)
    assert set(out["a"]) == {"w"} and torch.equal(out["a"]["w"], want)
    assert out["b"]["w"] is p["w_s"]


def test_tokenwise_verify_projection_is_unchanged():
    """The verify step's projection (``attention._linear`` with
    ``tokenwise``): the weight dequantized once, then each token's slice
    through ``x @ w``, as before the kernel."""
    p = _int8(128, 64, seed=4)
    x = torch.randn((3, 4, 128), generator=torch.Generator().manual_seed(5)
                    ).to(torch.bfloat16)
    w = L.linear_weight(p, torch.bfloat16)
    want = torch.cat([x[:, i:i + 1].contiguous() @ w for i in range(4)], dim=1)
    got = A._linear(p, x, torch.bfloat16, tokenwise=True)
    assert torch.equal(got, want)
    assert torch.equal(L.per_token(functools.partial(
        L.linear_apply, L.dequantized(p, torch.bfloat16),
        dtype=torch.bfloat16), x), want)


@pytest.mark.parametrize("rows,dtype,kept", [
    (16, torch.bfloat16, True), (L.W8_ROWS, torch.bfloat16, True),
    (L.W8_ROWS + 1, torch.bfloat16, False), (16, torch.float32, False)])
def test_dequantized_keeps_what_the_kernel_reads_at_those_rows(
        monkeypatch, rows, dtype, kept):
    """With ``rows``, an int8 weight that ``linear_apply`` would read
    through the kernel at that many rows stays int8 (the same dict); any
    other is dequantized as before.  A CPU weight never takes the kernel,
    so it is dequantized at any rows."""
    p = _fake_params()
    dq = []
    monkeypatch.setattr(L, "linear_weight",
                        lambda params, dtype=None: dq.append(params) or "w")
    out = L.dequantized({"a": p}, dtype, rows=rows)
    assert (out["a"] is p) is kept and len(dq) == (not kept)
    cpu = _int8(64, 32)
    assert L.dequantized({"a": cpu}, dtype, rows=rows)["a"] == {"w": "w"}


def test_tokenwise_verify_reads_the_decode_steps_int8_weight(monkeypatch):
    """Where the decode step's B rows take the kernel, the verify's
    projection keeps the int8 weight and runs each token's (B, 1) slice
    through the same launcher, so each token's bits are the decode step's
    (the kernel's rows do not depend on the batch)."""
    p = _int8(128, 64, seed=4)
    x = torch.randn((3, 4, 128), generator=torch.Generator().manual_seed(5)
                    ).to(torch.bfloat16)
    w = L.linear_weight(p, torch.bfloat16)
    want = torch.cat([x[:, i:i + 1].contiguous() @ w for i in range(4)], dim=1)
    calls = []
    monkeypatch.setattr(L, "w8_rows_take", lambda params, rows, dt: rows == 3)
    monkeypatch.setattr(L, "w8_kernel_takes", lambda params, x, dt: (
        "w_q" in params and x.numel() // x.shape[-1] == 3))
    _launch_recorder(monkeypatch, calls)
    got = A._linear(p, x, torch.bfloat16, tokenwise=True)
    assert torch.equal(got, want)
    assert len(calls) == 4 and all(c[1] is p["w_q"] for c in calls)
    assert all(tuple(c[0].shape) == (3, 1, 128) for c in calls)
