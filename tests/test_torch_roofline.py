"""The port's roofline (``launch/roofline.py``), report
(``launch/report.py``) and perf driver (``launch/perf.py``) against the
JAX reference's.

``model_flops_for`` and ``inner_loop_correction`` equal the reference's for
every arch and shape; ``RooflineTerms`` does the reference's arithmetic at
the H100's datasheet constants; ``build_rows`` takes its chip count from the
report's mesh and adds no inner-loop correction (the port's counts cover
every loop trip)."""
import json

import pytest

from repro.configs import get_arch as ref_arch
from repro.launch import report as ref_report
from repro.launch import roofline as ref_rl

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import SHAPES
from repro_torch.launch import perf, report, roofline as rl


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_loop_correction_equal_reference(arch, shape):
    cell = SHAPES[shape]
    assert rl.model_flops_for(get_arch(arch).config, cell.kind,
                              cell.seq_len, cell.global_batch) == \
        ref_rl.model_flops_for(ref_arch(arch).config, cell.kind,
                               cell.seq_len, cell.global_batch)
    assert report.inner_loop_correction(arch, shape) == \
        ref_report.inner_loop_correction(arch, shape)


def test_h100_constants():
    assert rl.PEAK_FLOPS_BF16 == 989e12
    assert rl.PEAK_OPS_INT8 == 1979e12
    assert rl.HBM_BW == 3.35e12
    assert rl.NVLINK_BW_TOTAL == 900e9
    assert rl.LINK_BW == 450e9          # one direction of the 900 GB/s


def test_roofline_terms_arithmetic():
    t = rl.RooflineTerms(flops=989e12 * 0.5, hbm_bytes=3.35e12 * 0.25,
                         coll_bytes=450e9 * 0.125,
                         coll_breakdown={"all-gather": 1}, model_flops=1e15,
                         chips=4)
    assert t.t_compute == pytest.approx(0.5)
    assert t.t_memory == pytest.approx(0.25)
    assert t.t_collective == pytest.approx(0.125)
    assert t.bottleneck == "compute" and t.step_time == t.t_compute
    assert t.useful_flops_ratio == pytest.approx(1e15 / (989e12 * 0.5 * 4))
    assert t.mfu == pytest.approx(1e15 / (0.5 * 4 * 989e12))
    ref = ref_rl.RooflineTerms(1.0, 1.0, 1.0, {}, 1.0, 1)
    assert set(t.summary()) == set(ref.summary())
    m = rl.RooflineTerms(flops=1.0, hbm_bytes=3.35e12, coll_bytes=0.0,
                         coll_breakdown={}, model_flops=0.0, chips=1)
    assert m.bottleneck == "memory" and m.mfu == 0.0
    assert rl.measured_mfu(989e12, 1.0) == pytest.approx(1.0)


def _report(arch, shape, mesh, t_c, t_m, t_l, model_flops=1e18):
    chips = 1
    for d in mesh.split("x"):
        chips *= int(d)
    return {"arch": arch, "shape": shape, "mesh": mesh, "kind":
            SHAPES[shape].kind, "roofline": {
                "t_compute_s": t_c, "t_memory_s": t_m,
                "t_collective_s": t_l,
                "hlo_flops_per_chip": t_c * rl.PEAK_FLOPS_BF16,
                "model_flops": model_flops}}


@pytest.mark.parametrize("mesh,chips", [("16x16", 256), ("2x16x16", 512),
                                        ("2x4", 8)])
def test_build_rows_takes_chips_from_the_mesh_and_adds_no_correction(
        mesh, chips):
    r = _report("olmo_1b", "train_4k", mesh, 2.0, 3.0, 1.0)
    (row,) = report.build_rows([r, {"arch": "olmo_1b", "shape": "long_500k",
                                    "skipped": "x"}])
    # the reference would add inner_loop_correction here; the port's
    # counts already cover every trip of the loops
    assert report.inner_loop_correction("olmo_1b", "train_4k")[0] > 0
    assert (row["t_compute"], row["t_memory"], row["t_collective"]) == (
        2.0, 3.0, 1.0)
    assert row["bottleneck"] == "memory"
    assert row["mfu"] == pytest.approx(1e18 / (3.0 * chips
                                               * rl.PEAK_FLOPS_BF16))
    assert row["useful"] == pytest.approx(1e18 / (2.0 * rl.PEAK_FLOPS_BF16
                                                  * chips))
    assert row["hint"] == report.MOVE_HINT[("memory", "train")]
    assert set(report.MOVE_HINT) == set(ref_report.MOVE_HINT)


def test_report_main_prints_one_row(tmp_path, capsys):
    p = tmp_path / "r.json"
    p.write_text(json.dumps([_report("olmo_1b", "decode_32k", "16x16", 1e-3,
                                     2e-3, 0.0)]))
    report.main([str(p), "--hints"])
    lines = capsys.readouterr().out.splitlines()
    rows = [x for x in lines if x.startswith("| olmo_1b")]
    assert len(rows) == 1 and "**memory**" in rows[0]
    assert any(x.startswith("- olmo_1b x decode_32k: memory-bound")
               for x in lines)


@pytest.mark.parametrize("variant,field,value", [
    ("bf16_scores", "attn_score_dtype", "bfloat16"),
    ("triangular", "attn_triangular", True),
    ("bf16_logits", "logits_dtype", "bfloat16"),
    ("seq_shard", "seq_sharding", True),
    ("tp_serve", "serve_param_sharding", "tp"),
    ("int8_serve", "serve_param_dtype", "int8"),
])
def test_perf_variants(variant, field, value):
    cfg = perf.apply_variant(get_arch("olmo_1b").config, [variant])
    assert getattr(cfg, field) == value
    with pytest.raises(ValueError):
        perf.apply_variant(cfg, ["no_such_variant"])
