"""The port's dry-run (``launch/dryrun.py``) and its shape grid
(``configs/base.py``) against the JAX reference's.

The grid (``SHAPES``, each arch's ``skip_shapes``, ``input_specs``,
``cache_len`` and the ``cache_specs`` shapes) equals the reference's for
every arch.  A (2, 4) fake-mesh dry-run of OLMo-1B's smoke config at the
``train_4k`` cell, in a subprocess as the reference's
``test_tiny_mesh_dryrun_subprocess`` runs its own (about 25 s with the
interpreter's start: two cells of ~5 s each and the imports), reports the
reference's keys, places its inputs as the reference's ``NamedSharding``\\ s
place them on conftest's 8 host devices (per-device bytes equal), and
counts rank 0's flops within 5% of an eighth of the same cell on a (1, 1)
mesh, which counts no collective."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_arch as ref_arch
from repro.configs.base import SHAPES as REF_SHAPES
from repro.dist import sharding as ref_sh
from repro.launch import steps as ref_st
from repro.launch.roofline import RooflineTerms as RefTerms

from repro_torch import tree as tu
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun

SRC = Path(__file__).resolve().parent.parent / "src"


def test_shapes_and_skips_equal_reference():
    assert {k: vars(v) for k, v in SHAPES.items()} == {
        k: vars(v) for k, v in REF_SHAPES.items()}
    for arch in ARCH_IDS:
        assert get_arch(arch).skip_shapes == ref_arch(arch).skip_shapes
        assert list(get_arch(arch).shapes()) == list(ref_arch(arch).shapes())


def _ref_leaves(tree):
    return {ref_sh.path_str(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cache_key(path: str) -> str:
    for lead in ("kv/", "ssm/"):
        if path.startswith(lead):
            return path[len(lead):]
    return path


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_equal_reference(arch, shape):
    ref, port = ref_arch(arch), get_arch(arch)
    got = port.input_specs(shape)
    want = ref.input_specs(shape)
    assert list(got) == list(want) or set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
        assert got[k].device.type == "meta"
    assert port.cache_len(SHAPES[shape]) == ref.cache_len(REF_SHAPES[shape])
    ref_cache = ref.cache_specs(shape)
    port_cache = port.cache_specs(shape)
    if ref_cache is None:
        assert port_cache is None
        return
    port_leaves = {"/".join(str(k) for _, k in p): leaf
                   for p, leaf in tu.leaves_with_path(port_cache)}
    for path, leaf in _ref_leaves(ref_cache).items():
        mine = port_leaves[_cache_key(path)]
        assert tuple(mine.shape) == tuple(leaf.shape), path
        assert str(mine.dtype).split(".")[-1] == str(leaf.dtype), path
    assert set(port_leaves) == {_cache_key(p) for p in
                                _ref_leaves(ref_cache)}


_TINY = """
import json
from repro_torch.configs import get_arch
from repro_torch.launch.dryrun import dryrun_cell
cfg = get_arch("olmo_1b").smoke
out = {}
for name, shape in (("2x4", (2, 4)), ("1x1", (1, 1))):
    out[name] = dryrun_cell("olmo_1b", "train_4k", multi_pod=False,
                            mesh=(shape, ("data", "model")),
                            config_override=cfg, verbose=False)
print("REPORTS" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def tiny_reports():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _TINY], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("REPORTS"))
    return json.loads(line[len("REPORTS"):])


def _ref_argument_bytes(cpu_devices):
    """Per-device bytes of the reference's placed params, moments, step
    and batch for OLMo-1B's smoke config at train_4k on a (2, 4) mesh."""
    from jax.sharding import Mesh
    from repro.optim import adamw
    if cpu_devices < 8:
        pytest.skip("needs 8 host-platform devices (conftest default)")
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                ("data", "model"))
    arch = ref_arch("olmo_1b")
    cfg = arch.smoke
    params = jax.eval_shape(
        lambda: ref_st.init_params_fn(cfg)(jax.random.PRNGKey(0)))
    opt = jax.eval_shape(adamw.init_state, params)
    batch = arch.input_specs("train_4k")

    def nbytes(tree, shardings):
        return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
                   for x, s in zip(jax.tree.leaves(tree),
                                   jax.tree.leaves(shardings)))

    p_shard = ref_sh.param_shardings(params, cfg, mesh)
    return (nbytes(params, p_shard) + nbytes(opt.mu, p_shard)
            + nbytes(opt.nu, p_shard) + opt.step.dtype.itemsize
            + nbytes(batch, ref_sh.batch_shardings(batch, mesh)))


def test_tiny_mesh_dryrun_reports_the_reference_keys(tiny_reports):
    ref_keys = {"arch", "shape", "mesh", "kind", "lower_s", "compile_s",
                "memory", "roofline"}
    ref_roofline = set(RefTerms(1.0, 1.0, 1.0, {}, 1.0, 1).summary())
    for name, r in tiny_reports.items():
        assert set(r) == ref_keys, name
        assert set(r["roofline"]) == ref_roofline
        assert r["mesh"] == name and r["kind"] == "train"
        assert r["roofline"]["hlo_flops_per_chip"] > 0
        assert r["roofline"]["hbm_bytes_per_chip"] > 0
        assert r["memory"]["argument_size_in_bytes"] > 0


def test_tiny_mesh_dryrun_places_as_the_reference(tiny_reports,
                                                  cpu_devices):
    got = tiny_reports["2x4"]["memory"]["argument_size_in_bytes"]
    assert got == _ref_argument_bytes(cpu_devices)


def test_tiny_mesh_dryrun_counts_a_share_of_the_work(tiny_reports):
    """Rank 0's flops on the (2, 4) mesh are an eighth of the whole step's
    within 5% (the sharding replicates little compute at this size), and
    a (1, 1) mesh moves no collective bytes."""
    one = tiny_reports["1x1"]["roofline"]
    eight = tiny_reports["2x4"]["roofline"]
    assert one["coll_bytes_per_chip"] == 0
    assert all(v == 0 for v in one["coll_breakdown"].values())
    assert eight["coll_bytes_per_chip"] > 0
    ratio = eight["hlo_flops_per_chip"] / (one["hlo_flops_per_chip"] / 8)
    assert 0.95 <= ratio <= 1.05, ratio
    assert one["model_flops"] == eight["model_flops"]


def test_main_skips_and_writes_the_list(tmp_path):
    out = tmp_path / "d.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "olmo_1b", "--shape", "long_500k", "--out",
                     str(out)])
    assert e.value.code == 0
    rows = json.loads(out.read_text())
    assert rows == [{"arch": "olmo_1b", "shape": "long_500k",
                     "skipped": get_arch("olmo_1b").skip_shapes[
                         "long_500k"]}]


def test_fake_world_refuses_a_live_group_and_cleans_up():
    import torch.distributed as dist
    with dryrun.fake_world(4):
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already set up"):
            with dryrun.fake_world(2):
                pass
    assert not dist.is_initialized()
