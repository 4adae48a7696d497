"""The port's distribution substrate (``repro_torch.dist.sharding``,
``launch/mesh.py``, ``dist/compression.py``'s group path, ``train.py
--mesh``) against the JAX reference's.

The spec functions are held leaf by leaf against ``repro.dist.sharding``
on every arch's config and smoke config, on both production meshes and on
a (2, 4) mesh: the reference's side is built with ``jax.eval_shape`` and a
mesh stand-in (its ``NamedSharding`` is replaced by the bare spec, so no
device is needed), the port's on ``meta`` tensors.  The port holds each
layer's leaves unstacked where the reference stacks them, so a reference
spec is compared with its stacked (leading layer) axes dropped.  The
reference's ``shard`` and rule tests are mirrored on DTensors over the
``fake`` process-group backend (rank 0 of 8)."""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.dist import sharding as ref_sh
from repro.launch import steps as ref_st

from repro_torch import tree as tu
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.dist import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import logical_rules, production_shape
from repro_torch.models.transformer import layer_segments

SRC = Path(__file__).resolve().parent.parent / "src"
MESHES = {"16x16": production_shape(multi_pod=False),
          "2x16x16": production_shape(multi_pod=True),
          "2x4": ((2, 4), ("data", "model"))}


class FakeMesh:
    """The reference's mesh stand-in (tests/test_steps_and_sharding.py)."""

    def __init__(self, sizes, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


class _Spec:
    """Stands in for the reference's ``NamedSharding``: its spec as a
    tuple, in a leaf that a tree walk does not enter."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.fixture
def bare_specs(monkeypatch):
    monkeypatch.setattr(ref_sh, "NamedSharding", _Spec)


def _ref_cfg(arch, which):
    a = ref_arch(arch)
    return a.config if which == "config" else a.smoke


def _cfg(arch, which):
    a = get_arch(arch)
    return a.config if which == "config" else a.smoke


@functools.lru_cache(maxsize=None)
def _ref_params(arch, which):
    cfg = _ref_cfg(arch, which)
    return jax.eval_shape(
        lambda: ref_st.init_params_fn(cfg)(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch, which):
    return dryrun._meta_params(_cfg(arch, which), serve_cell=False)


def _ref_leaves(tree):
    return [(ref_sh.path_str(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_of(path: str, cfg):
    """The port's paths of a reference leaf's path, and how many stacked
    axes lead the reference leaf."""
    parts = path.split("/")
    if parts[0] == "segments":
        off = 0
        for j, (_, n) in enumerate(layer_segments(cfg)):
            if j == int(parts[1]):
                rest = "/".join(parts[2:])
                return [f"layers/{off + i}/{rest}" for i in range(n)], 1
            off += n
    if parts[0] == "mamba_groups":
        rest = "/".join(parts[1:])
        return [f"layers/{i}/{rest}" for i in range(cfg.n_layers)], 2
    if parts[0] in ("encoder", "decoder"):
        n = (cfg.n_encoder_layers or cfg.n_layers if parts[0] == "encoder"
             else cfg.n_layers)
        rest = "/".join(parts[1:])
        return [f"{parts[0]}/{i}/{rest}" for i in range(n)], 1
    return [path], 0


def _compare(ref_tree, ref_specs, port_specs, port_tree, cfg):
    """Every reference leaf against its port leaves, the stacked axes of
    the reference's spec dropped; returns the differences, and the
    reference leaves whose dropped stacked axes are sharded (a rule that
    lands on a layer axis: a reference fault)."""
    port = {sh.path_str(p): (tuple(leaf.shape), spec) for (p, leaf), spec in
            zip(tu.leaves_with_path(port_tree), sh.spec_leaves(port_specs))}
    ref_spec_of = dict(zip([p for p, _ in _ref_leaves(ref_tree)],
                           [s.spec for _, s in _ref_leaves(ref_specs)]))
    seen, diffs, stacked = set(), [], []
    for path, leaf in _ref_leaves(ref_tree):
        paths, n_stack = _port_of(path, cfg)
        if any(a is not None for a in ref_spec_of[path][:n_stack]):
            stacked.append((path, ref_spec_of[path]))
        want = ref_spec_of[path][n_stack:]
        want = want + (None,) * (len(leaf.shape) - n_stack - len(want))
        for p in paths:
            shape, got = port[p]
            assert shape == tuple(leaf.shape)[n_stack:], (p, shape, path)
            if got != want:
                diffs.append((p, got, want))
            seen.add(p)
    assert seen == set(port), sorted(set(port) - seen)[:5]
    return diffs, stacked


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("which", ["config", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_equal_reference(arch, which, mesh, bare_specs):
    sizes, names = MESHES[mesh]
    ref_mesh = FakeMesh(sizes, names)
    port_mesh = FakeMesh(sizes, names)
    ref_tree = _ref_params(arch, which)
    port_tree = _port_params(arch, which)
    for fsdp in (True, False):
        ref_specs = ref_sh.param_shardings(ref_tree, _ref_cfg(arch, which),
                                           ref_mesh, fsdp=fsdp)
        port_specs = sh.param_shardings(port_tree, _cfg(arch, which),
                                        port_mesh, fsdp=fsdp)
        assert _compare(ref_tree, ref_specs, port_specs, port_tree,
                        _cfg(arch, which)) == ([], [])


def test_reference_fault_mamba2_a_log_on_a_stacked_axis(bare_specs):
    """A reference fault (ROADMAP queue 3): its ``ssm/A_log`` rule has
    Mamba-1's two trailing axes, so on Mamba-2's stacked ``(groups, per,
    H)`` leaf it shards the stacked ``per`` axis wherever "model" divides
    it (Zamba2: 6 a group; here a (2, 2) mesh), where the port's unstacked
    (H,) leaf stays replicated.  Every other leaf agrees."""
    ref_tree, port_tree = _ref_params("zamba2_2p7b", "config"), \
        _port_params("zamba2_2p7b", "config")
    cfg = _cfg("zamba2_2p7b", "config")
    ref_specs = ref_sh.param_shardings(ref_tree, _ref_cfg("zamba2_2p7b",
                                                          "config"),
                                       FakeMesh((2, 2), ("data", "model")))
    port_specs = sh.param_shardings(port_tree, cfg,
                                    FakeMesh((2, 2), ("data", "model")))
    diffs, stacked = _compare(ref_tree, ref_specs, port_specs, port_tree,
                              cfg)
    assert diffs == []
    assert stacked == [("mamba_groups/ssm/A_log", (None, "model", None))]


@pytest.mark.parametrize("path,shape,arch,want", [
    # the reference's rule tests (tests/test_steps_and_sharding.py),
    # on the port's unstacked leaves
    ("layers/0/attn/wq/w", (8192, 8192), "deepseek_67b", ("data", "model")),
    ("embed/table", (102400, 8192), "deepseek_67b", ("model", "data")),
    ("layers/0/attn/wq/w", (100, 8192), "deepseek_67b", (None, "model")),
    ("layers/1/moe/w_in", (64, 2048, 1408), "deepseek_moe_16b",
     ("model", "data", None)),
    ("layers/0/moe/w_in", (8, 6144, 16384), "mixtral_8x22b",
     (None, "data", "model")),
    ("layers/0/mlp/w_out/w_q", (22016, 8192), "deepseek_67b",
     ("model", "data")),
    ("layers/0/attn/q_norm/scale", (128,), "chameleon_34b", (None,)),
])
def test_trailing_spec_rules(path, shape, arch, want):
    mesh = FakeMesh((16, 16), ("data", "model"))
    leaf = torch.empty(shape, device="meta")
    assert sh._trailing_spec(path, leaf, get_arch(arch).config, mesh) == want
    ref = ref_sh._trailing_spec(
        path, jax.ShapeDtypeStruct(shape, np.float32),
        ref_arch(arch).config, FakeMesh((16, 16), ("data", "model")))
    assert tuple(ref) == want


def _decode_cells():
    return [(a, s) for a in ARCH_IDS for s, c in get_arch(a).shapes().items()
            if c.kind == "decode"]


def _cache_key(path: str) -> str:
    """A reference cache path as the port's flat dense cache names it."""
    for lead in ("kv/", "ssm/"):
        if path.startswith(lead):
            return path[len(lead):]
    return path


@pytest.mark.parametrize("arch,shape", _decode_cells())
def test_batch_and_cache_shardings_equal_reference(arch, shape, bare_specs):
    ref, port = ref_arch(arch), get_arch(arch)
    ref_cache = ref.cache_specs(shape)
    port_cache = port.cache_specs(shape)
    for sizes, names in MESHES.values():
        ref_mesh = port_mesh = FakeMesh(sizes, names)
        ref_b = ref_sh.batch_shardings(ref.input_specs(shape), ref_mesh)
        port_b = sh.batch_shardings(port.input_specs(shape), port_mesh)
        assert {k: v.spec for k, v in ref_b.items()} == port_b
        ref_c = dict(_ref_leaves(ref_sh.cache_shardings(
            ref_cache, ref.config, ref_mesh)))
        port_c = {sh.path_str(p): s for (p, _), s in zip(
            tu.leaves_with_path(port_cache), sh.spec_leaves(
                sh.cache_shardings(port_cache, port.config, port_mesh)))}
        for path, spec in ref_c.items():
            assert port_c[_cache_key(path)] == spec.spec, (path, names)
        assert set(port_c) == {_cache_key(p) for p in ref_c}


# ------------------------------------------------ the logical-axis API --

def test_shard_is_identity_without_binding():
    assert sh.current_axis_rules() is None
    x = torch.ones((4, 8))
    assert sh.shard(x, "batch", "embed") is x


def test_axis_rules_binding_restores_previous():
    mesh = FakeMesh((2, 4), ("data", "model"))
    with sh.axis_rules(mesh, {"batch": "data"}):
        with sh.axis_rules(mesh, {"batch": None}):
            assert sh.current_axis_rules()[1] == {"batch": None}
        assert sh.current_axis_rules()[1] == {"batch": "data"}
    assert sh.current_axis_rules() is None


def _shard_cases():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))

        def rep(shape):
            return distribute_tensor(torch.ones(shape), mesh,
                                     [Replicate(), Replicate()],
                                     src_data_rank=None)

        out = {}
        with sh.axis_rules(mesh, logical_rules(mesh)):
            out["rules"] = sh.shard(rep((4, 8, 16, 4)), "batch", "heads",
                                    None, None).placements
        rules = {"batch": ("data",), "heads": "model", "mlp": "model"}
        with sh.axis_rules(mesh, rules):
            # "mlp" would reuse the model axis -> replicated
            out["reuse"] = sh.shard(rep((4, 8, 16)), "batch", "heads",
                                    "mlp").placements
            # 3 % data(2) != 0 -> the batch dim replicated
            out["divide"] = sh.shard(rep((3, 8)), "batch", None).placements
            # the guard on another shape: 6 heads over model(4) do not split
            out["sizes"] = sh.shard(rep((2, 3, 24)), "batch", None, "heads",
                                    sizes=(2, 3, 6)).placements
        out["want"] = {"rules": (Shard(0), Shard(1)),
                       "reuse": (Shard(0), Shard(1)),
                       "divide": (Replicate(), Replicate()),
                       "sizes": (Shard(0), Replicate())}
    return out


def test_shard_applies_rules_and_guards():
    """The reference's shard tests on DTensors: the rules applied, the
    axis-reuse and divisibility guards, and the guard on ``sizes``."""
    out = _shard_cases()
    for key, want in out.pop("want").items():
        assert tuple(out[key]) == want, key
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_placements_of_a_multi_axis_dim():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    with dryrun.fake_world(16):
        mesh = init_device_mesh("cpu", (2, 4, 2),
                                mesh_dim_names=("pod", "data", "model"))
        assert sh.placements((("pod", "data"), "model"), mesh) == (
            Shard(0), Shard(0), Shard(1))
        assert sh.placements((None, None), mesh) == (Replicate(),) * 3
        x = sh.place(torch.arange(64.).reshape(16, 4), mesh,
                     (("pod", "data"), "model"))
        assert tuple(x.to_local().shape) == (2, 2)


def test_logical_rules_and_production_shapes():
    assert production_shape(multi_pod=False) == ((16, 16),
                                                 ("data", "model"))
    assert production_shape(multi_pod=True) == ((2, 16, 16),
                                                ("pod", "data", "model"))
    from repro.launch.mesh import logical_rules as ref_rules
    for sizes, names in MESHES.values():
        assert logical_rules(FakeMesh(sizes, names)) == ref_rules(
            FakeMesh(sizes, names))


# --------------------------------------------- compressed_psum over gloo --

_PSUM_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.dist import compression as comp
rank, init, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
data = np.load(path + "/in.npz")
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
try:
    red, err = comp.compressed_psum({"w": torch.from_numpy(data["g"][rank])},
                                    {"w": torch.from_numpy(data["e"][rank])},
                                    dist.group.WORLD)
    np.savez(f"{path}/out{rank}.npz", red=red["w"].numpy(),
             err=err["w"].numpy())
finally:
    dist.destroy_process_group()
"""


def test_compressed_psum_over_gloo_equals_pmap(tmp_path, rng, cpu_devices):
    """Two gloo ranks, each a process (a ``FileStore`` under ``tmp_path``),
    against the reference under ``pmap`` on 2 host devices
    (``tests/test_substrate.py``): the mean and each rank's residual,
    bitwise."""
    from repro.dist import compression as ref_comp
    if cpu_devices < 2:
        pytest.skip("needs 2 host-platform devices (conftest default)")
    g = rng.normal(0, 1, (2, 3, 32)).astype(np.float32)
    err = rng.normal(0, 0.01, (2, 3, 32)).astype(np.float32)
    red, err2 = jax.pmap(
        lambda g, e: ref_comp.compressed_psum(g, e, axis_name="dp"),
        axis_name="dp", devices=jax.devices()[:2])({"w": g}, {"w": err})
    np.savez(tmp_path / "in.npz", g=g, e=err)
    init = f"file://{tmp_path / 'store'}"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen([sys.executable, "-c", _PSUM_RANK, str(r),
                               init, str(tmp_path)], env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, errs = p.communicate(timeout=120)
        assert p.returncode == 0, errs[-2000:]
    for r in range(2):
        out = np.load(tmp_path / f"out{r}.npz")
        np.testing.assert_array_equal(out["red"], np.asarray(red["w"][r]))
        np.testing.assert_array_equal(out["err"], np.asarray(err2["w"][r]))


# ------------------------------------------------- train.py --mesh (1, 1) --

def test_train_step_under_a_1x1_mesh_is_bitwise_the_unbound_step(
        monkeypatch):
    """``train.main --mesh single --mesh-shape 1x1`` (gloo, world 1): the
    parameters and moments are DTensors placed by ``param_shardings`` and
    the step runs under ``axis_rules``; its losses, grad norms and final
    parameters and moments equal the unbound run's bit for bit."""
    import torch.distributed as dist
    from repro_torch.launch import train
    # port 0: the one rank's store binds a free port itself
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT="0",
                     RANK="0", WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    argv = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
            "--seq", "32", "--log-every", "1"]
    plain = train.main(argv)
    meshed = train.main(argv + ["--mesh", "single", "--mesh-shape", "1x1"])
    assert not dist.is_initialized()
    assert meshed["mesh"].mesh_dim_names == ("data", "model")
    for key in ("losses", "ce", "grad_norms", "lrs"):
        assert meshed[key] == plain[key], key
    for tree in ("params", "opt_state"):
        got = tu.leaves(meshed[tree])
        want = tu.leaves(plain[tree])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            a = a.full_tensor() if hasattr(a, "full_tensor") else a
            assert torch.equal(a, b)



def test_train_on_two_gloo_ranks_tracks_the_unbound_run():
    """``torchrun --nproc-per-node 2 ... --mesh single --mesh-shape 2x1``:
    two processes split the batch over "data" (FSDP-sharded parameters
    and moments, gradients reduced over gloo); each step's loss equals the
    unbound run's within 1e-4 and each grad norm within 1e-4 of it
    relatively (the reductions' order differs; a gradient summed on one
    rank only would change the norm)."""
    import re
    from repro_torch.launch import train
    argv = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
            "--seq", "32", "--log-every", "1"]
    plain = train.main(argv)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *argv,
         "--mesh", "single", "--mesh-shape", "2x1"], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = {}
    # the two ranks share stdout: a line's end may come after the other
    # rank's line, so match each record by its fixed-width numbers
    for m in re.finditer(r"step +(\d+) loss (\d+\.\d{4}) .*?gnorm "
                         r"(\d+\.\d{2})", proc.stdout):
        seen.setdefault(int(m.group(1)), []).append(
            (float(m.group(2)), float(m.group(3))))
    assert sorted(seen) == [1, 2, 3]
    for step, got in seen.items():
        assert len(got) == 2                   # both ranks print it
        for loss, gnorm in got:
            assert abs(loss - plain["losses"][step - 1]) < 1e-4, (step, got)
            want = plain["grad_norms"][step - 1]
            assert abs(gnorm - want) <= 1e-4 * want + 0.005, (step, got)


_SPLIT_RANK = """
import json, sys
import numpy as np
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import tree as tu
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.dist import sharding as sh
from repro_torch.launch import steps as st
from repro_torch.launch import train
from repro_torch.launch.mesh import logical_rules
out, argv, seq = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo")
try:
    rec = train.main(argv)
    cfg, mesh = rec["cfg"].replace(attn_mode="float"), rec["mesh"]
    params = st.init_params_fn(cfg)(seed=0, device="cpu")
    batch = batch_for_step(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=4,
        frames=cfg.family == "encdec", d_model=cfg.d_model), 0)
    params = sh.place_tree(params, sh.param_shardings(params, cfg, mesh),
                           mesh)
    batch = sh.place_tree(batch, sh.batch_shardings(batch, mesh), mesh)
    with sh.axis_rules(mesh, logical_rules(mesh)), implicit_replication():
        (loss, _), grads = st.value_and_grad(params, batch, cfg)
    loss = float(loss.full_tensor())
    grads = [g.full_tensor() if hasattr(g, "full_tensor") else g
             for g in tu.leaves(grads)]
    if dist.get_rank() == 0:
        np.savez(out, loss=loss,
                 losses=rec["losses"], grad_norms=rec["grad_norms"],
                 *[g.numpy() for g in grads])
finally:
    dist.destroy_process_group()
"""


GRAD_SEQ = 128


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_2p7b",
                                  "seamless_m4t_medium"])
def test_model_split_on_two_gloo_ranks_tracks_the_unbound_run(arch,
                                                              tmp_path):
    """Two gloo ranks on a (1, 2) mesh, so the "model" axis splits: the
    paths a mesh alone takes (Mamba-1's ``in_proj`` split by weight,
    Mamba-2's x, B and C convolved apart, the embedding's gather over the
    rank's vocab rows, the encoder-decoder's cross attention and frames)
    run on DTensors with real values.  ``train.main --mesh single
    --mesh-shape 1x2`` for 3 steps as trained (fakequant): each loss within
    1e-5 and each grad norm within 1e-4 of the unbound run's, relatively
    (measured 1.1e-6 and 2.9e-5, SeamlessM4T).  The first step's
    gradients, gathered whole, with float attention: every leaf within
    1e-5 of the largest magnitude of the unbound one (measured 5.8e-6,
    Zamba2's ``dt_bias``; the split sums partial products in another
    order).  Fakequant is not used there: that order moves a score across
    an int8 rounding edge and SeamlessM4T's encoder ``wq``/``wk`` move by
    1.2e-4 of their scale (every other leaf of the three configs within
    6e-5).  The steps' 128 tokens a batch take the embedding's
    rows-reduce forward, the gradient's 512 (as many as the smoke vocab's
    rows) its whole-table gather."""
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import steps as st
    from repro_torch.launch import train
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq", "32", "--log-every", "1"]
    plain = train.main(argv)
    cfg = plain["cfg"].replace(attn_mode="float")
    params = st.init_params_fn(cfg)(seed=0, device="cpu")
    batch = batch_for_step(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=GRAD_SEQ, global_batch=4,
        frames=cfg.family == "encdec", d_model=cfg.d_model), 0)
    (loss, _), grads = st.value_and_grad(params, batch, cfg)

    import json
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    out = tmp_path / "rank0.npz"
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
                   MASTER_ADDR="localhost", MASTER_PORT=port,
                   RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _SPLIT_RANK, str(out), json.dumps(
                argv + ["--mesh", "single", "--mesh-shape", "1x2"]),
             str(GRAD_SEQ)],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True))
    for p in procs:
        _, errs = p.communicate(timeout=300)
        assert p.returncode == 0, errs[-3000:]
    got = np.load(out)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(got["losses"], plain["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], plain["grad_norms"],
                               rtol=1e-4)
    want = [g.numpy() for g in tu.leaves(grads)]
    assert len(got.files) == len(want) + 3
    for i, w in enumerate(want):
        g = got[f"arr_{i}"]
        assert g.shape == w.shape, i
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-5, (i, err)
