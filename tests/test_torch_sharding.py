"""The rules half of parallel/sharding.py, launch/mesh.py and the rank
mesh's collectives, against the JAX package.

  * ``resolve`` on the reference's production meshes (``make_production_
    mesh``: (2, 16, 16) pod/data/model and (16, 16), 512 host devices in a
    subprocess) gives the reference's spec on the cases of
    tests/test_sharding_rules.py, the sequence-parallel override, and
    every leaf of every arch at its published width (its logical axes from
    ``param_axes``, its shape from the port's ``meta`` model).
  * ``param_axes`` equals the axes tree of the reference's
    ``blocks.split_params(init_model(...))`` for every arch, smoke and
    published configs (EP and slot-parallel MoEs, MLA, the recurrent
    mixers, the encoder, the shared block, MTP).
  * ``shard_slices`` equals ``NamedSharding.devices_indices_map`` at
    (data 2, model 1) and (data 2, model 2) for the FSDP layouts of
    qwen2-0.5b's and deepseek-v3-671b's smoke leaves and a few specs
    more, device by device (row-major over the mesh, as ranks are).
  * Every collective (``copy_to``, ``reduce_from``, ``gather_from``,
    ``split_to``, ``gather_shards``, ``all_to_all``, ``ring_shift``,
    ``pmean``, ``gather_leaf``) over every line of a (2, 2) mesh of 4 gloo
    ranks, in bf16 and f32, forward and backward, equals what it means;
    the lines and coordinates are row-major.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.core import tree as tree_lib
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as ttransformer
from repro_torch.parallel import launch, sharding
from repro_torch.parallel.mesh_jobs import (CollectivesJob, collectives_job,
                                            each)

SRC = Path(__file__).resolve().parents[1] / "src"

# tests/test_sharding_rules.py's cases, then more: (mesh, overrides, axes,
# shape)
RULE_CASES = [
    ("multi", None, ("batch", None), (256, 4096)),
    ("multi", None, ("batch", None), (1, 4096)),
    ("multi", None, (None, None, "heads_tp", None), (8, 128, 14, 64)),
    ("multi", None, (None, None, "heads_tp"), (8, 128, 896)),
    ("multi", None, ("embed_fsdp", "embed_fsdp"), (64, 64)),
    ("multi", None, ("expert", "embed_fsdp", None), (256, 7168, 2048)),
    ("multi", None, ("expert", "embed_fsdp", None), (40, 1536, 512)),
    ("multi", None, ("batch", "kv_heads_tp", "kv_seq", None),
     (128, 16, 32768, 128)),
    ("multi", {"kv_seq": ("model",), "kv_heads_tp": None},
     ("batch", "kv_heads_tp", "kv_seq", None), (128, 2, 32768, 64)),
    ("single", None, ("batch", None), (256, 4096)),
    ("multi", None, ("batch", None), (16, 4096)),     # data alone divides
    ("multi", None, ("batch", None), (2, 4096)),      # pod alone divides
    ("multi", None, ("stage", "layers", "embed_fsdp"), (2, 24, 896)),
    ("single", None, ("stage", None), (4, 8)),
    ("multi", None, ("batch", "seq_sp", None), (64, 4096, 896)),
    ("multi", {"seq_sp": ("model",)}, ("batch", "seq_sp", None),
     (64, 4096, 896)),
    ("single", None, None, (8, 8)),                   # no mesh: all None
]

SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_production_mesh
from repro.parallel import sharding as sh
rules, leaves, slices = pickle.load(open(sys.argv[1], "rb"))
meshes = {"multi": make_production_mesh(multi_pod=True),
          "single": make_production_mesh(multi_pod=False)}
def spec(kind, over, axes, shape):
    if axes is None:
        return tuple(sh.resolve((None,) * len(shape), shape, None))
    with sh.use_mesh(meshes[kind], over):
        return tuple(sh.resolve(axes, shape))
out = {"rules": [spec(*c) for c in rules],
       "leaves": [spec(k, None, a, s) for k, a, s in leaves],
       "shape": {k: dict(m.shape) for k, m in meshes.items()}}
auto = jax.sharding.AxisType.Auto
got = []
for mshape, specs in slices:
    mesh = jax.make_mesh(mshape, ("data", "model"), axis_types=(auto, auto))
    pos = {d: i for i, d in enumerate(mesh.devices.flat)}
    rows = []
    for shape, entries in specs:
        idx = NamedSharding(mesh, P(*entries)).devices_indices_map(shape)
        per = [None] * mesh.devices.size
        for d, s in idx.items():
            per[pos[d]] = tuple((x.start or 0, x.stop if x.stop is not None
                                 else n) for x, n in zip(s, shape))
        rows.append(per)
    got.append(rows)
out["slices"] = got
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _production(kind):
    return tmesh.make_production_mesh(multi_pod=kind == "multi")


def _leaf_cases():
    """(mesh kind, logical axes, shape) of every leaf of every arch at its
    published width, on both production meshes."""
    out = []
    for arch in tconfigs.ARCHS:
        cfg = tconfigs.get_config(arch)
        axes = tree_lib.leaves(ttransformer.param_axes(cfg),
                               is_leaf=sharding.is_spec)
        shapes = [tuple(p.shape) for p in tree_lib.leaves(
            ttransformer.param_tree(ttransformer.init_model(cfg, None,
                                                            "meta")))]
        for kind in ("multi", "single"):
            out += [(kind, a, s) for a, s in zip(axes, shapes)]
    return out


def _slice_cases():
    """FSDP specs of two archs' smoke leaves and a few more, on (2, 1)
    and (2, 2)."""
    out = []
    for mshape in ((2, 1), (2, 2)):
        mesh = sharding.Mesh.abstract(mshape, ("data", "model"))
        specs = [((8, 6), ("data", "model")), ((8, 6), (("data", "model"),
                                                        None)),
                 ((4, 6, 2), (None, "model", "data")), ((5, 3), (None, None))]
        for arch in ("qwen2-0.5b", "deepseek-v3-671b"):
            cfg = tconfigs.get_smoke_config(arch)
            axes = tree_lib.leaves(ttransformer.param_axes(cfg),
                                   is_leaf=sharding.is_spec)
            for a, p in zip(axes, tree_lib.leaves(ttransformer.param_tree(
                    ttransformer.init_model(cfg, None, "meta")))):
                specs.append((tuple(p.shape), sharding.resolve(
                    a, tuple(p.shape), mesh)))
        out.append((mshape, specs))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding")
    leaves, slices = _leaf_cases(), _slice_cases()
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((RULE_CASES, leaves, slices), f)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(d / "in.pkl"),
                        str(d / "out.pkl")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f), leaves, slices


def _port_spec(kind, over, axes, shape):
    if axes is None:
        return sharding.resolve((None,) * len(shape), shape, None)
    with sharding.use_mesh(_production(kind), over):
        return sharding.resolve(axes, shape)


def test_resolve_equals_the_reference_on_the_rule_cases(reference):
    out, _, _ = reference
    assert [_port_spec(*c) for c in RULE_CASES] == out["rules"]
    assert {k: _production(k).shape for k in out["shape"]} == out["shape"]
    # the reference test's expectations, spelled out
    with sharding.use_mesh(_production("multi")):
        assert sharding.resolve(("batch", None), (256, 4096)) == \
            (("pod", "data"), None)
        assert sharding.resolve(("expert", "embed_fsdp", None),
                                (40, 1536, 512)) == \
            (None, "data", None)


def test_resolve_equals_the_reference_on_every_leaf(reference):
    out, leaves, _ = reference
    got = [_port_spec(k, None, a, s) for k, a, s in leaves]
    assert len(got) == len(out["leaves"]) == 810    # 405 leaves x 2 meshes
    assert got == out["leaves"]


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_param_axes_equal_the_reference(arch, full):
    get = jconfigs.get_config if full else jconfigs.get_smoke_config
    jcfg = get(arch)
    _, axes = jblocks.split_params(jax.eval_shape(
        lambda: jtransformer.init_model(jax.random.PRNGKey(0), jcfg)))
    ref = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path), a) for path, a in
           jax.tree_util.tree_flatten_with_path(
               axes, is_leaf=sharding.is_spec)[0]]
    tcfg = (tconfigs.get_config if full else tconfigs.get_smoke_config)(arch)
    got = tree_lib.paths(ttransformer.param_axes(tcfg),
                         is_leaf=sharding.is_spec)
    assert got == ref
    # keyed as the port's parameter tree, leaf for leaf
    tree = ttransformer.param_tree(ttransformer.init_model(tcfg, None, "meta"))
    assert [k for k, _ in got] == [k for k, _ in tree_lib.paths(tree)]
    for (_, a), (_, p) in zip(got, tree_lib.paths(tree)):
        assert len(a) == p.dim()


def test_shard_slices_equal_devices_indices_map(reference):
    out, _, slices = reference
    for (mshape, specs), rows in zip(slices, out["slices"]):
        mesh = sharding.Mesh.abstract(mshape, ("data", "model"))
        for (shape, entries), per in zip(specs, rows):
            for rank, want in enumerate(per):
                got = sharding.shard_slices(shape, entries, mesh, rank)
                assert tuple((s.start, s.stop) for s in got) == want, (
                    mshape, shape, entries, rank)
            part = sharding.shard_of(np.zeros(shape), entries, mesh,
                                     0).shape
            assert part == tuple(b - a for a, b in per[0])


def test_meshes_and_their_refusals():
    m = tmesh.make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.chips(m) == 512 and m.rank is None
    assert tmesh.chips(tmesh.make_production_mesh()) == 256
    assert m.coords(300) == {"pod": 1, "data": 2, "model": 12}
    assert m.rank_at({"pod": 1, "data": 2, "model": 12}) == 300
    with pytest.raises(ValueError, match="abstract"):
        m.line("model")
    with pytest.raises(RuntimeError, match="process group"):
        sharding.Mesh((2, 1), ("data", "model"))
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_slices((5, 4), ("data", None),
                              sharding.Mesh.abstract((2, 1), ("data",
                                                              "model")), 0)
    x = torch.arange(8.0)
    assert sharding.constrain(x, "batch") is x
    single = tmesh.make_production_mesh()
    sh = sharding.named_sharding(("embed_fsdp", "mlp_tp"), (896, 4864),
                                 single)
    assert sh.spec == ("data", "model")
    tree = sharding.tree_shardings({"w": ("embed_fsdp", None), "b": (None,)},
                                   {"w": (64, 8), "b": (8,)}, single)
    assert tree["w"].spec == ("data", None)
    assert tree["b"].spec == (None,)
    assert sharding.stack_axes(("embed_fsdp", "mlp_tp")) == \
        ("layers", "embed_fsdp", "mlp_tp")


def test_collectives_forward_and_backward_on_four_ranks(tmp_path):
    jobs = [CollectivesJob()]
    out = launch.spawn(each, 4, (collectives_job, jobs),
                       store_dir=str(tmp_path), backend="gloo",
                       timeout_s=120.0)
    for rank, per in enumerate(out):
        for job, r in zip(jobs, per):
            assert r["bad"] == [], (rank, job, r["bad"])
            assert r["coords"] == {"data": rank // 2, "model": rank % 2}
            assert r["lines"][("model",)] == (2, rank % 2, (
                rank - rank % 2, rank - rank % 2 + 1))
            assert r["lines"][("data",)] == (2, rank // 2, (
                rank % 2, rank % 2 + 2))
            assert r["lines"][("data", "model")] == (4, rank, (0, 1, 2, 3))


def test_the_mesh_modules_import_no_jax():
    code = ("import repro_torch.parallel.pipeline, repro_torch.parallel."
            "sharding, repro_torch.models.moe, repro_torch.launch.mesh, "
            "repro_torch.launch.train, repro_torch.train.step; import sys; "
            "assert 'jax' not in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert r.returncode == 0, r.stderr
