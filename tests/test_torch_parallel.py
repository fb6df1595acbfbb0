"""The port's mesh and sharding rules against ``ray_tpu.parallel``.

In this process: ``MeshSpec`` resolution and its errors, as
``tests/test_parallel.py``; ``logical_to_mesh``'s placements against the
JAX ``PartitionSpec``; and the parameter table: every parameter of the
port's GPT-2, Llama (untied head), ViT, ResNet and switch-MoE tiny models
must fall on the mesh axes that ``ray_tpu.parallel.sharding``'s table
gives its flax counterpart, on an ``fsdp 2 × tp 2`` and an ``fsdp 2 × ep
2`` mesh. The counterpart is found through the model's own
``load_jax_params``: each flax leaf is loaded holding its leaf number and
flat indices, so every port parameter says which leaf it came from and
which of its dimensions is which of the leaf's (transposes included).

On four gloo ranks (``ray_tpu_torch.parallel.dryrun.spawn``, cases in
``torch_mesh_ranks.parallel_cases``): a mesh's shape, coordinates and
groups; ``place_params`` on ``dp 4`` broadcasting rank 0's weights to
replicas that started apart; FSDP2 on ``fsdp 4`` splitting ``wte`` on its
embed dimension, as ``tests/test_models.py`` checks the JAX model; and
NotImplementedError for a tensor-parallel mesh.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import torch_mesh_ranks  # noqa: E402
from ray_tpu import models as jax_models  # noqa: E402
from ray_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from ray_tpu.parallel.sharding import (  # noqa: E402
    logical_to_mesh as jax_logical_to_mesh,
    shard_params as jax_shard_params,
)
from ray_tpu_torch import models  # noqa: E402
from ray_tpu_torch.parallel import MeshSpec, logical_to_mesh  # noqa: E402
from ray_tpu_torch.parallel.dryrun import spawn  # noqa: E402
from ray_tpu_torch.parallel.mesh import CANONICAL_ORDER  # noqa: E402
from ray_tpu_torch.parallel.sharding import (  # noqa: E402
    logical_axes_for,
    mesh_axes,
)

_ID = 2 ** 17          # flat indices below it; leaf numbers above


def _shape_mesh(axes: dict):
    """A mesh as the rule functions read it: its ``shape`` only."""
    return types.SimpleNamespace(shape={a: axes.get(a, 1)
                                        for a in CANONICAL_ORDER})


def test_mesh_spec_resolution():
    assert MeshSpec(dp=-1).resolve(8) == {
        "pp": 1, "dp": 8, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1}
    assert MeshSpec(dp=2, tp=4).resolve(8)["tp"] == 4
    assert MeshSpec(dp=3).resolve(8)["dp"] == 3
    assert MeshSpec(dp=2, sp=2, squeeze=True).resolve(4) == {"dp": 2,
                                                             "sp": 2}
    with pytest.raises(ValueError):
        MeshSpec(dp=16).resolve(8)
    with pytest.raises(ValueError):
        MeshSpec(dp=-1, tp=-1).resolve(8)
    with pytest.raises(ValueError):
        MeshSpec(dp=-1, tp=3).resolve(8)
    with pytest.raises(ValueError):
        MeshSpec(dp=0).resolve(8)


def test_logical_to_mesh_matches_jax():
    axes = {"dp": 2, "tp": 4}
    mesh = _shape_mesh(axes)
    jmesh = jax_make_mesh(axes)
    for logical in [("batch", "seq", "heads"), ("mlp", "heads"),
                    ("embed", None, "heads", None), ("vocab", "embed"), ()]:
        spec = tuple(jax_logical_to_mesh(logical, jmesh))
        assert mesh_axes(logical, mesh) == spec, logical
        want = tuple(Shard(spec.index(a)) if a in spec else Replicate()
                     for a in mesh.shape)
        assert logical_to_mesh(logical, mesh) == want, logical
    # an axis shards one dimension only
    assert logical_to_mesh(("mlp", "heads"), mesh)[-1] == Shard(0)


def _marker_tree(tree):
    """Each leaf of a flax tree filled with ``leaf number · 2^17 + flat
    index``, exact in float32; and the leaves' paths and shapes by
    number."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    assert len(leaves) < 2 ** 24 // _ID
    marked, paths = [], []
    for i, (path, leaf) in enumerate(leaves):
        assert leaf.size < _ID and leaf.dtype == np.float32
        marked.append((i * _ID + np.arange(leaf.size, dtype=np.float64))
                      .astype(np.float32).reshape(leaf.shape))
        paths.append((path, leaf.shape))
    return jax.tree_util.tree_unflatten(treedef, marked), paths


def _strides(shape) -> list[int]:
    return [int(np.prod(shape[i + 1:])) for i in range(len(shape))]


def _dim_map(values: np.ndarray, leaf_shape) -> dict[int, int]:
    """Port dimension -> flax dimension, from the flat flax indices the
    port tensor holds."""
    idx = (values.astype(np.int64) % _ID)
    flax_strides = _strides(leaf_shape)
    out = {}
    for j, n in enumerate(values.shape):
        if n == 1:
            continue
        step = [0] * values.ndim
        step[j] = 1
        delta = int(idx[tuple(step)] - idx.flat[0])
        out[j] = next(i for i, s in enumerate(flax_strides)
                      if s == delta and leaf_shape[i] == n)
    return out


MODELS = {
    "gpt2": (jax_models.GPT2, jax_models.GPT2Config, models.GPT2,
             models.GPT2Config, {}),
    "llama": (jax_models.Llama, jax_models.LlamaConfig, models.Llama,
              models.LlamaConfig, {"tie_embeddings": False}),
    "vit": (jax_models.ViT, jax_models.ViTConfig, models.ViT,
            models.ViTConfig, {}),
    "moe": (jax_models.MoETransformer, jax_models.MoEConfig,
            models.MoETransformer, models.MoEConfig, {}),
}


@functools.lru_cache(maxsize=None)
def _jax_tree(name):
    """The flax params of a tiny model and the port's model to load them
    into (loading the same markers again is harmless)."""
    if name == "resnet":
        jm = jax_models.ResNet(jax_models.ResNet50Config.tiny())
        return jm.init_variables(jax.random.key(0), 32)["params"], \
            models.ResNet(models.ResNet50Config.tiny(), device="cpu")
    jcls, jcfg, cls, cfg, kw = MODELS[name]
    params = jcls(jcfg.tiny(**kw)).init_params(jax.random.key(0))
    return params, cls(cfg.tiny(**kw), device="cpu")


@pytest.mark.parametrize("axes", [{"fsdp": 2, "tp": 2},
                                  {"fsdp": 2, "ep": 2}],
                         ids=["fsdp2_tp2", "fsdp2_ep2"])
@pytest.mark.parametrize("name", ["gpt2", "llama", "vit", "resnet", "moe"])
def test_every_parameter_on_the_axes_of_its_flax_counterpart(name, axes):
    params, model = _jax_tree(name)
    jspecs = jax.tree_util.tree_leaves(
        jax_shard_params(params, jax_make_mesh(axes)),
        is_leaf=lambda x: hasattr(x, "spec"))
    marked, paths = _marker_tree(jax.tree_util.tree_map(np.asarray,
                                                        params))
    model.load_jax_params(marked)
    mesh = _shape_mesh(axes)
    seen = set()
    for pname, p in model.named_parameters():
        values = p.detach().numpy()
        leaf = int(values.flat[0]) // _ID
        assert (values.astype(np.int64) // _ID == leaf).all(), pname
        seen.add(leaf)
        spec = tuple(jspecs[leaf].spec)
        spec += (None,) * (len(paths[leaf][1]) - len(spec))
        ours = mesh_axes(logical_axes_for(pname, p.dim()), mesh)
        ours += (None,) * (p.dim() - len(ours))
        dims = _dim_map(values, paths[leaf][1])
        for j in range(p.dim()):
            want = spec[dims[j]] if j in dims else None
            assert ours[j] == want, (
                f"{pname} dim {j}: port {ours[j]}, flax "
                f"{jax.tree_util.keystr(paths[leaf][0])} {spec}")
    assert seen == set(range(len(paths))), "a flax leaf was not loaded"


@pytest.fixture
def no_torchrun_env(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)


def test_initialize_refuses_a_group_of_another_backend(no_torchrun_env):
    """A process already in a gloo group that asks for the card gets a
    ValueError, not its CUDA tensors carried through host memory by
    gloo; asking for the group's own device keeps the group."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel import initialize, make_mesh
    assert not dist.is_initialized()
    try:
        assert initialize("cpu") == torch.device("cpu")
        assert initialize("cpu") == torch.device("cpu")
        assert dist.get_backend() == "gloo"
        for call in (lambda: initialize("cuda"),
                     lambda: make_mesh({"dp": 1}, device="cuda")):
            with pytest.raises(ValueError, match="gloo process group"):
                call()
    finally:
        dist.destroy_process_group()


def test_initialize_needs_local_rank_for_the_card(no_torchrun_env,
                                                  monkeypatch):
    """Rank 9 of 16 without LOCAL_RANK: its global rank names no card on
    its node, so initialize raises before it joins anything."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel import initialize
    monkeypatch.setenv("RANK", "9")
    monkeypatch.setenv("WORLD_SIZE", "16")
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        initialize("cuda")
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def world():
    return spawn(torch_mesh_ranks.parallel_cases, 4, device="cpu",
                 timeout=180)


def _case(world, name):
    results = [r[name] for r in world]
    for r in results:
        if isinstance(r, dict):
            assert "error" not in r, r.get("error")
    return results


def test_make_mesh_shape_coordinates_and_groups(world):
    for rank, r in enumerate(_case(world, "shapes")):
        assert r["shape"] == {"pp": 1, "dp": 2, "fsdp": 1, "ep": 1,
                              "sp": 2, "tp": 1}
        assert (r["dp"], r["sp"], r["both"]) == (rank // 2, rank % 2, rank)
        assert r["sp_group"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert r["dp_group"] == [rank % 2, rank % 2 + 2]


def test_place_params_broadcasts_rank0_over_dp(world):
    results = _case(world, "dp_broadcast")
    want = models.GPT2(models.GPT2Config.tiny(), device="cpu", seed=0)
    for r in results:
        for name, p in want.named_parameters():
            np.testing.assert_array_equal(r[name], p.detach().numpy())


def test_fsdp_splits_wte_on_embed(world):
    for r in _case(world, "fsdp"):
        assert r["wte.weight"] == ["Shard(dim=1)"]
        assert r["wpe.weight"] == ["Shard(dim=1)"]
        assert r["h.0.attn.qkv_kernel"] == ["Shard(dim=0)"]
        assert r["h.0.mlp.fc.weight"] == ["Shard(dim=1)"]
        assert r["h.0.mlp.proj.weight"] == ["Shard(dim=0)"]
        assert r["h.0.ln_1.scale"] == "replicated"
        assert r["h.0.attn.qkv_bias"] == "replicated"


def test_forced_fsdp_beside_dp_matches_plain_data_parallel(world):
    """FSDP2 forced on a size-1 fsdp axis beside dp = 4 (HSDP: a
    replicate dimension of 4) shards ``wte`` on embed and takes the same
    step as plain data parallelism: the loss and gradient norm within
    float32 summation order, the parameters after one AdamW step within
    2e-4, the AdamW drift of ``tests/test_torch_train_step.py`` (Adam
    divides each entry by its own RMS, so a summation-order difference in
    a tiny gradient moves its update by far more than the difference)."""
    for r in _case(world, "hsdp"):
        dp, forced = r[False], r[True]
        assert dp["wte"] == [] and forced["wte"] == ["Replicate()",
                                                     "Shard(dim=1)"]
        np.testing.assert_allclose(forced["loss"], dp["loss"], rtol=1e-6)
        np.testing.assert_allclose(forced["grad_norm"], dp["grad_norm"],
                                   rtol=1e-5)
        for name, p in dp["params"].items():
            np.testing.assert_allclose(forced["params"][name], p, atol=2e-4,
                                       err_msg=name)


def test_tensor_parallel_placement_raises(world):
    for r in _case(world, "tp_raises"):
        assert "ROADMAP §1" in r
