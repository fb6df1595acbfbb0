"""The port's ViT on a sequence-parallel (``sp``) mesh against the JAX
package's, on eight gloo ranks on the CPU.

ViT's T (17 for the tiny config, 197 for ViT-B/16) does not divide the
``sp`` ranks: the port pads the embedded sequence at its end to ``sp``
blocks of ``ceil(T / sp)`` rows and runs the bidirectional ring over the
blocks' valid rows (``models/vit.py``). The tiny config's 17 tokens make
blocks of 5 on ``dp 2 × sp 4`` (the last holds 2) and of 3 on ``sp 8``
(the last two hold none: the ring's hops from them launch nothing).

One world of 8 ranks (``ray_tpu_torch.parallel.dryrun.spawn``) runs
``torch_mesh_ranks.vit_sp_cases`` from the JAX model's own
initialisation and numpy-seeded batches. The test process holds each
rank's results against the JAX model on a mesh of the same shape on the
8 virtual CPU devices (``tests/conftest.py``), in float32:

- the eval logits of each rank's rows within LOGIT_TOL;
- two SGD steps at lr 0.1: each step's loss within LOSS_RTOL and gradient
  norm within GNORM_RTOL, every rank's parameters within PARAM_TOL;
- three planted faults (``torch_mesh_ranks.VIT_SP_FAULTS``), each of
  which must miss the JAX parameters by ten times PARAM_TOL on every
  rank: padded keys unmasked, gradients not summed over ``sp``, and the
  CLS token taken from each rank's first row.

The limits are those of tests/test_torch_vision_tp.py. The padded split
needs no wider one: the ring merges its hops' softmax in float32, which
moves the logits by ~1e-6 (read on this host) against the single
softmax of ``jax.nn.dot_product_attention``.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import torch_mesh_ranks  # noqa: E402
from ray_tpu.models.vit import ViT as JaxViT  # noqa: E402
from ray_tpu.models.vit import ViTConfig as JaxViTConfig  # noqa: E402
from ray_tpu.models.vit import vit_loss_fn as jax_vit_loss_fn  # noqa: E402
from ray_tpu.parallel import make_mesh  # noqa: E402
from ray_tpu.train import (  # noqa: E402
    init_train_state as jax_init_train_state,
    make_train_step as jax_make_train_step,
    shard_batch as jax_shard_batch,
)
from ray_tpu_torch.models import ViT, ViTConfig  # noqa: E402
from ray_tpu_torch.models.vit import seq_blocks  # noqa: E402
from ray_tpu_torch.parallel.dryrun import spawn  # noqa: E402

LOGIT_TOL = 1e-4
LOSS_RTOL, GNORM_RTOL = 2e-5, 2e-3
PARAM_TOL = 1e-5
STEPS = 2
MESHES = torch_mesh_ranks.VIT_SP_MESHES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    model = JaxViT(JaxViTConfig.tiny(dtype=jnp.float32))
    params = model.init_params(jax.random.key(4))
    rng = np.random.default_rng(16)
    batches = [{
        "images": rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
        "labels": rng.integers(0, 10, (8,)).astype(np.int32)}
        for _ in range(STEPS)]
    return {"model": model, "params": params,
            "inputs": {"vit_params": _np_tree(params),
                       "vit_batches": batches}}


@pytest.fixture(scope="module")
def world(setup):
    return spawn(torch_mesh_ranks.vit_sp_cases, 8, (setup["inputs"],),
                 device="cpu", timeout=300)


def _case(world, name):
    results = [r[name] for r in world]
    for r in results:
        assert "error" not in r, r.get("error")
    return results


_JAX: dict = {}


def _jax(setup, mesh_name):
    """The JAX steps on the mesh: per-step metrics and the final
    parameters in the port's names and layouts."""
    if mesh_name not in _JAX:
        mesh = make_mesh(MESHES[mesh_name])
        model = setup["model"]
        state = jax_init_train_state(setup["params"], optax.sgd(0.1), mesh)
        step = jax_make_train_step(jax_vit_loss_fn(model), optax.sgd(0.1))
        metrics = []
        for batch in setup["inputs"]["vit_batches"]:
            state, m = step(state, jax_shard_batch(batch, mesh))
            metrics.append({k: float(v) for k, v in m.items()})
        port = ViT(ViTConfig.tiny(dtype=torch.float32), device="cpu")
        port.load_jax_params(_np_tree(state.params))
        _JAX[mesh_name] = (metrics, {n: p.detach().numpy()
                                     for n, p in port.named_parameters()})
    return _JAX[mesh_name]


def _param_err(r, want: dict) -> float:
    """The largest |difference| of a rank's parameters from the JAX ones,
    absolute, as tests/test_torch_vision_tp.py holds ViT (its key biases
    have a zero gradient in exact arithmetic and stay near zero)."""
    return max(float(np.abs(r["params"][name][0] - w).max())
               for name, w in want.items())


@pytest.mark.parametrize("t,n,block,lengths", [
    (17, 4, 5, (5, 5, 5, 2)), (17, 8, 3, (3, 3, 3, 3, 3, 2, 0, 0)),
    (197, 4, 50, (50, 50, 50, 47)), (197, 8, 25, (25,) * 7 + (22,)),
    (16, 4, 4, (4,) * 4)])
def test_seq_blocks_pad_the_last_blocks(t, n, block, lengths):
    assert seq_blocks(t, n) == (block, lengths)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sp_logits_match_jax(world, setup, mesh_name):
    images = setup["inputs"]["vit_batches"][0]["images"]
    want = np.asarray(setup["model"].apply({"params": setup["params"]},
                                           images))
    rows = want.shape[0] // MESHES[mesh_name].get("dp", 1)
    for r in _case(world, f"logits_{mesh_name}"):
        i = r["dp"]
        np.testing.assert_allclose(r["logits"], want[i * rows:(i + 1) * rows],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sp_sgd_steps_match_jax(world, setup, mesh_name):
    jmetrics, want = _jax(setup, mesh_name)
    for r in _case(world, f"train_{mesh_name}"):
        for got_m, want_m in zip(r["metrics"], jmetrics, strict=True):
            np.testing.assert_allclose(got_m["loss"], want_m["loss"],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(got_m["grad_norm"],
                                       want_m["grad_norm"], rtol=GNORM_RTOL)
        err = _param_err(r, want)
        assert err < PARAM_TOL, f"largest parameter difference {err:.3g}"


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("fault", list(torch_mesh_ranks.VIT_SP_FAULTS))
def test_planted_fault_fails_the_tolerance(world, setup, fault, mesh_name):
    _, want = _jax(setup, mesh_name)
    for r in _case(world, f"fault_{fault}_{mesh_name}"):
        err = _param_err(r, want)
        print(f"{fault} on {mesh_name}: largest parameter difference "
              f"{err:.3g}")
        assert err > 10 * PARAM_TOL
