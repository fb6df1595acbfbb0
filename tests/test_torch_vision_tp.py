"""The port's ViT and ResNet on a ``tp`` mesh (and ResNet on an ``sp``
mesh) against the JAX package's, on four gloo ranks on the CPU.

One world of 4 ranks (``ray_tpu_torch.parallel.dryrun.spawn``) runs every
case of ``torch_mesh_ranks.vision_tp_cases`` from the JAX models' own
initialisation and numpy-seeded batches; the test process holds each
rank's results against the JAX package on a mesh of the same shape on the
virtual CPU devices, where XLA's sharding propagation cuts the weights
by ``ray_tpu.parallel.sharding``'s table (ViT: each block's
``mlp_proj`` rows; ResNet: every convolution's output channels):

- ViT tiny and ResNet tiny (float32 compute) on ``dp 2 × tp 2``: the
  eval-mode logits of each rank's rows within LOGIT_TOL; two SGD steps
  (ViT lr 0.1; ResNet Nesterov, its BatchNorm statistics through the
  step) against the JAX steps: each step's loss within LOSS_RTOL and
  gradient norm within GNORM_RTOL, every rank's block of every parameter
  within PARAM_TOL, and ResNet's running statistics, whole on every rank,
  within STATS_TOL;
- ResNet tiny on ``dp 2 × sp 2``, whose ``sp`` ranks are replicas as in
  the JAX model, the same way;
- three planted faults, each of which must miss the JAX parameters by
  ten times PARAM_TOL on every rank: ResNet's channel gather without the
  sum of the input gradient over tp (``gather_from``, whose backward only
  narrows), BatchNorm's replicated scale and bias without the sum of
  their gradients over tp, and ViT's hidden units taken without
  ``copy_to`` (``fc``'s gradient a partial sum).
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
from ray_tpu.models.resnet import ResNet as JaxResNet  # noqa: E402
from ray_tpu.models.resnet import (  # noqa: E402
    ResNet50Config as JaxResNet50Config,
    resnet_loss_fn as jax_resnet_loss_fn,
)
from ray_tpu.models.vit import ViT as JaxViT  # noqa: E402
from ray_tpu.models.vit import ViTConfig as JaxViTConfig  # noqa: E402
from ray_tpu.models.vit import vit_loss_fn as jax_vit_loss_fn  # noqa: E402
from ray_tpu.parallel import make_mesh  # noqa: E402
from ray_tpu.train import (  # noqa: E402
    init_train_state as jax_init_train_state,
    make_train_step as jax_make_train_step,
    shard_batch as jax_shard_batch,
)
from ray_tpu_torch.models import ResNet, ResNet50Config, ViT, ViTConfig  # noqa: E402
from ray_tpu_torch.parallel.dryrun import spawn  # noqa: E402

# tests/test_torch_mesh_train.py's tolerances for float32 models: logits
# as its float32 Llama's (LLAMA_TOL), loss, gradient norm and running
# statistics as LOSS_RTOL, GNORM_RTOL and STATS_TOL; the parameters after
# SGD as its dp 4 ViT and ResNet steps (1e-5: SGD passes gradient
# differences on at lr 0.1).
LOGIT_TOL = 1e-4
LOSS_RTOL, GNORM_RTOL = 2e-5, 2e-3
STATS_TOL = 2e-5
PARAM_TOL = 1e-5
STEPS = 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree) -> dict[str, np.ndarray]:
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturb_norms(params, seed: int):
    """BatchNorm scales 1 + 0.2 N(0, 1) and biases 0.1 N(0, 1), so that
    no block's gradients are zero at init (``bn3``'s scale is 0)."""
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        if not path[-2].key.startswith("bn"):
            return leaf
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return jnp.asarray(1 + 0.2 * noise if path[-1].key == "scale"
                           else 0.1 * noise)

    return jax.tree_util.tree_map_with_path(fix, params)


@pytest.fixture(scope="module")
def setup():
    s = {"vit": JaxViT(JaxViTConfig.tiny(dtype=jnp.float32)),
         "resnet": JaxResNet(JaxResNet50Config.tiny(dtype=jnp.float32))}
    s["vit_params"] = s["vit"].init_params(jax.random.key(4))
    variables = dict(s["resnet"].init_variables(jax.random.key(3), 32))
    variables["params"] = _perturb_norms(variables["params"], 3)
    s["resnet_variables"] = variables
    rng = np.random.default_rng(12)
    s["inputs"] = {
        "vit_params": _np_tree(s["vit_params"]),
        "resnet_variables": (_np_tree(variables["params"]),
                             _np_tree(variables["batch_stats"])),
        "vit_batches": [{
            "images": rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, (8,)).astype(np.int32)}
            for _ in range(STEPS)],
        "resnet_batches": [{
            "image": rng.standard_normal((16, 32, 32, 3)).astype(np.float32),
            "label": rng.integers(0, 10, (16,)).astype(np.int32)}
            for _ in range(STEPS)],
    }
    return s


@pytest.fixture(scope="module")
def world(setup):
    return spawn(torch_mesh_ranks.vision_tp_cases, 4, (setup["inputs"],),
                 device="cpu", timeout=300)


def _case(world, name):
    results = [r[name] for r in world]
    for r in results:
        if isinstance(r, dict):
            assert "error" not in r, r.get("error")
    return results


def _port_layout(model_cls, config, params) -> dict:
    """JAX parameters in the port's names and layouts."""
    model = model_cls(config, device="cpu")
    model.load_jax_params(_np_tree(params))
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def _jax_run(setup, kind: str, axes: dict):
    """The JAX steps on a mesh of ``axes``: per-step metrics, the final
    parameters in the port's layout and the running statistics."""
    mesh = make_mesh(axes)
    model = setup[kind]
    if kind == "vit":
        state = jax_init_train_state(setup["vit_params"], optax.sgd(0.1),
                                     mesh)
        step = jax_make_train_step(jax_vit_loss_fn(model), optax.sgd(0.1))
    else:
        opt = optax.sgd(0.1, momentum=0.9, nesterov=True)
        variables = setup["resnet_variables"]
        state = jax_init_train_state(variables["params"], opt, mesh,
                                     extra=variables["batch_stats"])
        step = jax_make_train_step(jax_resnet_loss_fn(model), opt,
                                   has_extra=True)
    metrics = []
    for batch in setup["inputs"][f"{kind}_batches"]:
        state, m = step(state, jax_shard_batch(batch, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    if kind == "vit":
        params = _port_layout(ViT, ViTConfig.tiny(dtype=torch.float32),
                              state.params)
        return metrics, params, {}
    params = _port_layout(ResNet, ResNet50Config.tiny(dtype=torch.float32),
                          state.params)
    return metrics, params, _flat(state.extra)


_JAX: dict = {}


def _jax(setup, kind, axes):
    key = (kind, tuple(sorted(axes.items())))
    if key not in _JAX:
        _JAX[key] = _jax_run(setup, kind, axes)
    return _JAX[key]


def _param_err(r, want: dict, kind: str) -> float:
    """The largest |difference| of a rank's blocks from the JAX
    weights': ResNet's relative to each weight's largest entry, as the
    dp 4 ResNet step is held; ViT's absolute, as the dp 4 ViT step is
    (its key biases have a zero gradient in exact arithmetic, so they
    stay near zero)."""
    err = 0.0
    for name, w in want.items():
        block, split = r["params"][name]
        for dim, _, index, size in split:
            n = w.shape[dim] // size
            w = np.take(w, range(index * n, (index + 1) * n), axis=dim)
        scale = np.abs(w).max() if kind == "resnet" else 1.0
        err = max(err, float(np.abs(block - w).max() / scale))
    return err


def _stats_err(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    return max(float(np.abs(np.asarray(got[k]) - want[k]).max()
                     / np.abs(want[k]).max()) for k in want)


@pytest.mark.parametrize("kind", ["vit", "resnet"])
def test_tp_logits_match_jax(world, setup, kind):
    images = setup["inputs"][f"{kind}_batches"][0][
        "images" if kind == "vit" else "image"]
    if kind == "vit":
        want = setup["vit"].apply({"params": setup["vit_params"]}, images)
    else:
        want = setup["resnet"].apply(setup["resnet_variables"], images,
                                     train=False)
    want = np.asarray(want)
    rows = want.shape[0] // 2
    for r in _case(world, f"{kind}_logits"):
        i = r["dp"]
        np.testing.assert_allclose(r["logits"], want[i * rows:(i + 1) * rows],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("case,kind,axes", [
    ("vit_train", "vit", {"dp": 2, "tp": 2}),
    ("resnet_train", "resnet", {"dp": 2, "tp": 2}),
    ("resnet_sp", "resnet", {"dp": 2, "sp": 2}),
], ids=["vit_dp2_tp2", "resnet_dp2_tp2", "resnet_dp2_sp2"])
def test_sgd_steps_match_jax(world, setup, case, kind, axes):
    jmetrics, want, want_stats = _jax(setup, kind, axes)
    for r in _case(world, case):
        for got_m, want_m in zip(r["metrics"], jmetrics, strict=True):
            np.testing.assert_allclose(got_m["loss"], want_m["loss"],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(got_m["grad_norm"],
                                       want_m["grad_norm"], rtol=GNORM_RTOL)
        err = _param_err(r, want, kind)
        assert err < PARAM_TOL, f"largest parameter difference {err:.3g}"
        if want_stats:
            assert _stats_err(r["stats"], want_stats) < STATS_TOL


@pytest.mark.parametrize("fault,kind", [
    ("gather_from", "resnet"), ("norm_params", "resnet"),
    ("vit_fc", "vit")])
def test_missing_tp_sum_fails_the_tolerance(world, setup, fault, kind):
    """Each planted fault (``torch_mesh_ranks.VISION_FAULTS``) drops one
    sum over tp; the parameters after the steps must miss the JAX
    step's by ten times the tolerance on every rank."""
    _, want, _ = _jax(setup, kind, {"dp": 2, "tp": 2})
    for r in _case(world, f"fault_{fault}"):
        err = _param_err(r, want, kind)
        print(f"{fault}: largest parameter difference {err:.3g}")
        assert err > 10 * PARAM_TOL
