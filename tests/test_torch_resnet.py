"""The port's ResNet against the JAX package's, on shared weights.

The flax variables of ``ray_tpu.models.ResNet`` (``ResNet50Config.tiny``:
two stages of one bottleneck each, width 16) are carried into
``ray_tpu_torch.models.ResNet`` by ``load_jax_params``; both get the same
numpy-seeded images on the CPU. At 32x32 every ``SAME`` padding that
matters is uneven: the 7x7/2 stem pads (2, 3), the max pool (0, 1) and the
stride-2 3x3 convolution (0, 1). At 33x33 they are even and the maps are
odd-sized.

Tolerances. In float32 only summation order differs: logits 1e-5
absolute (they are O(1)); each new running statistic within 2e-5 of its
layer's largest (the fast variance E[x²] − E[x]² in float32 loses a few
units in the last place); the loss 1e-6 relative; every gradient within
1e-4 of its JAX counterpart's largest entry (a BatchNorm over two images
of 4x4 divides by a small variance, which grows the rounding of its
inputs). Those limits fail a model that pads the stem, the pool or the
stride-2 convolution evenly, or keeps the unbiased running variance: the
mutation tests below hold each of these against the limit it must
break. The 3-step SGD-Nesterov trajectory through
``make_multi_train_step(has_extra=True)`` against optax under
``ray_tpu.train``: parameters within 1e-5 of their layer's largest entry
and running statistics within 2e-5, after three steps at lr 0.1. In
bfloat16 (the default compute type) the two frameworks round at
different points: logits within 5e-2 in relative norm.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models.resnet import (  # noqa: E402
    ResNet as JaxResNet,
    ResNet50Config as JaxResNet50Config,
    resnet_loss_fn as jax_resnet_loss_fn,
)
from ray_tpu.train import (  # noqa: E402
    init_train_state as jax_init_train_state,
    make_multi_train_step as jax_make_multi_train_step,
)
from ray_tpu_torch.models import ResNet, ResNet50Config, resnet_loss_fn  # noqa: E402
from ray_tpu_torch.models import resnet as resnet_mod  # noqa: E402
from ray_tpu_torch.models.resnet import BN_MOMENTUM, same_pads  # noqa: E402
from ray_tpu_torch.train import (  # noqa: E402
    init_train_state,
    make_multi_train_step,
    sgd,
)

SIZES = (32, 33)
LOGIT_TOL = 1e-5
STATS_TOL = 2e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module. Tier-1 runs six test processes on
    one host, so more threads would only starve timing-sensitive runtime
    tests in the others; and a second OpenMP thread's first ``exp`` in a
    process has come out at reduced precision on an AMX CPU with
    torch 2.13 (ROADMAP §3), so the plain versions run on the main thread
    only."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree) -> dict[str, np.ndarray]:
    """A flax tree as ``{"a.b.c": array}``, the port's state-dict names."""
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturb_norms(params, seed: int):
    """BatchNorm scales 1 + 0.2 N(0, 1) and biases 0.1 N(0, 1): at init
    ``bn3``'s scale is 0, which zeroes the gradients of its block's first
    convolutions on both sides and would leave them untested."""
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        key = path[-1].key
        if not path[-2].key.startswith("bn"):
            return leaf
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return jnp.asarray(1 + 0.2 * noise if key == "scale" else 0.1 * noise)

    return jax.tree_util.tree_map_with_path(fix, params)


def _pair(size: int, dtype=jnp.float32, tdtype=torch.float32, seed=0,
          perturb: bool = False):
    jmodel = JaxResNet(JaxResNet50Config.tiny(dtype=dtype))
    variables = dict(jmodel.init_variables(jax.random.key(seed), size))
    if perturb:
        variables["params"] = _perturb_norms(variables["params"], seed)
    model = ResNet(ResNet50Config.tiny(dtype=tdtype), device="cpu")
    model.load_jax_params(_np_tree(variables["params"]),
                          _np_tree(variables["batch_stats"]))
    return jmodel, variables, model


def _batch(size: int, b: int = 2, seed: int = 0, k: int | None = None):
    rng = np.random.default_rng(seed)
    lead = (b,) if k is None else (k, b)
    return {"image": rng.standard_normal(lead + (size, size, 3))
            .astype(np.float32),
            "label": rng.integers(0, 10, lead).astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _train_apply(jmodel, variables, image):
    logits, mutated = jmodel.apply(variables, image, train=True,
                                   mutable=["batch_stats"])
    return np.asarray(logits), _flat(mutated["batch_stats"])


def _stats_err(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    return max(float(np.abs(np.asarray(got[k]) - want[k]).max()
                     / np.abs(want[k]).max()) for k in want)


def test_config_presets_match():
    for name in ("resnet18", "tiny"):
        ours = dataclasses.asdict(getattr(ResNet50Config, name)())
        ref = dataclasses.asdict(getattr(JaxResNet50Config, name)())
        for field in ("dtype", "param_dtype"):
            ours.pop(field)
            ref.pop(field)
        assert ours == ref, name
    assert dataclasses.asdict(ResNet50Config())["stage_sizes"] == (3, 4, 6, 3)


@pytest.mark.parametrize("size,kernel,stride,want", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)), (33, 7, 2, (3, 3)),
    (17, 3, 2, (1, 1)), (224, 16, 16, (0, 0))])
def test_same_pads_match_lax(size, kernel, stride, want):
    from jax import lax
    assert same_pads(size, kernel, stride) == want
    assert lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME") \
        == [want]


@pytest.mark.parametrize("size", SIZES)
def test_train_logits_and_new_batch_stats_match(size):
    jmodel, variables, model = _pair(size)
    image = _batch(size)["image"]
    want_logits, want_stats = _train_apply(jmodel, variables, image)
    before = {k: v.clone() for k, v in model.batch_stats().items()}
    with torch.no_grad():
        logits, new_stats = model(torch.from_numpy(image), train=True)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=LOGIT_TOL,
                               rtol=0)
    assert _stats_err({k: v.numpy() for k, v in new_stats.items()},
                      want_stats) < STATS_TOL
    # Functional in training: no buffer was written.
    for name, buf in model.batch_stats().items():
        assert torch.equal(buf, before[name]), name


@pytest.mark.parametrize("size", SIZES)
def test_eval_logits_read_the_running_statistics(size):
    jmodel, variables, model = _pair(size, seed=1)
    # Running statistics that are not the initial ones: one train pass's.
    stats_tree = _np_tree(jmodel.apply(
        variables, _batch(size, seed=2)["image"], train=True,
        mutable=["batch_stats"])[1]["batch_stats"])
    model.load_jax_params(_np_tree(variables["params"]), stats_tree)
    image = _batch(size, seed=3)["image"]
    want = np.asarray(jmodel.apply(
        {"params": variables["params"], "batch_stats": stats_tree}, image,
        train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(image))
        initial = model(torch.from_numpy(image), batch_stats={
            k: (torch.zeros_like(v) if k.endswith(".mean")
                else torch.ones_like(v))
            for k, v in model.batch_stats().items()})
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=0)
    assert float((got - initial).abs().max()) > 100 * LOGIT_TOL


@pytest.mark.parametrize("size", SIZES)
def test_loss_and_every_gradient_match(size):
    jmodel, variables, model = _pair(size, seed=4, perturb=True)
    batch = _batch(size, seed=5)
    (loss_ref, _), grads_ref = jax.value_and_grad(
        jax_resnet_loss_fn(jmodel), has_aux=True)(
            variables["params"], variables["batch_stats"], batch)
    loss, new_stats = resnet_loss_fn()(model, model.batch_stats(),
                                       _torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-6)
    assert not any(v.requires_grad for v in new_stats.values())
    ref = ResNet(ResNet50Config.tiny(dtype=torch.float32), device="cpu")
    ref.load_jax_params(_np_tree(grads_ref))
    ref = dict(ref.named_parameters())
    names = [n for n, _ in model.named_parameters()]
    assert names == list(ref)
    for name, p in model.named_parameters():
        want = ref[name].detach()
        err = float((p.grad - want).abs().max() / want.abs().max())
        assert err < GRAD_TOL, f"grad of {name}: {err:.3g} >= {GRAD_TOL}"


def test_symmetric_same_padding_fails_the_logit_tolerance(monkeypatch):
    """At 32x32 an even split of the stem's, the pool's and the stride-2
    convolution's padding shifts their windows by one pixel: far outside
    the logit tolerance."""
    jmodel, variables, model = _pair(32)
    image = _batch(32)["image"]
    want, _ = _train_apply(jmodel, variables, image)

    def even(size, kernel, stride):
        lo, hi = same_pads(size, kernel, stride)
        return (hi, hi)

    monkeypatch.setattr(resnet_mod, "same_pads", even)
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(image), train=True)
    assert float(np.abs(logits.numpy() - want).max()) > 100 * LOGIT_TOL


def test_unbiased_running_variance_fails_the_stats_tolerance():
    """``nn.BatchNorm2d`` averages n/(n-1) times the batch variance into
    its running variance; on these maps (n = 2 * 4 * 4 at the last stage)
    that is far outside the statistics tolerance."""
    jmodel, variables, model = _pair(32)
    image = _batch(32)["image"]
    _, want = _train_apply(jmodel, variables, image)
    captured = {}

    def capture(module, args, out):
        x = args[0].float()
        n = x.numel() // x.shape[1]
        var = x.var((0, 2, 3), correction=1)
        captured[f"{module.path}.var"] = (
            BN_MOMENTUM * module.var + (1 - BN_MOMENTUM) * var).numpy()
        captured[f"{module.path}.mean"] = want[f"{module.path}.mean"]
        assert n > 1

    for m in model.modules():
        if isinstance(m, resnet_mod.BatchNorm):
            m.register_forward_hook(capture)
    with torch.no_grad():
        model(torch.from_numpy(image), train=True)
    assert _stats_err(captured, want) > 10 * STATS_TOL


def test_sgd_nesterov_trajectory_matches_jax():
    """Three steps in one dispatch, lr 0.1, momentum 0.9, Nesterov:
    parameters and running statistics against ``ray_tpu.train``'s
    ``make_multi_train_step(has_extra=True)`` with ``optax.sgd``."""
    size = 32
    jmodel, variables, model = _pair(size, seed=6, perturb=True)
    stack = _batch(size, seed=7, k=3)
    jopt = optax.sgd(0.1, momentum=0.9, nesterov=True)
    jstate = jax_init_train_state(variables["params"], jopt,
                                  extra=variables["batch_stats"])
    jstep = jax_make_multi_train_step(jax_resnet_loss_fn(jmodel), jopt,
                                      has_extra=True, grad_norm=False)
    jstate, jm = jstep(jstate, stack)

    opt = sgd(0.1, momentum=0.9, nesterov=True)
    state = init_train_state(model, opt, extra=model.batch_stats())
    step = make_multi_train_step(resnet_loss_fn(), opt, has_extra=True,
                                 grad_norm=False)
    state, m = step(state, _torch(stack))
    assert state.step == 3
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)

    want_params = _flat(jstate.params)
    for name, p in model.named_parameters():
        flax_name = {"weight": "kernel"}.get(name.split(".")[-1])
        key = (name.rsplit(".", 1)[0] + "." + flax_name if flax_name
               else name)
        want = want_params[key]
        got = p.detach()
        if got.dim() == 4:
            got = got.permute(2, 3, 1, 0)
        elif got.dim() == 2:
            got = got.t()
        err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
        assert err < 1e-5, f"{name} drifted {err:.3g} from the JAX step"
    # state.extra is the module's buffers, written by the step.
    assert all(state.extra[k] is v for k, v in model.batch_stats().items())
    assert _stats_err({k: v.numpy() for k, v in state.extra.items()},
                      _flat(jstate.extra)) < STATS_TOL


def test_bf16_logits_match():
    jmodel, variables, model = _pair(32, dtype=jnp.bfloat16,
                                     tdtype=torch.bfloat16, seed=8)
    image = _batch(32, b=4, seed=9)["image"]
    want, _ = _train_apply(jmodel, variables, image)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(image), train=True)
    rel = float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))
    assert rel < 5e-2, rel


def test_seeded_init_and_param_count():
    cfg = ResNet50Config.tiny(dtype=torch.float32)
    a = ResNet(cfg, device="cpu", seed=5)
    b = ResNet(cfg, device="cpu", seed=5)
    c = ResNet(cfg, device="cpu", seed=6)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.conv_init.weight, c.conv_init.weight)
    block = a.stage0_block0
    assert torch.equal(block.bn3.scale, torch.zeros_like(block.bn3.scale))
    assert torch.equal(block.bn1.scale, torch.ones_like(block.bn1.scale))
    # Stage 0's first block projects at stride 1; stage 1's at stride 2.
    assert block.conv_proj.stride == 1 and a.stage1_block0.conv_proj.stride == 2
    variables = JaxResNet(JaxResNet50Config.tiny()).init_variables(
        jax.random.key(0), 32)
    assert sum(p.numel() for p in a.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(variables["params"]))
    assert sorted(a.batch_stats()) == sorted(_flat(variables["batch_stats"]))
    # lecun_normal: fan-in variance, truncated at two standard deviations.
    w = torch.empty(512, 512, 3, 3)
    fan_in = 512 * 9
    resnet_mod.lecun_normal_(w, fan_in, torch.Generator().manual_seed(0))
    assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.01
    assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6


def test_bad_params_raise():
    _, variables, model = _pair(32)
    bad = _np_tree(variables["params"])
    bad["conv_init"]["kernel"] = bad["stage0_block0"]["conv1"]["kernel"]
    with pytest.raises(ValueError, match="does not fit"):
        model.load_jax_params(bad)
