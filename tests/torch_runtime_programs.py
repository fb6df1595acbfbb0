"""Small user programs of the core runtime and the trainer's loops, each
run once on ``ray_tpu`` and once on ``ray_tpu_torch``
(tests/test_torch_runtime.py, tests/test_torch_trainer.py).

Every program takes the package module (``rt``) and uses only its public
API, so the same code runs on both. Nothing here imports either package
at module level: a worker that unpickles one of these functions loads
numpy and the package it runs in, and nothing of the other.
"""

from __future__ import annotations

import os
import time

import numpy as np

# -- the runtime table --------------------------------------------------


def one_task(rt):
    @rt.remote
    def double(x):
        return 2 * x
    return rt.get(double.remote(21))


def fifty_tasks(rt):
    @rt.remote
    def square(x):
        return x * x
    return rt.get([square.remote(i) for i in range(50)])


def shm_return(rt):
    """A 1 MiB numpy return travels through the shared-memory store."""
    @rt.remote
    def big(seed):
        return np.random.default_rng(seed).integers(
            0, 255, 1 << 20, dtype=np.uint8)
    ref = big.remote(3)
    arr = rt.get(ref)
    from importlib import import_module
    runtime = import_module(rt.__name__ + ".core.api").get_runtime()
    want = np.random.default_rng(3).integers(0, 255, 1 << 20,
                                            dtype=np.uint8)
    return (arr.nbytes, bool(np.array_equal(arr, want)),
            runtime._obj_locations.get(ref.id))


def ref_arguments(rt):
    @rt.remote
    def add(a, b):
        return a + b
    x = rt.put(np.arange(10))
    y = add.remote(x, 5)
    z = add.remote(y, add.remote(1, 2))
    return rt.get(z).tolist()


def wait_timeout(rt):
    @rt.remote
    def quick():
        return "quick"

    @rt.remote
    def slow():
        time.sleep(4.0)
        return "slow"
    fast, lazy = quick.remote(), slow.remote()
    rt.get(fast)
    ready, rest = rt.wait([fast, lazy], num_returns=2, timeout=1.0)
    return ([rt.get(r) for r in ready], len(rest), rest[0] is lazy)


def remote_exception(rt):
    @rt.remote
    def fails_deep_inside(x):
        raise ValueError(f"bad input {x}")
    return rt.get(fails_deep_inside.remote(7))


def actor_state(rt):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def add(self, k):
            self.n += k
            return self.n
    c = Counter.remote(10)
    return rt.get([c.add.remote(i) for i in range(5)])


def killed_actor(rt):
    @rt.remote
    class Box:
        def ping(self):
            return "pong"
    b = Box.remote()
    assert rt.get(b.ping.remote()) == "pong"
    rt.kill(b)
    return rt.get(b.ping.remote(), timeout=30)


def named_actor(rt):
    @rt.remote
    class Registry:
        def __init__(self):
            self.items = []

        def add(self, x):
            self.items.append(x)
            return len(self.items)

        def all(self):
            return list(self.items)
    Registry.options(name="parity_registry").remote()
    handle = rt.get_actor("parity_registry")
    rt.get([handle.add.remote(i) for i in "abc"])
    return rt.get(rt.get_actor("parity_registry").all.remote())


def strict_pack_group(rt):
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}],
                            strategy="STRICT_PACK")
    assert pg.ready(timeout=60)

    @rt.remote
    def node_of(i):
        return i, os.environ.get("RAY_TPU_NODE_ID", "")
    from importlib import import_module
    strategy = import_module(rt.__name__ + ".core.placement_group"
                             ).PlacementGroupSchedulingStrategy
    out = rt.get([node_of.options(
        scheduling_strategy=strategy(pg, placement_group_bundle_index=i)
    ).remote(i) for i in range(2)])
    rt.remove_placement_group(pg)
    return [i for i, _ in out], len({n for _, n in out})


TABLE = {f.__name__: f for f in (
    one_task, fifty_tasks, shm_return, ref_arguments, wait_timeout,
    remote_exception, actor_state, killed_actor, named_actor,
    strict_pack_group)}


def local_mode(rt):
    """Tasks, an actor and an error under ``init(local_mode=True)``."""
    @rt.remote
    def inc(x):
        return x + 1

    @rt.remote
    class Acc:
        def __init__(self):
            self.total = 0

        def add(self, x):
            self.total += x
            return self.total

    @rt.remote
    def boom():
        raise KeyError("local")
    a = Acc.remote()
    out = [rt.get(inc.remote(1)), rt.get([a.add.remote(i)
                                          for i in range(4)])]
    try:
        rt.get(boom.remote())
    except Exception as e:  # noqa: BLE001 — the class is the reading
        out.append(type(e).__name__)
    return out


def run(program, rt) -> tuple:
    """("ok", value) or ("raised", class name, traceback text)."""
    try:
        return ("ok", program(rt))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))


# -- port-only probes ---------------------------------------------------


def workers_left(timeout: float = 15.0,
                 kinds: tuple = ("core.worker_entry",)) -> list[str]:
    """Command lines of this process's children that are still runtime
    workers (``...core.worker_entry``, or the other ``kinds``) once
    ``timeout`` has passed: a shut-down runtime of either package leaves
    none behind."""
    def children() -> list[str]:
        me, out = os.getpid(), []
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{pid}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode()
            except (OSError, ValueError, IndexError):
                continue
            if ppid == me and any(k in cmd for k in kinds):
                out.append(f"{pid}: {cmd}")
        return out
    deadline = time.monotonic() + timeout
    while (left := children()) and time.monotonic() < deadline:
        time.sleep(0.1)
    return left


def worker_view():
    """What a worker sees: its CUDA_VISIBLE_DEVICES, get_gpu_ids(), and
    the packages it has imported."""
    import sys

    import ray_tpu_torch
    return {"cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "gpu_ids": ray_tpu_torch.get_gpu_ids(),
            "ray_tpu": sorted(m for m in sys.modules
                              if m.split(".")[0] == "ray_tpu"),
            "torch": "torch" in sys.modules}


def echo(x):
    return x


# -- trainer loops --------------------------------------------------------

LR, WD = 1e-3, 0.1


def write_marker(path: str) -> str:
    """A task's visible effect: it writes ``path``."""
    with open(path, "w") as f:
        f.write("ran")
    return path


def gated_marks(root: str, i: int) -> int:
    """Note a start in ``root``, wait until ``root``/open exists, note the
    end, and return ``i``: a task whose body ran to its end shows it."""
    import uuid
    open(os.path.join(root, f"start-{i}-{uuid.uuid4().hex}"), "w").close()
    while not os.path.exists(os.path.join(root, "open")):
        time.sleep(0.01)
    open(os.path.join(root, f"done-{i}-{uuid.uuid4().hex}"), "w").close()
    return i


def lm_batch(vocab: int, seq: int, bsz: int = 4, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (bsz, seq)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1)}


def _save_step(train, directory_fn, step: int) -> None:
    """A checkpoint of the loop's position, reported by every rank."""
    import json
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        directory_fn(d)
        with open(os.path.join(d, "position.json"), "w") as f:
            json.dump({"step": step}, f)
        train.report({"step": step}, checkpoint=train.Checkpoint
                     .from_directory(d))


def jax_gpt2_loop(config):
    """The JAX GPT-2 tiny loop (float32, optax AdamW) from the given
    numpy weights, one report a step, a checkpoint at the end."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu import train
    from ray_tpu.models import GPT2, GPT2Config
    from ray_tpu.models.gpt2 import gpt2_loss_fn
    from ray_tpu.train.checkpoint import save_pytree

    model = GPT2(GPT2Config.tiny(dtype=jnp.float32))
    params = jax.tree_util.tree_map(jnp.asarray, config["params"])
    opt = optax.adamw(LR, weight_decay=WD, mu_dtype=jnp.bfloat16)
    state = train.init_train_state(params, opt)
    step = train.make_train_step(gpt2_loss_fn(model, ce_chunk=64), opt)
    for i in range(config["steps"]):
        state, m = step(state, config["batch"])
        train.report({"loss": float(m["loss"]), "step": i})
    _save_step(train, lambda d: save_pytree(state.params,
                                            os.path.join(d, "params")),
               config["steps"])


def torch_gpt2_steps(config, report):
    """The port's GPT-2 tiny steps from the JAX loop's numpy weights:
    float32, AdamW, the mesh over every rank of the default group (dp),
    ``report(metrics)`` once a step. Returns the train state."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
    from ray_tpu_torch.parallel import initialize, make_mesh

    torch.set_num_threads(1)
    device = initialize(config.get("device"))
    mesh = make_mesh({"dp": -1}, device=device)
    model = GPT2(GPT2Config.tiny(dtype=torch.float32), device=device)
    model.load_jax_params(config["params"])
    opt = train.adamw(LR, weight_decay=WD, mu_dtype=torch.bfloat16)
    state = train.init_train_state(model, opt, mesh=mesh)
    step = train.make_train_step(gpt2_loss_fn(ce_chunk=64), opt)
    batch = train.shard_batch(config["batch"], mesh)
    for i in range(config["steps"]):
        state, m = step(state, batch)
        report({"loss": float(m["loss"]), "step": i})
    return state


def torch_gpt2_loop(config):
    """``torch_gpt2_steps`` under ``TorchTrainer``: each step reported,
    the train state checkpointed at the end."""
    from ray_tpu_torch import train
    state = torch_gpt2_steps(config, train.report)
    _save_step(train, lambda d: train.save_train_state(
        state, os.path.join(d, "params")), config["steps"])


def torch_gpt2_rank(config):
    """``torch_gpt2_steps``' losses on one rank of a world that
    ``parallel.dryrun.spawn`` made: no trainer, no runtime."""
    losses = []
    torch_gpt2_steps(config, lambda m: losses.append(m["loss"]))
    return losses


def crash_once_loop(config):
    """Reports steps 0..steps-1 with a checkpoint each; the first attempt
    dies at ``crash_at``. A restored attempt resumes after the step its
    checkpoint holds. Runs on either package (``config["pkg"]``)."""
    import importlib
    import json
    import tempfile

    train = importlib.import_module(config["pkg"] + ".train")
    ctx = train.get_context()
    start = 0
    restored = train.get_checkpoint()
    if restored is not None:
        with open(os.path.join(restored.to_directory(),
                               "position.json")) as f:
            start = json.load(f)["step"] + 1
    for i in range(start, config["steps"]):
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "position.json"), "w") as f:
                json.dump({"step": i}, f)
            train.report({"step": i, "resumed": restored is not None,
                          "rank": ctx.world_rank},
                         checkpoint=train.Checkpoint.from_directory(d))
        if i == config["crash_at"] and restored is None:
            raise RuntimeError("planted failure")
