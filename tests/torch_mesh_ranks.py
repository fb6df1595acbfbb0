"""The rank side of the port's multi-rank parity tests.

Each ``*_cases`` function runs in every rank of one gloo world that
``ray_tpu_torch.parallel.dryrun.spawn`` starts for a test file
(``tests/test_torch_{parallel,collective,ring_attention,mesh_train,
tensor_parallel,pipeline,checkpoint}.py``):
it runs every case of that file and returns ``{case: result}``, a case
that raises giving its traceback instead. The test process holds each
rank's results against the JAX package. This module imports only torch,
numpy and the port, so that a rank starts without JAX.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import make_mesh


def _run(cases: dict) -> dict:
    out = {}
    for name, fn in cases.items():
        try:
            out[name] = fn()
        except Exception:  # noqa: BLE001 — reported per case
            out[name] = {"error": traceback.format_exc()}
        dist.barrier()
    return out


def _block(x: np.ndarray, dim: int, i: int, n: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return torch.from_numpy(np.ascontiguousarray(
        np.take(x, range(i * size, (i + 1) * size), axis=dim)))


def _raises(fn, exc) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    raise AssertionError(f"no {exc.__name__}")


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------

def parallel_cases() -> dict:
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.parallel.sharding import place_params

    def shapes():
        mesh = make_mesh({"dp": 2, "sp": 2}, device="cpu")
        return {"shape": mesh.shape, "dp": mesh.axis_index("dp"),
                "sp": mesh.axis_index("sp"),
                "both": mesh.axis_index(("dp", "sp")),
                "sp_group": dist.get_process_group_ranks(mesh.group("sp")),
                "dp_group": dist.get_process_group_ranks(mesh.group("dp"))}

    def dp_broadcast():
        mesh = make_mesh({"dp": 4}, device="cpu")
        model = GPT2(GPT2Config.tiny(), device="cpu",
                     seed=dist.get_rank())        # replicas start apart
        place_params(model, mesh)
        return {n: p.detach() for n, p in model.named_parameters()}

    def fsdp():
        from torch.distributed.tensor import DTensor
        mesh = make_mesh({"fsdp": 4}, device="cpu")
        model = GPT2(GPT2Config.tiny(), device="cpu", seed=0)
        place_params(model, mesh)
        out = {}
        for name, p in model.named_parameters():
            if isinstance(p, DTensor):
                out[name] = [repr(pl) for pl in p.placements]
            else:
                out[name] = "replicated"
        return out

    def hsdp():
        """FSDP2 forced on a mesh whose fsdp axis has one rank, beside
        dp = 4 (a replicate dimension of 4): a train step's loss and
        parameters against the same step with plain data parallelism."""
        from torch.distributed.tensor import DTensor
        from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
        from ray_tpu_torch.parallel.sharding import _place_forced
        from ray_tpu_torch.train import (adamw, init_train_state,
                                         make_train_step, shard_batch)
        mesh = make_mesh({"dp": 4}, device="cpu")
        rng = np.random.default_rng(0)
        toks = rng.integers(0, 256, (8, 64))
        batch = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
        out = {}
        for forced in (False, True):
            model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu",
                         seed=0)
            if forced:
                _place_forced(model, mesh, ("fsdp",))
            opt = adamw(1e-3)
            state = init_train_state(model, opt, mesh=mesh)
            step = make_train_step(gpt2_loss_fn(ce_chunk=64), opt)
            state, m = step(state, shard_batch(batch, mesh))
            out[forced] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "wte": [repr(p) for p in getattr(model.wte.weight,
                                                 "placements", [])],
                "params": {n: (p.full_tensor() if isinstance(p, DTensor)
                               else p).detach()
                           for n, p in model.named_parameters()}}
        return out

    def fsdp_tp():
        """GPT-2 tiny on fsdp 2 x tp 2: each parameter's placement, its
        local shape, and its block of rank 0's weights."""
        from torch.distributed.tensor import DTensor
        mesh = make_mesh({"fsdp": 2, "tp": 2}, device="cpu")
        model = GPT2(GPT2Config.tiny(), device="cpu",
                     seed=dist.get_rank())        # replicas start apart
        place_params(model, mesh)
        out = {"tp": mesh.axis_index("tp"), "fsdp": mesh.axis_index("fsdp"),
               "params": {}}
        for name, p in model.named_parameters():
            pl = model.placements[name]
            out["params"][name] = {
                "split": pl.split, "fsdp": pl.fsdp,
                "replicated": pl.replicated,
                "dtensor": isinstance(p, DTensor),
                "block": (p.full_tensor() if isinstance(p, DTensor)
                          else p).detach()}
        return out

    def no_tp_route_raises():
        """A model whose layers declare no tensor-parallel route, with a
        weight the table cuts over tp."""
        class Plain(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.mlp = torch.nn.Module()
                self.mlp.fc = torch.nn.Linear(8, 16)

        mesh = make_mesh({"tp": 4}, device="cpu")
        return _raises(lambda: place_params(Plain(), mesh),
                       NotImplementedError)

    def vision_tp():
        """ViT and ResNet tiny placed on tp 4, replicas started apart:
        each parameter's split and its block."""
        from ray_tpu_torch.models import (ResNet, ResNet50Config, ViT,
                                          ViTConfig)
        mesh = make_mesh({"tp": 4}, device="cpu")
        out = {"tp": mesh.axis_index("tp")}
        for name, model in (
                ("vit", ViT(ViTConfig.tiny(), device="cpu",
                            seed=dist.get_rank())),
                ("resnet", ResNet(ResNet50Config.tiny(), device="cpu",
                                  seed=dist.get_rank()))):
            place_params(model, mesh)
            out[name] = {n: {"split": model.placements[n].split,
                             "block": p.detach()}
                         for n, p in model.named_parameters()}
        return out

    return _run({"shapes": shapes, "dp_broadcast": dp_broadcast,
                 "fsdp": fsdp, "hsdp": hsdp, "fsdp_tp": fsdp_tp,
                 "no_tp_route_raises": no_tp_route_raises,
                 "vision_tp": vision_tp})


# ---------------------------------------------------------------------------
# tests/test_torch_collective.py
# ---------------------------------------------------------------------------

def collective_cases(w: dict) -> dict:
    from ray_tpu_torch.collective import device as coll

    def wrappers():
        mesh = make_mesh({"dp": 4}, device="cpu")
        r = mesh.axis_index("dp")
        x = torch.arange(4.0)[r:r + 1]
        with mesh:
            return {
                "total": coll.allreduce(x, "dp"),
                "mean": coll.allreduce(x, "dp", "mean"),
                "max": coll.allreduce(x, "dp", "max"),
                "idx": coll.axis_index("dp"), "size": coll.axis_size("dp"),
                "gathered": coll.allgather(x, "dp"),
                "tiled": coll.allgather(x, "dp", tiled=True),
                "shifted": coll.ring_shift(x, "dp", 1),
                "perm": coll.ppermute(x, "dp", [(0, 2), (2, 0), (1, 3)]),
                "rs": coll.reducescatter(torch.arange(8.0) * (r + 1), "dp"),
                "a2a": coll.all_to_all(torch.arange(8.0) + 10 * r, "dp"),
                "bcast": coll.broadcast(x, "dp", root=3),
                "barrier": coll.barrier("dp"),
                "fenced": coll.barrier("dp", {"x": x}),
            }

    def compositions():
        mesh = make_mesh({"dp": 2, "tp": 2}, device="cpu")
        i = mesh.axis_index(("dp", "tp"))
        x = torch.arange(16.0)[4 * i:4 * (i + 1)]
        with mesh:
            tp_idx = torch.tensor(float(coll.axis_index("tp")))
            return {
                "direct": coll.allreduce(x, ("tp", "dp")),
                "hier": coll.hierarchical_allreduce(x, "tp", "dp"),
                "lowp": coll.allreduce_lowprec(x, ("tp", "dp")),
                "bcast": coll.broadcast(tp_idx, "tp", root=1),
                "gnorm": coll.global_norm({"g": x}, ("tp", "dp")),
                "tree": coll.tree_allreduce({"a": x, "b": [2 * x]}, "tp"),
                "tree_lowp": coll.tree_allreduce(
                    [x], ("tp", "dp"), "mean", wire_dtype=torch.bfloat16),
            }

    def group_api():
        mesh = make_mesh({"dp": 2, "tp": 2}, device="cpu")
        bad = _raises(lambda: coll.DeviceCollectiveGroup(mesh, ("nope",)),
                      ValueError)
        g2 = coll.DeviceCollectiveGroup(mesh, ("tp", "dp"))
        single = _raises(lambda: g2.allgather(torch.zeros(4)), ValueError)
        gtp = coll.DeviceCollectiveGroup(mesh, "tp")
        i = mesh.axis_index(("dp", "tp"))
        x = torch.arange(16.0)[4 * i:4 * (i + 1)]
        return {"bad": bad, "single": single, "size2": g2.size,
                "size_tp": gtp.size, "tp_sum": gtp.allreduce(x),
                "hier": g2.hierarchical_allreduce(x),
                "direct": coll.allreduce(x, ("tp", "dp"), mesh=mesh),
                "bcast": gtp.broadcast(x, root=1),
                "barrier": g2.barrier()}

    def gradients():
        """d(sum(w_r * op(x_r)) over ranks)/dx_r for each differentiable
        op, with this rank's weights ``w[r]``."""
        mesh = make_mesh({"dp": 4}, device="cpu")
        r = mesh.axis_index("dp")
        out = {}
        ops = {
            "allreduce": lambda x: coll.allreduce(x, "dp"),
            "mean": lambda x: coll.allreduce(x, "dp", "mean"),
            "allgather": lambda x: coll.allgather(x, "dp", tiled=True),
            "reducescatter": lambda x: coll.reducescatter(x, "dp"),
            "all_to_all": lambda x: coll.all_to_all(x, "dp"),
            "ring_shift": lambda x: coll.ring_shift(x, "dp", 1),
        }
        with mesh:
            for name, op in ops.items():
                x = torch.from_numpy(w["x"][r]).requires_grad_()
                y = op(x)
                wr = torch.from_numpy(w[name][r][:y.numel()]).view_as(y)
                (y * wr).sum().backward()
                out[name] = x.grad
        return out

    return _run({"wrappers": wrappers, "compositions": compositions,
                 "group_api": group_api, "gradients": gradients})


# ---------------------------------------------------------------------------
# tests/test_torch_ring_attention.py
# ---------------------------------------------------------------------------

def ring_cases(inputs: dict) -> dict:
    from ray_tpu_torch.ops.attention import make_sharded_causal_attention

    def attend(key, axes, impl):
        q, k, v = inputs[key]
        mesh = make_mesh(axes, device="cpu")
        dp, sp = mesh.shape["dp"], mesh.shape["sp"]
        bi, si = mesh.axis_index("dp"), mesh.axis_index("sp")
        loc = [_block(_block(x, 0, bi, dp).numpy(), 1, si, sp)
               .requires_grad_() for x in (q, k, v)]
        fn = make_sharded_causal_attention(mesh, impl=impl)
        out = fn(*loc)
        (out ** 2).sum().backward()
        return {"out": out, "dq": loc[0].grad, "dk": loc[1].grad,
                "dv": loc[2].grad, "dp": bi, "sp": si}

    def errors():
        sp_mesh = make_mesh({"sp": 4}, device="cpu")
        dp_mesh = make_mesh({"dp": 4}, device="cpu")
        tp_mesh = make_mesh({"sp": 2, "tp": 2}, device="cpu")
        q = torch.zeros(1, 4, 3, 8)             # 3 heads on this tp rank
        return {
            "dense_on_sp": _raises(lambda: make_sharded_causal_attention(
                sp_mesh, impl="dense"), ValueError),
            "ulysses_no_sp": _raises(lambda: make_sharded_causal_attention(
                dp_mesh, impl="ulysses"), ValueError),
            "ring_no_sp": _raises(lambda: make_sharded_causal_attention(
                dp_mesh, impl="ring"), ValueError),
            "unknown": _raises(lambda: make_sharded_causal_attention(
                dp_mesh, impl="flash"), ValueError),
            "ulysses_tp_heads": _raises(
                lambda: make_sharded_causal_attention(
                    tp_mesh, impl="ulysses")(q, q, q), ValueError),
        }

    return _run({
        "ring_sp4": lambda: attend("sp4", {"sp": 4}, "ring"),
        "ring_dp2_sp2": lambda: attend("dp2_sp2", {"dp": 2, "sp": 2},
                                       "auto"),
        "ulysses_sp4": lambda: attend("sp4_h8", {"sp": 4}, "ulysses"),
        "ulysses_dp2_sp2": lambda: attend("dp2_sp2", {"dp": 2, "sp": 2},
                                          "ulysses"),
        "errors": errors,
    })


# ---------------------------------------------------------------------------
# tests/test_torch_mesh_train.py
# ---------------------------------------------------------------------------

def train_cases(inputs: dict) -> dict:
    from ray_tpu_torch.models import (
        GPT2, GPT2Config, Llama, LlamaConfig, ResNet, ResNet50Config, ViT,
        ViTConfig, resnet_loss_fn, vit_loss_fn)
    from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
    from ray_tpu_torch.ops.moe import moe_ffn
    from ray_tpu_torch.train import (adamw, init_train_state,
                                     make_train_step, sgd, shard_batch)

    def logits(model_cls, config, params, key, axes):
        mesh = make_mesh(axes, device="cpu")
        model = model_cls(config, mesh=mesh, seed=0)
        model.load_jax_params(params)
        batch = shard_batch({"tokens": inputs[key]}, mesh, seq_sharded=True)
        with torch.no_grad():
            out = model(batch["tokens"])
        return {"logits": out, "dp": mesh.axis_index("dp"),
                "sp": mesh.axis_index("sp")}

    def gpt2_ring():
        return logits(GPT2, GPT2Config.tiny(attn_impl="ring"),
                      inputs["gpt2_params"], "gpt2_tokens",
                      {"dp": 2, "sp": 2})

    def llama(impl):
        return logits(Llama, LlamaConfig.tiny(attn_impl=impl,
                                              dtype=torch.float32),
                      inputs["llama_params"], "llama_tokens", {"sp": 4})

    def gpt2_ring_train():
        mesh = make_mesh({"dp": 2, "sp": 2}, device="cpu")
        model = GPT2(GPT2Config.tiny(dtype=torch.float32, attn_impl="ring"),
                     mesh=mesh)
        model.load_jax_params(inputs["gpt2_f32_params"])
        opt = adamw(1e-3, weight_decay=0.1, mu_dtype=torch.bfloat16)
        state = init_train_state(model, opt, mesh=mesh)
        step = make_train_step(gpt2_loss_fn(ce_chunk=64), opt)
        metrics = []
        for batch in inputs["gpt2_fsdp_batches"]:
            state, m = step(state, shard_batch(batch, mesh, seq_sharded=True))
            metrics.append({k: float(v) for k, v in m.items()})
        return {"metrics": metrics,
                "params": {n: p.detach() for n, p in
                           model.named_parameters()}}

    def gpt2_fsdp():
        from torch.distributed.tensor import DTensor
        mesh = make_mesh({"fsdp": 4}, device="cpu")
        model = GPT2(GPT2Config.tiny(dtype=torch.float32), mesh=mesh)
        model.load_jax_params(inputs["gpt2_f32_params"])
        opt = adamw(1e-3, weight_decay=0.1, mu_dtype=torch.bfloat16)
        state = init_train_state(model, opt, mesh=mesh)
        step = make_train_step(gpt2_loss_fn(ce_chunk=64), opt)
        metrics = []
        for batch in inputs["gpt2_fsdp_batches"]:
            state, m = step(state, shard_batch(batch, mesh))
            metrics.append({k: float(v) for k, v in m.items()})
        wte = model.wte.weight
        return {"metrics": metrics,
                "wte": [repr(p) for p in wte.placements],
                "params": {n: (p.full_tensor() if isinstance(p, DTensor)
                               else p).detach()
                           for n, p in model.named_parameters()}}

    def resnet(axes, stats_over_batch=True):
        mesh = make_mesh(axes, device="cpu")
        model = ResNet(ResNet50Config.tiny(dtype=torch.float32), mesh=mesh)
        if not stats_over_batch:                  # the local-statistics port
            model._bn_group = None
        model.load_jax_params(*inputs["resnet_variables"])
        opt = sgd(0.1, momentum=0.9, nesterov=True)
        state = init_train_state(model, opt, mesh=mesh,
                                 extra=model.batch_stats())
        step = make_train_step(resnet_loss_fn(), opt, has_extra=True)
        state, m = step(state, shard_batch(inputs["resnet_batch"], mesh))
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "stats": {k: v.clone() for k, v in state.extra.items()},
                "params": {n: p.detach() for n, p
                           in model.named_parameters()}}

    def vit():
        mesh = make_mesh({"dp": 4}, device="cpu")
        model = ViT(ViTConfig.tiny(dtype=torch.float32), mesh=mesh)
        model.load_jax_params(inputs["vit_params"])
        opt = sgd(0.1)
        state = init_train_state(model, opt, mesh=mesh)
        step = make_train_step(vit_loss_fn(), opt)
        state, m = step(state, shard_batch(inputs["vit_batch"], mesh))
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "params": {n: p.detach() for n, p
                           in model.named_parameters()}}

    def moe():
        mesh = make_mesh({"ep": 4}, device="cpu")
        r = mesh.axis_index("ep")
        x, router, w_up, w_down = (torch.from_numpy(a)
                                   for a in inputs["moe"])
        e_local = w_up.shape[0] // 4
        mine = slice(r * e_local, (r + 1) * e_local)
        xs = _block(x.numpy(), 0, r, 4)
        router = router.clone().requires_grad_()
        wu = w_up[mine].clone().requires_grad_()
        wd = w_down[mine].clone().requires_grad_()
        y, aux = moe_ffn(xs, router, wu, wd, group=mesh.group("ep"),
                         capacity_factor=2.0)
        ((y ** 2).sum() + 0.01 * aux).backward()
        return {"y": y, "aux": aux, "router": router.grad, "w_up": wu.grad,
                "w_down": wd.grad, "ep": r}

    def moe_model(axes, route_globally=True):
        """One SGD step of the MoE transformer tiny (float32, capacity
        factor 1) on ``axes``; ``route_globally=False`` hides the mesh from
        the switch FFNs, which then route each rank's tokens alone (the
        port before global routing)."""
        from ray_tpu_torch.models import MoEConfig, MoETransformer
        from ray_tpu_torch.models.moe import SwitchFFN, moe_loss_fn
        mesh = make_mesh(axes, device="cpu")
        model = MoETransformer(MoEConfig.tiny(dtype=torch.float32,
                                              capacity_factor=1.0),
                               mesh=mesh)
        model.load_jax_params(inputs["moe_params"])
        if not route_globally:
            for m in model.modules():
                if isinstance(m, SwitchFFN):
                    m.mesh = None
        opt = sgd(0.1)
        state = init_train_state(model, opt, mesh=mesh)
        step = make_train_step(moe_loss_fn(ce_chunk=64), opt)
        state, m = step(state, shard_batch(inputs["moe_batch"], mesh))
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "params": local_params(model)}

    return _run({
        "gpt2_ring": gpt2_ring,
        "llama_ring": lambda: llama("ring"),
        "llama_ulysses": lambda: llama("ulysses"),
        "gpt2_ring_train": gpt2_ring_train,
        "gpt2_fsdp": gpt2_fsdp,
        "resnet": lambda: resnet({"dp": 4}),
        "resnet_local_stats": lambda: resnet({"dp": 4}, False),
        "vit": vit,
        "moe": moe,
        "moe_dp2_ep2": lambda: moe_model({"dp": 2, "ep": 2}),
        "moe_dp4": lambda: moe_model({"dp": 4}),
        "moe_dp2_tp2": lambda: moe_model({"dp": 2, "tp": 2}),
        "moe_dp4_local": lambda: moe_model({"dp": 4}, False),
    })


def local_params(model) -> dict:
    """``{name: (this rank's block, its split)}`` of a placed model: the
    test process cuts the same block from the JAX weights."""
    from torch.distributed.tensor import DTensor
    placed = getattr(model, "placements", None) or {}
    return {n: ((p.full_tensor() if isinstance(p, DTensor) else p).detach(),
                placed[n].split if n in placed else ())
            for n, p in model.named_parameters()}


def _train(model, opt, loss_fn, mesh, batches, seq_sharded=False) -> dict:
    from ray_tpu_torch.train import (init_train_state, make_train_step,
                                     shard_batch)
    state = init_train_state(model, opt, mesh=mesh)
    step = make_train_step(loss_fn, opt)
    metrics = []
    for batch in batches:
        state, m = step(state, shard_batch(batch, mesh,
                                           seq_sharded=seq_sharded))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": local_params(model)}


# ---------------------------------------------------------------------------
# tests/test_torch_tensor_parallel.py
# ---------------------------------------------------------------------------

def tensor_parallel_cases(inputs: dict) -> dict:
    from ray_tpu_torch.models import GPT2, GPT2Config, Llama, LlamaConfig
    from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
    from ray_tpu_torch.models.llama import llama_loss_fn
    from ray_tpu_torch.parallel.sharding import place_params
    from ray_tpu_torch.train import adamw, shard_batch

    def logits(model_cls, config, params, key, axes):
        """Placed first, then loaded: ``load_jax_params`` cuts each
        rank's block."""
        mesh = make_mesh(axes, device="cpu")
        model = model_cls(config, mesh=mesh, seed=0)
        place_params(model, mesh)
        model.load_jax_params(params)
        batch = shard_batch({"tokens": inputs[key]}, mesh, seq_sharded=True)
        with torch.no_grad():
            out = model(batch["tokens"])
        return {"logits": out, "dp": mesh.axis_index("dp"),
                "sp": mesh.axis_index("sp"), "tp": mesh.axis_index("tp")}

    def gpt2_train(axes, impl="auto"):
        mesh = make_mesh(axes, device="cpu")
        model = GPT2(GPT2Config.tiny(dtype=torch.float32, attn_impl=impl),
                     mesh=mesh)
        model.load_jax_params(inputs["gpt2_f32_params"])
        opt = adamw(1e-3, weight_decay=0.1, mu_dtype=torch.bfloat16)
        return _train(model, opt, gpt2_loss_fn(ce_chunk=64), mesh,
                      inputs["gpt2_batches"], seq_sharded=True)

    def llama_train(axes):
        mesh = make_mesh(axes, device="cpu")
        model = Llama(LlamaConfig.tiny(dtype=torch.float32,
                                       tie_embeddings=False), mesh=mesh)
        model.load_jax_params(inputs["llama_untied_params"])
        opt = adamw(1e-3, weight_decay=0.1, mu_dtype=torch.bfloat16)
        return _train(model, opt, llama_loss_fn(ce_chunk=64), mesh,
                      inputs["gpt2_batches"][:1])

    llama_cfg = LlamaConfig.tiny(dtype=torch.float32)
    return _run({
        "gpt2_dp2_tp2": lambda: logits(GPT2, GPT2Config.tiny(),
                                       inputs["gpt2_params"], "gpt2_tokens",
                                       {"dp": 2, "tp": 2}),
        "gpt2_tp4": lambda: logits(GPT2, GPT2Config.tiny(),
                                   inputs["gpt2_params"], "gpt2_tokens",
                                   {"tp": 4}),
        "gpt2_sp2_tp2_ring": lambda: logits(
            GPT2, GPT2Config.tiny(attn_impl="ring"), inputs["gpt2_params"],
            "gpt2_tokens", {"sp": 2, "tp": 2}),
        "gpt2_sp2_tp2_ulysses": lambda: logits(
            GPT2, GPT2Config.tiny(attn_impl="ulysses"),
            inputs["gpt2_params"], "gpt2_tokens", {"sp": 2, "tp": 2}),
        "gpt2_dp2_tp2_train": lambda: gpt2_train({"dp": 2, "tp": 2}),
        "gpt2_tp4_train": lambda: gpt2_train({"tp": 4}),
        "gpt2_sp2_tp2_ring_train": lambda: gpt2_train({"sp": 2, "tp": 2},
                                                      "ring"),
        "gpt2_fsdp2_tp2_train": lambda: gpt2_train({"fsdp": 2, "tp": 2}),
        "llama_tp4": lambda: logits(Llama, llama_cfg, inputs["llama_params"],
                                    "llama_tokens", {"tp": 4}),
        "llama_dp2_tp2": lambda: logits(Llama, llama_cfg,
                                        inputs["llama_params"],
                                        "llama_tokens", {"dp": 2, "tp": 2}),
        "llama_tp4_train": lambda: llama_train({"tp": 4}),
        "llama_dp2_tp2_train": lambda: llama_train({"dp": 2, "tp": 2}),
    })


# ---------------------------------------------------------------------------
# tests/test_torch_pipeline.py
# ---------------------------------------------------------------------------

def pipeline_cases(inputs: dict) -> dict:
    from ray_tpu_torch.parallel.pipeline import shard_stages, spmd_pipeline

    def run(key, axes, microbatches):
        ws, x, w_out = inputs[key]
        mesh = make_mesh(axes, device="cpu")
        dp, di = mesh.shape["dp"], mesh.axis_index("dp")
        stages = shard_stages(torch.from_numpy(ws).requires_grad_(), mesh)
        xs = _block(x, 0, di, dp).requires_grad_()
        pipe = spmd_pipeline(lambda w, a: torch.tanh(a @ w), microbatches,
                             mesh=mesh)
        y = pipe(stages, xs)
        (y * _block(w_out, 0, di, dp)).sum().backward()
        return {"y": y, "dw": stages.grad[0], "dx": xs.grad, "dp": di,
                "pp": mesh.axis_index("pp")}

    def shapes_raise():
        mesh = make_mesh({"pp": 4}, device="cpu")
        return _raises(lambda: shard_stages({"w": torch.zeros(2, 3)}, mesh),
                       ValueError)

    return _run({
        "pp4": lambda: run("pp4", {"pp": 4}, 8),
        "dp2_pp2": lambda: run("dp2_pp2", {"dp": 2, "pp": 2}, 4),
        "shapes_raise": shapes_raise,
    })


# ---------------------------------------------------------------------------
# tests/test_torch_checkpoint.py
# ---------------------------------------------------------------------------

def checkpoint_cases(inputs: dict, directory: str) -> dict:
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
    from ray_tpu_torch.train import (adamw, init_train_state,
                                     make_train_step, shard_batch)
    from ray_tpu_torch.train.checkpoint import (restore_pytree,
                                                restore_train_state,
                                                save_train_state)

    batches = inputs["batches"]

    def train(axes, restore: bool):
        """Two AdamW steps on ``axes`` after the checkpoint (restored into
        a model of other weights), or the first step, the save, and the
        same two steps after it."""
        mesh = make_mesh(axes, device="cpu")
        model = GPT2(GPT2Config.tiny(dtype=torch.float32), mesh=mesh,
                     seed=1 if restore else 0)
        if not restore:
            model.load_jax_params(inputs["params"])
        opt = adamw(1e-3, weight_decay=0.1, mu_dtype=torch.bfloat16)
        state = init_train_state(model, opt, mesh=mesh)
        step = make_train_step(gpt2_loss_fn(ce_chunk=64), opt)
        if restore:
            restore_train_state(directory, state)
        else:
            step(state, shard_batch(batches[0], mesh))
            save_train_state(state, directory)
        at = state.step
        losses = [float(step(state, shard_batch(b, mesh))[1]["loss"])
                  for b in batches[1:]]
        return {"losses": losses, "step_at_restore": at}

    def whole():
        tree = restore_pytree(directory)
        return {k: tuple(v.shape) for k, v in tree["params"].items()}

    return _run({
        "saved_dp2_tp2": lambda: train({"dp": 2, "tp": 2}, False),
        "restored_dp4": lambda: train({"dp": 4}, True),
        "restored_fsdp4": lambda: train({"fsdp": 4}, True),
        "restored_tp4": lambda: train({"tp": 4}, True),
        "whole": whole,
    })


# ---------------------------------------------------------------------------
# tests/test_torch_vision_tp.py
# ---------------------------------------------------------------------------

# The planted faults of the vision tp routes, by name: each swaps one
# module-level helper of the model for a version without its tp sum.
def _no_channel_sum(x, tp):
    """ResNet's channel gather without the sum of the input gradient
    over tp: ``gather_from``, whose backward only narrows."""
    from ray_tpu_torch.collective import device as coll
    return x if tp is None else coll.gather_from(x, tp.group, 1)


def _no_norm_sum(p, tp, n):
    """BatchNorm's slice of its replicated scale and bias without
    ``copy_to``: their gradients are not summed over tp."""
    return p if tp is None else p.narrow(0, tp.index * n, n)


VISION_FAULTS = {
    "gather_from": ("ray_tpu_torch.models.resnet", "gather_channels",
                    _no_channel_sum),
    "norm_params": ("ray_tpu_torch.models.resnet", "replicated_block",
                    _no_norm_sum),
    "vit_fc": ("ray_tpu_torch.models.vit", "enter", lambda x, split: x),
}


def vision_tp_cases(inputs: dict) -> dict:
    import importlib

    from ray_tpu_torch.models import (ResNet, ResNet50Config, ViT,
                                      ViTConfig, resnet_loss_fn,
                                      vit_loss_fn)
    from ray_tpu_torch.parallel.sharding import place_params
    from ray_tpu_torch.train import (init_train_state, make_train_step,
                                     sgd, shard_batch)

    def build(kind, mesh):
        if kind == "vit":
            model = ViT(ViTConfig.tiny(dtype=torch.float32), mesh=mesh)
            model.load_jax_params(inputs["vit_params"])
        else:
            model = ResNet(ResNet50Config.tiny(dtype=torch.float32),
                           mesh=mesh)
            model.load_jax_params(*inputs["resnet_variables"])
        return model

    def logits(kind, axes):
        """The eval-mode logits of this rank's block of the batch."""
        mesh = make_mesh(axes, device="cpu")
        model = place_params(build(kind, mesh), mesh)
        key = "images" if kind == "vit" else "image"
        batch = shard_batch(inputs[f"{kind}_batches"][0], mesh)
        with torch.no_grad():
            out = model(batch[key])
        return {"logits": out, "dp": mesh.axis_index("dp")}

    def train(kind, axes, fault=None):
        """Two SGD steps (ViT: lr 0.1; ResNet: Nesterov, its BatchNorm
        statistics through the step) with ``fault`` planted."""
        patched = None
        if fault is not None:
            module, attr, fn = VISION_FAULTS[fault]
            module = importlib.import_module(module)
            patched = (module, attr, getattr(module, attr))
            setattr(module, attr, fn)
        try:
            mesh = make_mesh(axes, device="cpu")
            model = build(kind, mesh)
            if kind == "vit":
                opt = sgd(0.1)
                state = init_train_state(model, opt, mesh=mesh)
                step = make_train_step(vit_loss_fn(), opt)
            else:
                opt = sgd(0.1, momentum=0.9, nesterov=True)
                state = init_train_state(model, opt, mesh=mesh,
                                         extra=model.batch_stats())
                step = make_train_step(resnet_loss_fn(), opt,
                                       has_extra=True)
            metrics = []
            for batch in inputs[f"{kind}_batches"]:
                state, m = step(state, shard_batch(batch, mesh))
                metrics.append({k: float(v) for k, v in m.items()})
        finally:
            if patched is not None:
                setattr(*patched)
        return {"metrics": metrics, "params": local_params(model),
                "stats": {k: v.clone() for k, v in (state.extra or {})
                          .items()}}

    dp_tp = {"dp": 2, "tp": 2}
    return _run({
        "vit_logits": lambda: logits("vit", dp_tp),
        "resnet_logits": lambda: logits("resnet", dp_tp),
        "vit_train": lambda: train("vit", dp_tp),
        "resnet_train": lambda: train("resnet", dp_tp),
        "resnet_sp": lambda: train("resnet", {"dp": 2, "sp": 2}),
        "fault_gather_from": lambda: train("resnet", dp_tp, "gather_from"),
        "fault_norm_params": lambda: train("resnet", dp_tp, "norm_params"),
        "fault_vit_fc": lambda: train("vit", dp_tp, "vit_fc"),
    })


# ViT on sp (tests/test_torch_vit_sp.py): each planted fault is
# (module, attribute, replacement). The padded keys enter every softmax
# (every block taken as wholly valid); the step averages the gradients
# over dp and fsdp but not sp; every rank takes the head of its own first
# row as the CLS token's.
def _all_valid(t: int, n: int):
    block = -(-t // n)
    return block, (block,) * n


VIT_SP_FAULTS = {
    "padded_keys": ("ray_tpu_torch.models.vit", "seq_blocks", _all_valid),
    "no_sp_sum": ("ray_tpu_torch.train.step", "DATA_AXES", ("dp", "fsdp")),
    "cls_first_row": ("ray_tpu_torch.models.vit", "cls_logits",
                      lambda logits, mesh: logits),
}
VIT_SP_MESHES = {"dp2_sp4": {"dp": 2, "sp": 4}, "sp8": {"sp": 8}}


def vit_sp_cases(inputs: dict) -> dict:
    """The tiny ViT (float32) on each mesh of VIT_SP_MESHES: the eval
    logits of this rank's rows, then two SGD steps at lr 0.1, clean and
    with each planted fault of VIT_SP_FAULTS."""
    import importlib

    from ray_tpu_torch.models import ViT, ViTConfig, vit_loss_fn
    from ray_tpu_torch.train import (init_train_state, make_train_step,
                                     sgd, shard_batch)

    def build(mesh):
        model = ViT(ViTConfig.tiny(dtype=torch.float32), mesh=mesh)
        model.load_jax_params(inputs["vit_params"])
        return model

    def logits(axes):
        mesh = make_mesh(axes, device="cpu")
        batch = shard_batch(inputs["vit_batches"][0], mesh)
        with torch.no_grad():
            out = build(mesh)(batch["images"])
        return {"logits": out, "dp": mesh.axis_index("dp")}

    def train(axes, fault=None):
        patched = None
        if fault is not None:
            module, attr, value = VIT_SP_FAULTS[fault]
            module = importlib.import_module(module)
            patched = (module, attr, getattr(module, attr))
            setattr(module, attr, value)
        try:
            mesh = make_mesh(axes, device="cpu")
            model = build(mesh)
            opt = sgd(0.1)
            state = init_train_state(model, opt, mesh=mesh)
            step = make_train_step(vit_loss_fn(), opt)
            metrics = []
            for batch in inputs["vit_batches"]:
                state, m = step(state, shard_batch(batch, mesh))
                metrics.append({k: float(v) for k, v in m.items()})
        finally:
            if patched is not None:
                setattr(*patched)
        return {"metrics": metrics, "params": local_params(model)}

    cases = {}
    for name, axes in VIT_SP_MESHES.items():
        cases[f"logits_{name}"] = lambda axes=axes: logits(axes)
        cases[f"train_{name}"] = lambda axes=axes: train(axes)
        for fault in VIT_SP_FAULTS:
            cases[f"fault_{fault}_{name}"] = \
                lambda axes=axes, fault=fault: train(axes, fault)
    return _run(cases)
