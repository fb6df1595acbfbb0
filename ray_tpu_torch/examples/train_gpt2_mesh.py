"""A GPT-2 train step on a device mesh: ``dp`` over the ranks that a
launcher started (torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``), or
one rank without one. Each rank holds one card.

    python -m ray_tpu_torch.examples.train_gpt2_mesh
    torchrun --nproc-per-node 4 -m ray_tpu_torch.examples.train_gpt2_mesh
    python -m ray_tpu_torch.examples.train_gpt2_mesh --device cpu

It runs on the card by default (one captured CUDA graph a step, attention
on the hand-written flash kernels) and on the CPU only with ``--device
cpu`` (a gloo group, the kernels' plain versions). The model is the JAX
example's ``GPT2Config.tiny(seq_len=128, vocab_size=512)`` but for its
width: ``n_embd=256, n_head=4``, a head_dim of 64. The tiny config's
head_dim is 16, and the flash kernels take a head_dim of 64 or 128 only.
"""

import argparse
import math

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu for a CPU run (default: the card)")
    args = ap.parse_args(argv)

    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
    from ray_tpu_torch.parallel import make_mesh
    from ray_tpu_torch.train import (
        adamw, init_train_state, make_train_step, shard_batch,
    )

    mesh = make_mesh({"dp": -1}, device=args.device)   # add tp/fsdp/sp
    n_dev = mesh.shape["dp"]
    cfg = GPT2Config.tiny(seq_len=128, vocab_size=512, n_embd=256,
                          n_head=4)
    model = GPT2(cfg, mesh=mesh, seed=0)
    opt = adamw(3e-4)
    state = init_train_state(model, opt, mesh=mesh)
    step = make_train_step(gpt2_loss_fn(), opt)

    rng = np.random.default_rng(0)
    losses = []
    for i in range(5):
        toks = rng.integers(0, cfg.vocab_size,
                            (4 * n_dev, cfg.seq_len)).astype(np.int64)
        batch = shard_batch({"tokens": toks,
                             "targets": np.roll(toks, -1, 1)}, mesh)
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        print(f"step {i}: loss={losses[-1]:.4f} "
              f"grad_norm={float(metrics['grad_norm']):.3f}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"a loss is not finite: {losses}")


if __name__ == "__main__":
    main()
