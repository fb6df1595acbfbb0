"""Attention ops of the port.

Counterpart of ``ray_tpu/ops/attention.py``. ``causal_attention`` runs
the hand-written CUDA flash kernels for CUDA tensors
(``ops/cuda/flash_attention.py``) and their plain PyTorch versions for
CPU tensors. There is no library fallback: a CUDA input the kernels do
not take raises. Shapes follow the JAX package: ``[batch, seq, heads,
head_dim]``. ``resolved_flash_config`` says which route (unsplit or
the causal split's bands) a sequence length takes, for benchmarks to
record.

Sequence parallelism, on activations whose sequence is split over the
``sp`` ranks of a mesh (rank r holds rows ``[r*t, (r+1)*t)``):

- ``ring_attention``: the key/value blocks rotate around the ranks, one
  hop each, and each rank attends its queries to every block at or
  before its own. It is one autograd function on the flash kernels. A
  hop (:func:`ring_hop_forward`) runs the causal square route on the
  rank's own block, the ``causal=False`` route on an earlier block, and
  nothing on a later one. The hops' outputs merge in float32 by their
  log-sum-exp (:func:`ring_merge`, :func:`ring_finish`). The backward
  (:func:`ring_hop_backward`) runs both backward kernels on each hop
  with the merged lse and ``delta = rowsum(o·do)``; the dk and dv
  accumulators travel with their block and are home after the last
  rotation. Each hop's k, v rotation is posted before its kernels, in
  the forward and the backward; only the dk, dv rotation waits for them. The JAX ring computes the same function in float32 einsums.
- ``_bidir_ring_attention`` (private: the JAX package has no such entry
  point; it is ViT's attention on an ``sp`` mesh, ``models/vit.py``): the
  same ``RingAttentionFn`` without a causal mask, over blocks padded to
  one length at their end, each block with its own number of valid rows. Every hop
  runs the non-causal rectangle (``flash_fwd_nc_rect``) on the rank's
  whole padded query block against the source block's valid rows only,
  so padded keys never enter a softmax; a source block without a valid
  row launches nothing. The backward pads each hop's dk, dv to the block
  length and rotates them home as the causal ring does.
- ``ulysses_attention``: an all_to_all trades the sequence split for a
  head split, ``causal_attention`` runs on the whole sequence, and a
  second all_to_all trades back.
- ``make_sharded_causal_attention`` picks between them for a mesh.

Heads split over ``tp`` need nothing of attention: a tensor-parallel
model's q, k and v already hold this rank's heads (``models/gpt2.py``),
so a rank attends over its own H/tp heads through the kernels, or
through ring or Ulysses over ``sp`` on those heads.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ray_tpu_torch.collective.device import all_to_all
from ray_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    flash_attention_available,
    flash_attention_shapes_ok,
    flash_bwd_dkv,
    flash_bwd_dkv_nc_rect,
    flash_bwd_dq,
    flash_bwd_dq_nc_rect,
    flash_fwd,
    flash_fwd_nc_rect,
    resolved_flash_config,
)

__all__ = ["causal_attention", "flash_eligible", "resolved_flash_config",
           "ring_attention", "ulysses_attention",
           "make_sharded_causal_attention", "ring_hop_forward",
           "ring_merge", "ring_finish", "ring_hop_backward"]


def flash_eligible(t: int, d: int) -> bool:
    """Would ``causal_attention`` run [*, t, *, d] self-attention on the
    CUDA kernels here? Benchmarks use this to refuse measuring anything
    else."""
    return flash_attention_available() and flash_attention_shapes_ok(t, d)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float | None = None) -> torch.Tensor:
    """Causal attention [B, T, H, D] -> [B, T, H, D]."""
    return flash_attention(q, k, v, causal=True, scale=scale)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

def ring_hop_forward(q, k, v, src: int, me: int, scale: float):
    """One hop of the ring forward on folded ``[BH, t, D]`` blocks: rank
    ``me``'s queries against the key/value block of rank ``src``.
    ``(o, lse)`` from the flash forward kernel, causal on the rank's own
    block and ``causal=False`` on an earlier one; None for a later block,
    which the causal mask hides whole (no launch)."""
    if src > me:
        return None
    return flash_fwd(q, k, v, scale, causal=src == me)


def ring_merge(state, part):
    """Fold one hop's ``(o, lse)`` into the running ``state`` (None at
    first): ``(m, num, den)``, the running maximum of the lse, and the
    float32 numerator and denominator of the softmax over the blocks so
    far, each hop weighted by ``exp(lse - m)``."""
    o, lse = part
    if state is None:
        return lse, o.float(), torch.ones_like(lse)
    m, num, den = state
    m_new = torch.maximum(m, lse)
    keep = torch.exp(m - m_new)
    w = torch.exp(lse - m_new)
    return (m_new, num * keep[..., None] + o.float() * w[..., None],
            den * keep + w)


def ring_finish(state, dtype: torch.dtype):
    """``(o, lse)`` of the merged hops: o in ``dtype``, lse float32; the
    denominator guarded at 1e-30 as the JAX ring guards its row sum."""
    m, num, den = state
    den = den.clamp_min(1e-30)
    return (num / den[..., None]).to(dtype), m + torch.log(den)


def ring_hop_backward(q, k, v, do, lse, delta, src: int, me: int,
                      scale: float):
    """One hop of the ring backward: ``(dq, dk, dv)`` of rank ``me``'s
    queries against ``src``'s block, from the flash backward kernels fed
    the MERGED ``lse`` and ``delta = rowsum(o·do)`` of the whole row, so
    that each block's probabilities are its share of the full softmax;
    None for a later block."""
    if src > me:
        return None
    causal = src == me
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


class _Rotation:
    """Tensors sent one rank up the ring (rank i to i + 1) while the
    caller computes; :meth:`wait` returns what arrived from rank i - 1.
    Rotations in flight together carry different ``tag``s."""

    def __init__(self, tensors, group, tag: int = 0):
        n = dist.get_world_size(group)
        me = dist.get_rank(group)
        up = dist.get_global_rank(group, (me + 1) % n)
        down = dist.get_global_rank(group, (me - 1) % n)
        self.out = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t.contiguous(), up, group, tag)
               for t in tensors]
        ops += [dist.P2POp(dist.irecv, o, down, group, tag)
                for o in self.out]
        self.works = dist.batch_isend_irecv(ops)

    def wait(self):
        for w in self.works:
            w.wait()
        return self.out


class GroupRing:
    """The ranks of a process group as the ring :class:`RingAttentionFn`
    runs on: ``n`` ranks, this one ``me``; :meth:`rotate` posts a
    :class:`_Rotation`. Any object with these three members will do (a
    harness may run every rank of a ring in one process)."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.me = dist.get_rank(group)

    def rotate(self, tensors, tag: int = 0) -> _Rotation:
        return _Rotation(tensors, self.group, tag)


def _fold(x):
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def _unfold(x, b, h):
    bh, t, d = x.shape
    return x.view(b, h, t, d).transpose(1, 2)


def bidir_hop_forward(q, k, v, tk: int, scale: float):
    """One hop of the bidirectional ring on folded blocks: the padded
    ``[BH, t, D]`` queries of this rank against the first ``tk`` rows (the
    valid ones) of a source block's k, v, read in place. ``(o, lse)`` from
    the non-causal rectangle; None when the block holds no valid row (no
    launch)."""
    if tk == 0:
        return None
    return flash_fwd_nc_rect(q, k[:, :tk], v[:, :tk], scale)


def bidir_hop_backward(q, k, v, do, lse, delta, tk: int, scale: float):
    """One hop of the bidirectional ring backward, with the merged ``lse``
    and ``delta`` of the whole row: ``(dq, dk, dv)``, dk and dv ``[BH,
    tk, D]`` for the source block's valid rows; None when it has none."""
    if tk == 0:
        return None
    k, v = k[:, :tk], v[:, :tk]
    dq = flash_bwd_dq_nc_rect(q, k, v, do, lse, delta, scale)
    dk, dv = flash_bwd_dkv_nc_rect(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


class RingAttentionFn(torch.autograd.Function):
    """Ring attention over the ranks of ``ring`` (a :class:`GroupRing`) on
    ``[B, t, H, D]`` local blocks, on the flash kernels; see the module
    docstring. ``lengths`` None: causal, the hops of
    :func:`ring_hop_forward` and :func:`ring_hop_backward`. Else
    bidirectional over blocks padded to one length ``t``, ``lengths[r]``
    the valid rows of ring rank r's block: the hops of
    :func:`bidir_hop_forward` and :func:`bidir_hop_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, ring, scale, lengths):
        b, _, h, _ = q.shape
        n, me = ring.n, ring.me
        qf, kf, vf = _fold(q), _fold(k), _fold(v)
        kb, vb = kf, vf
        state = None
        for i in range(n):
            rot = ring.rotate((kb, vb)) if i < n - 1 else None
            src = (me - i) % n
            part = (ring_hop_forward(qf, kb, vb, src, me, scale)
                    if lengths is None else
                    bidir_hop_forward(qf, kb, vb, lengths[src], scale))
            if part is not None:
                state = ring_merge(state, part)
            if rot is not None:
                kb, vb = rot.wait()
        o, lse = ring_finish(state, q.dtype)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.ring, ctx.scale, ctx.bh, ctx.lengths = ring, scale, (b, h), lengths
        return _unfold(o, b, h)

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, o, lse = ctx.saved_tensors
        ring, scale, lengths = ctx.ring, ctx.scale, ctx.lengths
        n, me = ring.n, ring.me
        dof = _fold(do.to(qf.dtype))
        delta = (o.float() * dof.float()).sum(-1)
        dq = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
        kb, vb = kf, vf
        dkb = torch.zeros(kf.shape, dtype=torch.float32, device=kf.device)
        dvb = torch.zeros_like(dkb)
        for i in range(n):
            # k, v leave for the next hop before this hop's kernels run,
            # as in the forward; dk, dv leave when the kernels have added
            # to them, and their last rotation brings them home.
            kv = ring.rotate((kb, vb)) if i < n - 1 else None
            src = (me - i) % n
            part = (ring_hop_backward(qf, kb, vb, dof, lse, delta, src, me,
                                      scale)
                    if lengths is None else
                    bidir_hop_backward(qf, kb, vb, dof, lse, delta,
                                       lengths[src], scale))
            if part is not None:
                # The source block's valid rows (all of a causal block).
                tk = part[1].shape[1]
                dq += part[0].float()
                dkb[:, :tk] += part[1].float()
                dvb[:, :tk] += part[2].float()
            if n > 1:
                dkb, dvb = ring.rotate((dkb, dvb), tag=1).wait()
            if kv is not None:
                kb, vb = kv.wait()
        b, h = ctx.bh
        return (_unfold(dq.to(qf.dtype), b, h),
                _unfold(dkb.to(kf.dtype), b, h),
                _unfold(dvb.to(vf.dtype), b, h), None, None, None)


def _bidir_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: tuple[int, ...], axis_name: str = "sp",
                          scale: float | None = None,
                          mesh=None) -> torch.Tensor:
    """Bidirectional attention over a sequence split into the padded
    ``[B, t, H, D]`` blocks of the ``axis_name`` ranks of ``mesh``, block r
    holding ``lengths[r]`` valid rows at its start; differentiable. The
    padded rows' outputs are computed (against the valid keys) and are the
    caller's to ignore."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return RingAttentionFn.apply(
        q, k, v, GroupRing(_resolve_mesh(mesh).group(axis_name)),
        float(scale), tuple(lengths))


def _resolve_mesh(mesh):
    from ray_tpu_torch.parallel.mesh import current_mesh
    return mesh if mesh is not None else current_mesh()


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "sp", scale: float | None = None,
                   mesh=None) -> torch.Tensor:
    """Causal ring attention over the ``axis_name`` ranks of ``mesh`` (the
    active mesh by default) on this rank's ``[B, t, H, D]`` sequence
    block; differentiable."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return RingAttentionFn.apply(
        q, k, v, GroupRing(_resolve_mesh(mesh).group(axis_name)),
        float(scale), None)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = "sp", scale: float | None = None,
                      mesh=None) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism: an all_to_all trades the
    sequence split for a head split ([B, t, H, D] -> [B, t·sp, H/sp, D]),
    each rank runs ``causal_attention`` over the whole sequence on its
    heads, and the inverse all_to_all trades back. Needs
    ``heads % sp == 0`` (the heads this rank holds: H/tp under tensor
    parallelism), else ValueError; differentiable."""
    mesh = _resolve_mesh(mesh)
    sp = mesh.axis_size(axis_name)
    if q.shape[2] % sp:
        raise ValueError(
            f"ulysses_attention: the {q.shape[2]} heads of this rank do "
            f"not split over {axis_name}={sp}")
    qh, kh, vh = (all_to_all(x, axis_name, 2, 1, mesh) for x in (q, k, v))
    out = causal_attention(qh, kh, vh, scale=scale)
    return all_to_all(out, axis_name, 1, 2, mesh)


def make_sharded_causal_attention(mesh, batch_axes=("dp", "fsdp"),
                                  seq_axis="sp", head_axis="tp",
                                  impl="auto"):
    """An attention function for activations split ``[batch -> dp/fsdp,
    seq -> sp, heads -> tp]`` on ``mesh``: ring attention (``"auto"`` or
    ``"ring"``) or Ulysses when the mesh has a real sp axis, local
    ``causal_attention`` otherwise (a rank's batch block and its heads need
    nothing from the others). ``"dense"`` on a real sp axis, and
    ``"ring"``/``"ulysses"`` without one, raise ValueError as in the JAX
    package. ``head_axis`` names the axis the caller's heads are split
    over; the function sees this rank's heads only."""
    if impl not in ("auto", "dense", "ring", "ulysses"):
        raise ValueError(f"unknown attn impl {impl!r}; "
                         "expected 'auto', 'dense', 'ring' or "
                         "'ulysses'")
    sp = mesh.shape.get(seq_axis, 1)
    if impl == "dense" and sp > 1:
        raise ValueError(
            f"attn_impl='dense' cannot run on a mesh with "
            f"{seq_axis}={sp}: activations are sequence-sharded, so "
            f"attention must be 'ring' (or 'auto') — or build the "
            f"mesh without a {seq_axis} axis")
    if impl in ("ring", "ulysses") and sp <= 1:
        raise ValueError(
            f"attn_impl={impl!r} requires a real {seq_axis} mesh axis "
            f"(got {seq_axis}={sp}); the O(seq/sp) per-device K/V "
            f"memory you asked for does not exist on this mesh — use "
            f"'auto' or add a {seq_axis} axis")
    if sp <= 1:
        return causal_attention
    local_impl = ulysses_attention if impl == "ulysses" else ring_attention
    return functools.partial(local_impl, axis_name=seq_axis, mesh=mesh)
