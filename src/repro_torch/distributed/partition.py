"""Ops of the partitioned view that DTensor's sharding rules cannot place:
they run on each rank's local shards, with explicit collectives, and hand
back DTensors.  Every partitioning decision of the view is here: the
model's modules only test for a DTensor and call these (a projection,
attention and its softmax combine, the vocab-split lookup and loss, the
cache write, the global norm).

In the partitioned view (the dry-run on a mesh) the params, inputs and
cache are DTensors placed by the reference's specs
(:func:`~repro_torch.distributed.sharding.distribute`), and DTensor
partitions most ops by its own rules.  Attention is not one of them: a
GQA reshape of head-sharded queries into (kv heads, group) does not split
evenly over the "model" axis, so DTensor would gather the queries whole;
the flash kernel has no sharding rule at all; and decode reads a cache
whose sequence is split over "model".  XLA partitions each of these by
heads, batch or sequence, and so does :func:`attention_shards` here:

* batch (dim 0) and heads (dim 2) split alike over a mesh dim: each rank
  attends its own rows and heads;
* queries split by heads over a mesh dim on which k/v are replicated
  (their head count does not divide it): each rank takes the kv heads of
  its query heads' groups (the grads of k/v are summed over that dim);
* k/v split by sequence (dim 1) over a mesh dim: the queries are gathered
  over it, each rank attends its keys from their global offset, and the
  online-softmax statistics are combined with all-reduces (max, then the
  rescaled sums) — the flash-decoding split;
* q or k/v split by head dim (dim 3, the legacy fallback) or partial:
  gathered first.

Any other layout raises, naming the op.

Every sum over ranks that a step needs is issued here, at the point the
reference's partition reduces it, and none is left to DTensor as a
``Partial`` that its planner would reduce where its version chooses: a
row-parallel product is all-reduced at once; in the backward, the input
grad of a column-parallel product (:func:`matmul`) and the grad of k/v
that ranks read a slice of (:func:`attention_shards`) are all-reduced at
once (:func:`reduce_grad`), and a gathered weight hands back the grad of
its own shard (:func:`gather`).  What stays partial is a weight's grad
over the batch axes, which AdamW reduces into the weight's layout.  So a
step's collectives are the same under every version of DTensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["AttentionShards", "attention_shards", "matmul", "mergeable", "gather",
           "reduce_grad", "combine_stats", "embed", "vocab_split_nll", "write_cache",
           "sum_over_shards", "offset", "from_local", "all_reduce", "local"]


@dataclasses.dataclass
class AttentionShards:
    """Local q/k/v of one rank, with what is needed to put the result back:
    ``k_start`` is the global position of ``k``'s first key, ``seq`` the
    mesh dims that split the keys (their statistics need combining), and
    ``placements`` / ``shape`` those of the output (the queries')."""

    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    k_start: int
    seq: Tuple[int, ...]
    mesh: Any
    placements: Tuple[Any, ...]
    shape: Tuple[int, ...]


def offset(t, placements=None) -> Tuple[int, ...]:
    """The global index of the first element of this rank's shard of the
    DTensor ``t`` (laid out as ``placements``, by default its own)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return tuple(compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements if placements is None else placements)[1])


def attention_shards(q, k, v, *, op: str, allow_seq: bool = True) -> AttentionShards:
    """This rank's shards of q (B, Sq, Hq, hd) and k/v (B, Skv, Hkv, hd),
    DTensors on one mesh, laid out so that local attention over them is
    this rank's part of the global attention (see the module docstring).
    ``allow_seq`` False (a kernel's caller) raises on sequence-split k/v."""
    from torch.distributed.tensor import Replicate

    mesh = q.device_mesh
    qp, kp = list(q.placements), list(k.placements)
    seq = []
    for i in range(mesh.ndim):
        if qp[i].is_partial() or qp[i].is_shard(3):
            qp[i] = Replicate()
        if kp[i].is_partial() or kp[i].is_shard(3):
            kp[i] = Replicate()
        if qp[i].is_shard(1):
            raise ValueError(f"{op}: queries split by sequence over mesh dim {i}: only "
                             "batch or heads may be split")
        if kp[i].is_shard(1):
            if not allow_seq:
                raise ValueError(f"{op}: keys split by sequence over mesh dim {i}: only batch "
                                 "or heads may be split")
            qp[i] = Replicate()
            seq.append(i)
        elif kp[i].is_shard(0) or kp[i].is_shard(2):
            qp[i] = kp[i]
    # where each rank reads a slice of replicated k/v, their grad is summed over
    # the ranks at once
    summed = tuple(i for i, (a, b) in enumerate(zip(qp, kp))
                   if b.is_replicate() and not a.is_replicate())
    qp, kp = tuple(qp), tuple(kp)
    if tuple(q.placements) != qp:
        q = q.redistribute(mesh, qp)
    if tuple(k.placements) != kp:
        k = k.redistribute(mesh, kp)
    if tuple(v.placements) != kp:
        v = v.redistribute(mesh, kp)
    qo, ko = offset(q), offset(k)
    ql = q.to_local()
    kl, vl = (reduce_grad(t.to_local(), mesh, summed) for t in (k, v))
    if kl.shape[0] != ql.shape[0]:
        kl, vl = (t.narrow(0, qo[0] - ko[0], ql.shape[0]) for t in (kl, vl))
    G = q.shape[2] // k.shape[2]
    lo, hi = qo[2] // G, (qo[2] + ql.shape[2] - 1) // G + 1
    if hi - lo != kl.shape[2]:
        kl, vl = (t.narrow(2, lo - ko[2], hi - lo) for t in (kl, vl))
    if ql.shape[2] % kl.shape[2]:
        raise ValueError(f"{op}: {ql.shape[2]} local query heads do not group over "
                         f"{kl.shape[2]} kv heads")
    return AttentionShards(ql, kl, vl, ko[1], tuple(seq), mesh, qp, tuple(q.shape))


def combine_stats(m, l, acc, sh: AttentionShards):
    """An online softmax's running max ``m``, sum ``l`` and accumulator
    ``acc`` over this rank's keys (``sh``'s), combined over the mesh dims
    that split the keys by sequence: the max all-reduced, each rank's sum
    and accumulator rescaled to it and summed (the flash-decoding split);
    as they are where the keys are not split."""
    if not sh.seq:
        return m, l, acc
    m_all = all_reduce(m, "max", sh.mesh, sh.seq)
    m_safe = torch.where(torch.isinf(m_all), torch.zeros_like(m_all), m_all)
    corr = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp(m - m_safe))
    return (m_all, all_reduce(l * corr, "sum", sh.mesh, sh.seq),
            all_reduce(acc * corr[..., None], "sum", sh.mesh, sh.seq))


def matmul(x, w, dtype=None):
    """``x @ w`` for DTensors x (T, K) and w (K, N), each rank multiplying
    its shards (both cast to ``dtype`` when given, after any gather), laid
    out as XLA partitions a projection: per mesh dim,

    * w split by columns (N): x whole there, the product split by columns,
      x's grad all-reduced at once in the backward;
    * w split by rows (K): x split by K alike, the product a partial sum,
      all-reduced at once (as XLA reduces a row-parallel projection before
      the residual add);
    * w whole: the product split as x's rows (w's grad a partial sum
      where x's rows are split).

    A weight split where x's rows are split (FSDP) is gathered there
    first (:func:`gather`); x split by K against a whole w is gathered.
    DTensor's own rules for ``mm`` are left out: in a backward they may
    gather activations whole across "model"."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    xp, wp = list(x.placements), list(w.placements)
    out, wg, summed = [], [], []
    for i in range(mesh.ndim):
        a, b = xp[i], wp[i]
        if a.is_partial():
            a = Replicate()
        if b.is_partial() or (b.is_shard() and a.is_shard(0)):
            b = Replicate()
        if b.is_shard(1):
            a, o, gb = Replicate(), Shard(1), b
            summed.append(i)
        elif b.is_shard(0):
            a, o, gb = Shard(1), Partial(), b
        elif a.is_shard(0):
            o, gb = a, Partial()
        else:
            a, o, gb = Replicate(), Replicate(), Replicate()
        xp[i], wp[i] = a, b
        out.append(o), wg.append(gb)
    if tuple(x.placements) != tuple(xp):
        x = x.redistribute(mesh, xp)
    if tuple(w.placements) != tuple(wp):
        w = gather(w, wp)
    xl = reduce_grad(x.to_local(), mesh, summed)
    wl = w.to_local(grad_placements=wg)
    if dtype is not None:
        xl, wl = xl.to(dtype), wl.to(dtype)
    y = from_local(xl @ wl, mesh, out, (x.shape[0], w.shape[1]))
    if any(p.is_partial() for p in out):
        y = y.redistribute(mesh, [Replicate() if p.is_partial() else p for p in out])
    return y


class _ReduceGrad(torch.autograd.Function):
    """The identity; its backward all-reduces the grad over mesh dims."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.mesh, ctx.dims), None, None


def reduce_grad(t: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    """``t`` (a local shard that ranks along the mesh dims ``dims`` read
    alike), whose grad is summed over those ranks at once in the backward;
    ``t`` itself where ``dims`` is empty."""
    return _ReduceGrad.apply(t, mesh, tuple(dims)) if dims else t


class _Gather(torch.autograd.Function):
    """A DTensor redistributed to ``placements`` that only gather (a shard
    made whole); its backward lays the grad out as the DTensor was on
    those dims and leaves the others as they are."""

    @staticmethod
    def forward(ctx, w, placements):
        ctx.placements = tuple(w.placements)
        return w.redistribute(w.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        own = tuple(p if p.is_shard() else q for p, q in zip(ctx.placements, g.placements))
        if own != tuple(g.placements):
            g = g.redistribute(g.device_mesh, own)
        return g, None


def gather(w, placements):
    """The DTensor ``w`` made whole on the mesh dims where ``placements`` is
    ``Replicate()`` and ``w`` is split (any other dim as it is).  Its grad
    comes back split as ``w`` on those dims, one transform per dim: a
    reduce-scatter where the grad is a partial sum there (FSDP), else the
    rank's own slice (the legacy head-dim split), so that a sum over the
    batch axes left to the grad's owner reads the slice, not the whole."""
    return _Gather.apply(w, tuple(placements))


def mergeable(w, n_in: int):
    """The weight ``w`` (a DTensor) whole over each mesh dim that splits one
    of its dims inside a group ``w.reshape(K, N)`` merges (its first
    ``n_in`` dims into K, the rest into N), other than the group's first:
    the legacy fallback's split of wq/wk/wv/wo by head dim.  (Merged, such
    a split is strided, which DTensor refuses or gathers per use.)"""
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if p.is_shard() and p.dim not in (0, n_in) else p
                 for p in w.placements)
    return w if want == tuple(w.placements) else gather(w, want)


def embed(table, tokens):
    """``table[tokens]`` for a DTensor table split by vocab (dim 0), read as
    XLA partitions the reference's ``take``: each rank looks up the tokens
    it holds rows for (zero elsewhere), and the rows are a partial sum over
    the split, reduced by the caller's layout constraint (DTensor's own
    ``index`` would gather the table whole).  An FSDP split of its width
    is gathered first (:func:`gather`)."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = table.device_mesh
    want = tuple(p if p.is_shard(0) else Replicate() for p in table.placements)
    if tuple(table.placements) != want:
        table = gather(table, want)
    tp = tokens.placements
    # the table's grad: its own rows where split by vocab, a partial sum
    # where the tokens are split and it is not
    grad = tuple(a if a.is_shard() else (Partial() if b.is_shard() else a)
                 for a, b in zip(want, tp))
    tl = table.to_local(grad_placements=grad)
    idx = tokens.to_local().long() - offset(table)[0]
    held = (idx >= 0) & (idx < tl.shape[0])
    x = F.embedding(idx.clamp(0, tl.shape[0] - 1), tl) * held[..., None].to(tl.dtype)
    out = tuple(Partial() if a.is_shard() else b for a, b in zip(want, tp))
    return from_local(x, mesh, out, (*tokens.shape, table.shape[1]))


def vocab_split_nll(logits, labels):
    """``logsumexp - gold`` of DTensor logits split by vocab (their last
    dim), each rank over its columns, as XLA partitions the reference's:
    the max and the sum of exponentials reduced over the split, and the
    gold logit read where the rank holds it (0 elsewhere) and summed over
    the split.  (DTensor's own ``gather`` and ``logsumexp`` would gather
    the logits whole.)"""
    from torch.distributed.tensor import Partial, Replicate

    def whole(placements, dims):
        return tuple(Replicate() if i in dims else p for i, p in enumerate(placements))

    mesh = logits.device_mesh
    vdim = logits.dim() - 1
    split = [i for i, p in enumerate(logits.placements) if p.is_shard(vdim)]
    rows = whole(logits.placements, split)               # (B, S) as the logits' rows
    partial = tuple(Partial() if i in split else p for i, p in enumerate(logits.placements))
    m = logits.detach().amax(dim=-1, keepdim=True)       # a shift: constant to the grad
    m = m.redistribute(mesh, whole(m.placements, split))
    z = (logits - m).exp().sum(dim=-1)
    logz = m[..., 0] + torch.log(z.redistribute(mesh, whole(z.placements, split)))
    if hasattr(labels, "placements") and tuple(labels.placements) != rows:
        labels = labels.redistribute(mesh, rows)
    ll = logits.to_local()
    lab = local(labels).long() - offset(logits)[vdim]
    held = (lab >= 0) & (lab < ll.shape[-1])
    gold = torch.gather(ll, -1, lab.clamp(0, ll.shape[-1] - 1)[..., None])[..., 0]
    gold = from_local(gold * held, mesh, partial, logits.shape[:-1])
    return logz - gold.redistribute(mesh, rows)


def write_cache(buf, new, pos, write: Callable) -> None:
    """The cache write ``write(buf, new, pos)`` into a DTensor cache: ``new``
    is laid out as ``buf`` on batch and heads, and each rank writes its
    shard.  Where the sequence is not split that is ``write`` on the local
    shards; where it is (one token at a scalar ``pos``), a rank writes the
    token only where it holds ``pos`` and its slot back elsewhere, as XLA
    partitions the reference's ``dynamic_update_slice``."""
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if p.is_shard(1) else p for p in buf.placements)
    if tuple(new.placements) != want:
        new = new.redistribute(buf.device_mesh, want)
    bl, nl, pl = buf.to_local(), new.to_local(), local(pos)
    if want == tuple(buf.placements):
        write(bl, nl, pl)
        return
    if nl.shape[1] != 1 or pl.dim() != 0:
        raise ValueError("write_cache into a sequence-split cache takes one token at a "
                         "scalar position")
    start = pl.long().clamp(0, buf.shape[1] - 1) - offset(buf)[1]
    held = (start >= 0) & (start < bl.shape[1])
    slot = start.clamp(0, bl.shape[1] - 1)[None]
    bl.index_copy_(1, slot, torch.where(held, nl, bl.index_select(1, slot)))


def sum_over_shards(values: Sequence[torch.Tensor], like: Sequence[Any]) -> torch.Tensor:
    """The sum of ``values``, each a plain scalar summed over this rank's
    shard of the matching tensor of ``like`` (DTensors, none partial),
    over every rank: the values grouped by the mesh dims that split their
    tensor, and each group's sum all-reduced over those dims.  Where
    ``like`` holds no DTensor, ``sum(values)``."""
    groups: dict = {}
    mesh = None
    for v, t in zip(values, like):
        key = ()
        if hasattr(t, "placements"):
            mesh = t.device_mesh
            key = tuple(i for i, p in enumerate(t.placements) if p.is_shard())
        groups.setdefault(key, []).append(v)
    totals = [all_reduce(sum(vs), "sum", mesh, key) if key else sum(vs)
              for key, vs in groups.items()]
    return totals[0] if len(totals) == 1 else sum(totals)


def from_local(t: torch.Tensor, mesh, placements: Sequence[Any], shape) -> torch.Tensor:
    """The DTensor of global ``shape`` whose local shard is ``t``; its
    global strides follow ``t``'s layout.  A dim split unevenly (a batch
    of 1 over the batch axes, which XLA pads) keeps ``shape``: this rank
    holds what its offset leaves it."""
    from torch.distributed.tensor import DTensor

    out = DTensor.from_local(t, mesh, tuple(placements), run_check=False)
    if tuple(out.shape) == tuple(shape):
        return out
    order = sorted(range(t.dim()), key=lambda d: -t.stride(d))     # outermost first
    stride, acc = [0] * t.dim(), 1
    for d in reversed(order):
        stride[d], acc = acc, acc * shape[d]
    return DTensor.from_local(t, mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def all_reduce(t: torch.Tensor, op: str, mesh, dims: Sequence[int]) -> torch.Tensor:
    """``t`` all-reduced (``"sum"`` or ``"max"``) over each mesh dim of
    ``dims`` in turn, through the functional collectives (which a count
    sees).  Forward only: no autograd."""
    for i in dims:
        name = mesh.get_group(i).group_name
        t = torch.ops._c10d_functional.all_reduce(t, op, name)
        t = torch.ops._c10d_functional.wait_tensor(t)
    return t


def local(t):
    """``t``'s local shard where it is a DTensor, else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t
