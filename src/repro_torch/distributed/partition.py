"""Ops of the partitioned view that DTensor's sharding rules cannot place:
they run on each rank's local shards, with explicit collectives, and hand
back DTensors.  Every partitioning decision of the view is here: the
model's modules only test for a DTensor and call these (a projection,
attention and its softmax combine, the vocab-split lookup and loss, the
cache write, the global norm, and the reference's shard_map paths: the
expert-parallel MoE block and its ``--no-ep`` global dispatch, the
Mamba-2 mixer, the sequence-parallel window attention, each running the
layers' own local math on this rank's shards).

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
step's collectives are the same under every version of DTensor.  The
shard_map paths enter by rows (:func:`rows`), take their weights whole
or by their own shard (:func:`whole`), exchange and gather with the
functional collectives (``all_to_all_single_autograd``,
:func:`gather_local`, whose transpose is a reduce-scatter) and hand a
result every model rank computed alike back as shares of its grad
(:func:`as_shares`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["AttentionShards", "attention_shards", "matmul", "mergeable", "gather",
           "reduce_grad", "combine_stats", "embed", "vocab_split_nll", "write_cache",
           "sum_over_shards", "offset", "from_local", "all_reduce", "local", "gather_local",
           "as_shares", "mesh_dims", "rows", "whole", "chunk", "moe_ep", "moe_global",
           "swa_seqpar", "ssm_block"]


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
    """``table[tokens]`` for a DTensor table, read as XLA partitions the
    reference's ``take``.  Split by vocab (dim 0): each rank looks up the
    tokens it holds rows for (zero elsewhere), and the rows are a partial
    sum over the split, reduced by the caller's layout constraint
    (DTensor's own ``index`` would gather the table whole).  Split by width
    (dim 1) over a mesh dim that does not split the tokens (a vocab that
    does not divide "model"): each rank looks up its columns, the rows
    come back split by width there.  A width split over a mesh dim that
    splits the tokens (FSDP) is gathered first (:func:`gather`)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    tp = tokens.placements
    want = tuple(p if p.is_shard(0) or (p.is_shard(1) and not tp[i].is_shard()) else Replicate()
                 for i, p in enumerate(table.placements))
    if tuple(table.placements) != want:
        table = gather(table, want)
    # the table's grad: its own rows or columns where split, a partial sum
    # where the tokens are split and it is not
    grad = tuple(a if a.is_shard() else (Partial() if b.is_shard() else a)
                 for a, b in zip(want, tp))
    tl = table.to_local(grad_placements=grad)
    idx = tokens.to_local().long() - offset(table)[0]
    held = (idx >= 0) & (idx < tl.shape[0])
    x = F.embedding(idx.clamp(0, tl.shape[0] - 1), tl) * held[..., None].to(tl.dtype)
    out = tuple(Partial() if a.is_shard(0) else (Shard(tokens.dim()) if a.is_shard(1) else b)
                for a, b in zip(want, tp))
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


def _all_gather(t: torch.Tensor, mesh, i: int, dim: int) -> torch.Tensor:
    """``t`` gathered over mesh dim ``i`` and joined along ``dim`` in
    coordinate order (``jax.lax.all_gather(..., tiled=True)``).  Forward
    only."""
    n = mesh.size(i)
    t = t.movedim(dim, 0).contiguous()
    g = torch.ops._c10d_functional.all_gather_into_tensor(t, n, mesh.get_group(i).group_name)
    return torch.ops._c10d_functional.wait_tensor(g).movedim(0, dim)


def _reduce_scatter(t: torch.Tensor, mesh, i: int, dim: int) -> torch.Tensor:
    """``t`` summed over mesh dim ``i``, each rank keeping its part along
    ``dim`` (``jax.lax.psum_scatter(..., tiled=True)``).  Forward only."""
    n = mesh.size(i)
    t = t.movedim(dim, 0).contiguous()
    r = torch.ops._c10d_functional.reduce_scatter_tensor(t, "sum", n,
                                                         mesh.get_group(i).group_name)
    return torch.ops._c10d_functional.wait_tensor(r).movedim(0, dim)


class _GatherLocal(torch.autograd.Function):
    """A local tensor all-gathered over mesh dims (innermost first, so the
    result is in row-major coordinate order); its backward reduce-scatters
    the grad, each rank's grad being its share of the whole's."""

    @staticmethod
    def forward(ctx, t, mesh, dims, dim):
        ctx.mesh, ctx.dims, ctx.dim = mesh, dims, dim
        for i in reversed(dims):
            t = _all_gather(t, mesh, i, dim)
        return t

    @staticmethod
    def backward(ctx, g):
        for i in ctx.dims:
            g = _reduce_scatter(g, ctx.mesh, i, ctx.dim)
        return g, None, None, None


def gather_local(t: torch.Tensor, mesh, dims: Sequence[int], dim: int) -> torch.Tensor:
    """This rank's local ``t`` all-gathered along ``dim`` over the mesh dims
    ``dims`` (the first outermost), as a shard_map body's ``all_gather``;
    in the backward the grad is reduce-scattered back, its transpose: each
    rank's grad of the whole is its share, and the shares sum to the grad."""
    dims = tuple(i for i in dims if mesh.size(i) > 1)
    return _GatherLocal.apply(t, mesh, dims, dim) if dims else t


class _Shares(torch.autograd.Function):
    """A local tensor as the DTensor whose shard it is; in the backward the
    grad's local shard comes back as this rank's share over ``dims``: a
    grad replicated over such a mesh dim is M equal shares (divided by
    M), a partial one is a share already.  (``DTensor.from_local`` would
    hand back the replicated grad whole, and a reduce-scatter of M whole
    copies is M times the grad.)"""

    @staticmethod
    def forward(ctx, t, mesh, placements, shape, dims):
        ctx.mesh, ctx.placements, ctx.dims = mesh, placements, dims
        return from_local(t, mesh, placements, shape)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial

        want = tuple(Partial() if i in ctx.dims and g.placements[i].is_partial() else p
                     for i, p in enumerate(ctx.placements))
        if tuple(g.placements) != want:
            g = g.redistribute(g.device_mesh, want)
        gl = g.to_local()
        n = math.prod(ctx.mesh.size(i) for i in ctx.dims if want[i].is_replicate())
        return (gl / n if n > 1 else gl), None, None, None, None


def as_shares(t: torch.Tensor, mesh, placements, shape, dims: Sequence[int]):
    """``from_local(t, ...)`` whose grad comes back as this rank's share over
    the mesh dims ``dims`` (see :class:`_Shares`): for a result that every
    rank along them computed alike from pieces it gathered, whose
    collective's transpose sums the shares (:func:`gather_local`)."""
    return _Shares.apply(t, mesh, tuple(placements), tuple(shape), tuple(dims))


def mesh_dims(mesh) -> Tuple[int, Tuple[int, ...]]:
    """(the "model" mesh dim, the batch mesh dims ("pod", "data")) of ``mesh``."""
    names = tuple(mesh.mesh_dim_names)
    return names.index("model"), tuple(i for i, n in enumerate(names) if n in ("pod", "data"))


def rows(x):
    """The DTensor ``x`` with its rows (dim 0) split over the batch mesh dims
    as they are, and whole over every other mesh dim: the layout a mesh
    path's shard_map enters with (``P(batch axes)``).  A partial sum is
    reduced; a split of another dim gathered."""
    from torch.distributed.tensor import Replicate

    _, bdims = mesh_dims(x.device_mesh)
    want = tuple(p if (i in bdims and p.is_shard(0)) else Replicate()
                 for i, p in enumerate(x.placements))
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def whole(w, *, keep: Sequence[int] = (), shared: Sequence[int] = ()) -> torch.Tensor:
    """This rank's local tensor of the DTensor weight ``w``, made whole over
    every mesh dim but those in ``keep`` (:func:`gather`), for code on
    local tensors that reads it on this rank's share of the work.  Its
    grad: this rank's own shard on ``keep``; summed at once over the mesh
    dims of ``shared`` (the ranks that split the work there: a weight
    split there reduce-scattered by :func:`gather`'s backward, a whole one
    all-reduced, :func:`reduce_grad`); a partial sum over the rest (the
    batch axes, which AdamW reduces)."""
    from torch.distributed.tensor import Partial, Replicate

    wp = tuple(w.placements)
    want = tuple(p if i in keep else Replicate() for i, p in enumerate(wp))
    if want != wp:
        w = gather(w, want)
    mesh = w.device_mesh
    summed = tuple(i for i in shared if i not in keep and wp[i].is_replicate()
                   and mesh.size(i) > 1)
    grad = tuple(wp[i] if i in keep else
                 (Replicate() if i in summed or mesh.size(i) == 1 else Partial())
                 for i in range(len(wp)))
    return reduce_grad(w.to_local(grad_placements=grad), mesh, summed)


def chunk(t, dim: int) -> Tuple[int, int]:
    """(offset, size) along ``dim`` of this rank's shard of the DTensor
    ``t`` over the "model" mesh dim (the whole dim where it is not split
    there)."""
    md, _ = mesh_dims(t.device_mesh)
    if not t.placements[md].is_shard(dim):
        return 0, t.shape[dim]
    return offset(t)[dim], t.to_local().shape[dim]


# ---------------------------------------------------------------------------
# The reference's shard_map paths, on local shards
# ---------------------------------------------------------------------------

def moe_ep(x, p, body: Callable):
    """The expert-parallel MoE block on DTensors: the reference's
    ``ep_body`` (``repro/models/layers.py:590-631``) on this rank's shards.
    x (B, S, D) enters by rows over the batch axes, whole over "model";
    the router is made whole (the reference's ``in_specs`` P(None, None):
    an E-split router is all-gathered); the expert leaves are this rank's
    E/M experts, all-gathered over "data" where FSDP splits them.  This
    rank routes its Ts = ceil(T_loc / M) slice of its T_loc tokens
    (zero-padded), ``body(xs, w_router, experts, exchange)`` runs the
    layers' dispatch, the two exchanges (``exchange``: an all-to-all over
    "model" whose transpose is the same exchange) and the combine, and the
    rank's rows are all-gathered over "model" only, to T_loc, and handed
    back placed P(batch axes, None, None).

    In the backward: the exit gather's transpose is a reduce-scatter over
    "model" of the ranks' shares; the input's grad (each model rank routed
    a slice of x) is all-reduced over "model"; the router's grad summed
    over "model" (a reduce-scatter where it is split by experts); the
    experts' grads reduce-scattered over "data" under FSDP, else left
    partial over the batch axes."""
    from torch.distributed import _functional_collectives as fc

    x = rows(x)
    mesh = x.device_mesh
    md, _ = mesh_dims(mesh)
    M = mesh.size(md)
    B, S, D = x.shape
    xl = reduce_grad(x.to_local(), mesh, (md,) if M > 1 else ())
    wr = whole(p["w_router"], shared=(md,))
    experts = {k: whole(p[k], keep=(md,), shared=(md,)) for k in ("w_gate", "w_up", "w_down")
               if k in p}
    B_loc = xl.shape[0]
    T_loc = B_loc * S
    xt = xl.reshape(T_loc, D)
    Ts = -(-T_loc // M)
    if Ts * M > T_loc:
        xt = torch.cat([xt, xt.new_zeros((Ts * M - T_loc, D))])
    mi = mesh.get_coordinate()[md]
    group = mesh.get_group(md)

    def exchange(t):
        return fc.all_to_all_single_autograd(t.contiguous(), None, None, group)

    ys = body(xt[mi * Ts:(mi + 1) * Ts], wr, experts, exchange)
    y = gather_local(ys, mesh, (md,), 0)[:T_loc].reshape(B_loc, S, D)
    return as_shares(y, mesh, x.placements, x.shape, (md,))


def moe_global(x, p, cfg, dispatch: Callable, ffn: Callable, combine: Callable):
    """The global-dispatch MoE block on DTensors (``--no-ep``): the
    reference's ``_moe_block_global`` as XLA partitions it.  The tokens are
    all-gathered over the batch axes, and every rank routes all B·S of
    them (the dispatch is replicated: its argsort and scatter need a
    global token order); the capacity slabs are split over "model"
    (``maybe_shard(eb, P("model"))``), each rank running its E/M experts
    over theirs, and put back together (an all-gather over "model") for
    the combine; the rank keeps its rows.  Per device the experts run
    data× the expert-parallel path's rows.

    In the backward every rank's grad of what it computed alike is its
    share (:func:`as_shares`): the slabs' gather is reduce-scattered over
    "model", the tokens' over the batch axes, and the input's grad then
    all-reduced over "model"."""
    x = rows(x)
    mesh = x.device_mesh
    md, bdims = mesh_dims(mesh)
    M = mesh.size(md)
    B, S, D = x.shape
    E = cfg.n_experts
    xl = reduce_grad(x.to_local(), mesh, (md,) if M > 1 else ())
    xw = gather_local(xl, mesh, bdims, 0)
    if xw.shape[0] != B:
        raise ValueError(f"moe_global: {xw.shape[0]} rows gathered of {B} (the batch does not "
                         "split evenly over the batch axes)")
    wr = whole(p["w_router"], shared=(md,))
    experts = {k: whole(p[k], keep=(md,), shared=(md,)) for k in ("w_gate", "w_up", "w_down")
               if k in p}
    E_loc = experts["w_up"].shape[0]
    T = B * S
    eb, top_p, keep, dest, tok_idx, C = dispatch(xw.reshape(T, D), wr, E, cfg.top_k,
                                                 cfg.capacity_factor, x.dtype)
    m0 = offset(p["w_up"])[0]
    eo = ffn(eb[m0:m0 + E_loc], experts, cfg, x.dtype)
    eo = gather_local(eo, mesh, (md,) if E_loc < E else (), 0)
    y = combine(eo, top_p, keep, dest, tok_idx, T, D, x.dtype).reshape(B, S, D)
    r0, B_loc = offset(x)[0], xl.shape[0]
    return as_shares(y[r0:r0 + B_loc], mesh, x.placements, x.shape, (md, *bdims))


def swa_seqpar(x, p, block: Callable):
    """The sequence-parallel window attention on DTensors: the reference's
    ``_swa_seqpar_attention`` (``repro/models/layers.py:297-375``) on this
    rank's shards.  x (B, S, D) enters by rows over the batch axes, whole
    over "model"; the weights are made whole (the reference's ``in_specs``
    are all ``P(None, None, None)``: a head-dim split is all-gathered);
    ``block(x_loc, wq, wk, wv, wo, start)`` runs the layers' body on this
    rank's block (RoPE at plain positions, the flash op or
    ``chunked_attention`` over ``[max(0, start - W), start + S/M)``) and
    returns this rank's y, k and v rows.  y is all-gathered over "model"
    only and handed back placed P(batch axes, None, None).  The k/v that
    feed the prefill cache are all-gathered too, as the reference's; under
    autograd (a train step) they are not, as XLA drops those gathers as
    dead code (the cache is unused), and come back split by sequence over
    "model", as each rank holds them.

    In the backward: y's gather is reduce-scattered over "model" (each
    rank's shares), the input's grad and the weights' (each model rank
    read them for its block) are summed over "model"."""
    from torch.distributed.tensor import Shard

    x = rows(x)
    mesh = x.device_mesh
    md, _ = mesh_dims(mesh)
    M = mesh.size(md)
    B, S, D = x.shape
    xl = reduce_grad(x.to_local(), mesh, (md,) if M > 1 else ())
    ws = [whole(p[k], shared=(md,)) for k in ("wq", "wk", "wv", "wo")]
    start = mesh.get_coordinate()[md] * (S // M)
    y, k, v = block(xl, *ws, start)
    out = as_shares(gather_local(y, mesh, (md,), 1), mesh, x.placements, x.shape, (md,))
    kv_pl = tuple(x.placements)
    kv_shape = (B, S, *k.shape[2:])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (k, v)):
        kv_pl = tuple(Shard(1) if i == md and M > 1 else pl for i, pl in enumerate(kv_pl))
        return out, from_local(k, mesh, kv_pl, kv_shape), from_local(v, mesh, kv_pl, kv_shape)
    return (out, from_local(gather_local(k, mesh, (md,), 1), mesh, kv_pl, kv_shape),
            from_local(gather_local(v, mesh, (md,), 1), mesh, kv_pl, kv_shape))


def ssm_block(x, p, cfg, *, state, conv_state, local, impl: str = "auto"):
    """The Mamba-2 mixer on DTensors, laid out as the specs place its
    weights and cache and as XLA partitions the reference's mixer: ``w_in``
    whole (its width does not divide "model"), ``conv_w`` and ``w_out``
    split by channels (din) over "model", the decode state split by its
    state dim N over "model" where the batch fills the data axis.
    ``local`` holds the layers' local math (``conv``, ``scan``, ``step``,
    ``project``).

    Prefill / forward: each rank takes its din channels (``conv_w``'s
    shard) and the heads they touch, h0..h1: XLA splits the SSM heads over
    "model" and pads a count that does not divide it, ceil(H / M) heads a
    rank, and so does this (the channels of a touched head this rank does
    not hold are zero).  It projects x by the columns of ``w_in`` it needs
    (its z and x channels, B and C whole, its heads' dt), runs the causal
    conv on its channels and the chunked SSD over its heads, gates its
    channels and multiplies them by its rows of ``w_out``: a row-parallel
    product, all-reduced at once.  No collective before it: the sequence
    is whole on every rank, so the conv's history needs no neighbour.  The
    final state comes back split by heads where the channels cut at head
    boundaries into even chunks, else as a partial sum over "model" (each
    rank's state holds its channels, zero elsewhere); the conv state split
    by channels as ``conv_w``.

    Decode (one token over ``state`` (B, H, Pd, N) and ``conv_state`` (B,
    3, din), laid out by ``cache_specs``): the token's rows as the cache's
    batch; the conv on the rank's channels of the conv state, its output
    all-gathered over "model" where the conv state is split; the state
    update on the rank's N slice (its B and C columns), so ``y = C·h`` is a
    partial sum over "model", all-reduced; the gate and ``w_out`` on the
    rank's channels, all-reduced.  A cache whole over "model" (long_500k)
    is updated whole on every rank.  y comes back in the cache's rows
    (whole over a batch axis where the cache is: the layout the attention
    branch of a hybrid layer has there too), the new state and conv state
    laid out as the cache, which the caller writes in place.  Returns (y,
    state, conv state)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    x = rows(x) if state is None else x
    mesh = x.device_mesh
    md, bdims = mesh_dims(mesh)
    M = mesh.size(md)
    dtype = x.dtype
    B, S, D = x.shape
    din, N, H = cfg.ssm_inner(D), cfg.ssm_state, cfg.ssm_heads
    Pd = din // H
    decode = state is not None and S == 1
    if decode:
        # the token's rows as the cache's batch, whole over "model"
        want = tuple(Shard(0) if i in bdims and state.placements[i].is_shard(0) else Replicate()
                     for i in range(mesh.ndim))
        if tuple(x.placements) != want:
            x = x.redistribute(mesh, want)
    xl = reduce_grad(x.to_local(), mesh, (md,) if M > 1 else ())
    B_loc = xl.shape[0]
    w_in = whole(p["w_in"], shared=(md,))
    dt_bias, A_log, D_skip = (whole(p[k], shared=(md,)) for k in ("dt_bias", "A_log", "D_skip"))
    o0, on = chunk(p["w_out"], 0)                       # the rank's rows of w_out
    k0, kn = chunk(p["conv_w"], 1)
    if (k0, kn) != (o0, on):
        raise ValueError(f"ssm_block: conv_w's channels {k0}+{kn} differ from w_out's {o0}+{on}")
    zero = torch.zeros((), device=xl.device)

    def columns(ranges):
        return torch.cat([w_in[:, a:a + n] for a, n in ranges], dim=1)

    def out_rows(y):
        """The rank's gated channels (B_loc, S, on) times its rows of w_out."""
        pl = tuple(Shard(2) if i == md and on < din else pl for i, pl in enumerate(x.placements))
        yd = from_local(y.to(dtype), mesh, pl, (B, S, din))
        return local.project(yd, p["w_out"], impl).to(dtype)

    if not decode:
        h0, h1 = o0 // Pd, -(-(o0 + on) // Pd)
        hn = h1 - h0
        lead, tail = o0 - h0 * Pd, h1 * Pd - o0 - on
        proj = xl.reshape(-1, D) @ columns([(o0, on), (din + o0, on), (2 * din, 2 * N),
                                            (2 * din + 2 * N + h0, hn)])
        z, xs, Bm, Cm, dt_raw = torch.split(proj.reshape(B_loc, S, -1).to(dtype),
                                            [on, on, N, N, hn], dim=-1)
        dt = torch.logaddexp(dt_raw.float() + dt_bias[h0:h1], zero)
        A = -torch.exp(A_log[h0:h1].float())
        kern = whole(p["conv_w"], keep=(md,), shared=(md,))
        xc, new_conv = local.conv(xs, kern, None)
        xc = F.silu(xc.float()).to(dtype)
        xh = F.pad(xc, (lead, tail)).reshape(B_loc, S, hn, Pd)
        y, hT = local.scan(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
        y = y + xh * D_skip[h0:h1][None, None, :, None]
        y = y.reshape(B_loc, S, hn * Pd)[..., lead:lead + on] * F.silu(z.float()).to(dtype)
        out = out_rows(y)
        cpl = tuple(Shard(2) if i == md and on < din else pl for i, pl in enumerate(x.placements))
        conv_out = from_local(new_conv, mesh, cpl, (B, 3, din))
        if on == din:
            spl = x.placements
        elif lead == tail == 0 and H % M == 0:
            spl = tuple(Shard(1) if i == md else pl for i, pl in enumerate(x.placements))
        else:
            hT = F.pad(hT, (0, 0, 0, 0, h0, H - h1))
            spl = tuple(Partial() if i == md else pl for i, pl in enumerate(x.placements))
        return out, from_local(hT, mesh, spl, (B, H, Pd, N)), conv_out

    c0, cn = chunk(conv_state, 2)
    n0, nn = chunk(state, 3)
    if cn < din and (c0, cn) != (k0, kn):
        raise ValueError(f"ssm_block: the conv cache's channels {c0}+{cn} differ from "
                         f"conv_w's {k0}+{kn}")
    proj = xl.reshape(-1, D) @ columns([(o0, on), (din + c0, cn), (2 * din + n0, nn),
                                        (2 * din + N + n0, nn), (2 * din + 2 * N, H)])
    z, xs, Bm, Cm, dt_raw = torch.split(proj.reshape(B_loc, S, -1).to(dtype),
                                        [on, cn, nn, nn, H], dim=-1)
    dt = torch.logaddexp(dt_raw.float() + dt_bias, zero)
    A = -torch.exp(A_log.float())
    kern = whole(p["conv_w"], keep=(md,) if cn < din else (), shared=(md,))
    xc, new_conv = local.conv(xs, kern, conv_state.to_local())
    xc = F.silu(xc.float()).to(dtype)
    if cn < din:
        xc = _all_gather(xc, mesh, md, 2)
    xh = xc.reshape(B_loc, S, H, Pd)
    y, hT = local.step(state.to_local(), xh, dt, A, Bm, Cm)
    if nn < N:
        y = all_reduce(y, "sum", mesh, (md,))
    y = y + xh * D_skip[None, None, :, None]
    y = y.reshape(B_loc, S, din)[..., o0:o0 + on] * F.silu(z.float()).to(dtype)
    return (out_rows(y), from_local(hT, mesh, state.placements, state.shape),
            from_local(new_conv, mesh, conv_state.placements, conv_state.shape))


def local(t):
    """``t``'s local shard where it is a DTensor, else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t
