"""What a step does, counted op by op: the port's counterpart of XLA's
``compiled.cost_analysis()`` and ``compiled.memory_analysis()``.

:func:`count` is a ``TorchDispatchMode`` context.  Every ATen op that runs
inside it (forward, autograd's backward and a checkpoint's recompute
alike) is recorded:

* **flops**, on XLA's ``HloCostAnalysis`` convention: the matmul family
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolution, SDPA) by
  ``torch.utils.flop_counter``'s registered formulas (2·M·N·K); 1 per
  output element of a pointwise op (``torch.Tag.pointwise``), but none for
  a copy (``clone``: XLA's ``copy`` is 0) or a cast (``_to_copy`` carries
  no pointwise tag; XLA's ``convert`` is 1 an element, and its CPU backend
  converts every bf16 weight to f32, which the card never does); 1 per
  input element of a reduction;
* **bytes accessed**: operand bytes + result bytes of each op; views and
  allocations (``empty``) count 0;
* **live bytes**: each storage an op creates adds its ``nbytes`` when it is
  made and subtracts them when it is freed (``weakref.finalize`` on the
  storage), so ``peak_bytes`` is the high-water mark of the run; the
  storages of ``args`` count from the start as ``argument_bytes``, and
  :meth:`Counter.returned` sets ``output_bytes`` from what the step returns;
* **an op log**: op name → [result bytes, calls], for
  :mod:`.hlo_histogram`; views and allocations are logged with their
  result bytes too, as XLA's HLO lists bitcasts and reshapes with theirs.

The dry-run counts on the ``meta`` device, where an op allocates nothing
and computes nothing: shapes and dtypes are all there is, and they are all
the counts need.

On a mesh (the dry-run's partitioned view) the step runs on DTensors
whose local shards are on ``meta``.  The counter steps aside for an op on
DTensors (its ``__torch_dispatch__`` returns ``NotImplemented``), so
DTensor's own dispatch runs it, and counts the local ops that dispatch
issues: the work of this rank (rank 0 of the world), per device, as XLA's
costs of the partitioned program are.  It counts nothing of DTensor's
sharding propagation, which runs ops on FakeTensors of the global
shapes.  The collectives a redistribution issues (``_c10d_functional``'s
``all_gather_into_tensor``, ``all_reduce``, ``reduce_scatter_tensor``,
``all_to_all_single`` and their ``c10d`` forms) add their result bytes to
:attr:`Counter.collective_bytes`, under the reference's five kinds, and one
to its ``count``, as the reference's ``collective_bytes`` reads the result
shapes of the compiled HLO's collectives; they add nothing to
``bytes_accessed`` or flops.  ``wait_tensor`` and ``_wrap_tensor_autograd``
count nothing.  The arguments' and outputs' bytes are their local shards'.

:func:`repro_torch.kernels.hook.kernel` is the hook of the port's CUDA
kernels (``kernels/ops.py``; :func:`count` puts its counter where the hook
finds it): inside it the counter adds the kernel's analytic flops and bytes once,
under the kernel's name, and counts none of the ATen ops that run inside
(the plain stand-in that computes the values off the card); the storage
of what the kernel returns counts as live.  So a count reads the work of
the route the card takes, as XLA's costs read the program it compiled.
"""
from __future__ import annotations

import contextlib
import sys
import weakref
from typing import Any, Callable, Dict, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..distributed.sharding import dtensor_type
from ..kernels import hook

__all__ = ["Counter", "count", "FLOP_KINDS", "NO_TRAFFIC", "COLLECTIVES"]

FLOP_KINDS = ("matmul", "pointwise", "reduction", "kernel")
# the reference's collective kinds (``repro/launch/dryrun.py``'s ``_COLLECTIVES``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# collective ops by (namespace, name) → kind; their result bytes are counted
_COLLECTIVE_OPS = {
    **{("_c10d_functional", n): k for n, k in (
        ("all_gather_into_tensor", "all-gather"), ("all_reduce", "all-reduce"),
        ("reduce_scatter_tensor", "reduce-scatter"), ("all_to_all_single", "all-to-all"))},
    **{("c10d", n): k for n, k in (
        ("allgather_", "all-gather"), ("_allgather_base_", "all-gather"),
        ("allreduce_", "all-reduce"),
        ("reduce_scatter_", "reduce-scatter"), ("_reduce_scatter_base_", "reduce-scatter"),
        ("alltoall_", "all-to-all"), ("alltoall_base_", "all-to-all"))},
}
# a functional collective's companions: no work, no bytes
_COLLECTIVE_NOOPS = {("_c10d_functional", "wait_tensor"),
                     ("_c10d_functional", "_wrap_tensor_autograd")}

_aten = torch.ops.aten
# ops that make a storage without touching its bytes
_NO_TRAFFIC = {_aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
               _aten.new_empty_strided, _aten._unsafe_view}
# their names, as the op log has them (:mod:`.hlo_histogram` treats them as fusible)
NO_TRAFFIC = frozenset(op.__name__ for op in _NO_TRAFFIC)
# reductions XLA sees as reduces, whatever their ATen tags
_REDUCTIONS = {_aten._softmax, _aten._log_softmax, _aten.sum, _aten.mean, _aten.amax,
               _aten.amin, _aten.logsumexp, _aten.prod, _aten.var_mean, _aten.aminmax,
               _aten.linalg_vector_norm, _aten.any, _aten.all, _aten.argmax, _aten.argmin}
_REDUCTION_TAG = getattr(torch.Tag, "reduction", None)
# tagged pointwise, but a copy: no flops, as XLA's copy
_COPIES = {_aten.clone}

def _tensors(tree) -> List[torch.Tensor]:
    """The tensors in ``tree``, a ``DTensor`` as its local shard."""
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = getattr(t, "_local_tensor", None)
            out.append(t if local is None else local)
    return out


def _fake_type():
    mod = sys.modules.get("torch._subclasses.fake_tensor")
    return None if mod is None else mod.FakeTensor


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def is_reduction(func) -> bool:
    return (func.overloadpacket in _REDUCTIONS
            or (_REDUCTION_TAG is not None and _REDUCTION_TAG in func.tags
                and torch.Tag.pointwise not in func.tags))


class Counter(TorchDispatchMode):
    """The counts of one :func:`count` block (see the module docstring)."""

    def __init__(self, args: Any = ()):
        super().__init__()
        self.flops_by_kind: Dict[str, int] = dict.fromkeys(FLOP_KINDS, 0)
        self.bytes_accessed = 0
        self.oplog: Dict[str, List[int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.output_bytes = 0
        self._live: Dict[int, Any] = {}       # storage key -> its finalizer
        self._paused = 0
        self.collective_bytes: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)
        self.collective_bytes["count"] = 0
        for t in _tensors(args):
            self._adopt(t)
        self.argument_bytes = self.live_bytes

    @property
    def flops(self) -> int:
        return sum(self.flops_by_kind.values())

    # -- live bytes --------------------------------------------------------

    def _freed(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _adopt(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live from now until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        nbytes = st.nbytes()
        self._live[key] = weakref.finalize(st, self._freed, key, nbytes)
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def returned(self, out: Any) -> Any:
        """Set ``output_bytes`` to the storage bytes of the tensors in
        ``out`` (each storage once, the arguments' too); returns ``out``."""
        seen = {}
        for t in _tensors(out):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
        self.output_bytes = sum(seen.values())
        return out

    def _close(self) -> None:
        for fin in self._live.values():
            fin.detach()
        self._live.clear()

    # -- the op log ---------------------------------------------------------

    def _log(self, name: str, result_bytes: int) -> None:
        entry = self.oplog.setdefault(name, [0, 0])
        entry[0] += result_bytes
        entry[1] += 1

    # -- dispatch -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dt = dtensor_type()
        if dt is not None and any(issubclass(t, dt) for t in types):
            return NotImplemented          # DTensor's dispatch issues the local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        fake = _fake_type()
        if fake is not None and any(isinstance(t, fake) for t in ins + outs):
            return out                     # DTensor's sharding propagation
        key = (func.namespace, func.overloadpacket.__name__)
        if key in _COLLECTIVE_NOOPS:
            return out
        if key in _COLLECTIVE_OPS:
            for t in outs:
                self._adopt(t)
            self.collective_bytes[_COLLECTIVE_OPS[key]] += sum(_nbytes(t) for t in outs)
            self.collective_bytes["count"] += 1
            return out
        in_storages = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.untyped_storage()._cdata not in in_storages:
                self._adopt(t)
        result_bytes = sum(_nbytes(t) for t in outs)
        pkt = func.overloadpacket
        self._log(pkt.__name__, result_bytes)
        if func.is_view or pkt in _NO_TRAFFIC:
            return out
        self.bytes_accessed += sum(_nbytes(t) for t in ins) + result_bytes
        if pkt in flop_registry:
            self.flops_by_kind["matmul"] += int(flop_registry[pkt](*args, **kwargs, out_val=out))
        elif is_reduction(func):
            self.flops_by_kind["reduction"] += ins[0].numel() if ins else 0
        elif torch.Tag.pointwise in func.tags and pkt not in _COPIES:
            self.flops_by_kind["pointwise"] += sum(t.numel() for t in outs)
        return out

    # -- the kernels' hook --------------------------------------------------

    @contextlib.contextmanager
    def _kernel(self, name: str, flops: int, nbytes: int, **_: Any) -> Iterator[Callable]:
        self.flops_by_kind["kernel"] += int(flops)
        self.bytes_accessed += int(nbytes)
        self._paused += 1

        def adopt(out):
            for t in _tensors(out):
                self._adopt(t)
            self._log(name, sum(_nbytes(t) for t in _tensors(out)))
            return out

        try:
            yield adopt
        finally:
            self._paused -= 1


@contextlib.contextmanager
def count(args: Any = ()) -> Iterator[Counter]:
    """Count every ATen op run inside the block (see the module
    docstring); the tensors in ``args`` are the step's arguments."""
    counter = Counter(args)
    hook._STACK.append(counter)
    try:
        with counter:
            yield counter
    finally:
        hook._STACK.pop()
        counter._close()
