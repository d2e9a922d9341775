"""Workload description interface (paper §IV-C, Fig. 5(a)).

Copy of ``repro.core.workload``: the port never imports the JAX package.

A sparse DNN workload is a DAG whose nodes are operations and whose edges
carry producer→consumer relationships.  MVM-backed ops (conv / fc /
matmul) carry a reshaped-matrix view (K contraction rows × N output
columns × V input vectors) that the mapper tiles onto CIM arrays; other
ops (pool / act / add / norm) are routed to the post-processing unit.

Builders are provided for the paper's evaluation models (VGG16,
ResNet18/50, MobileNetV2 at CIFAR or ImageNet resolutions) and for
lowering the repo's LM architecture configs into MVM DAGs
(:func:`lm_workload`).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

from .flexblock import FlexBlockSpec, dense_spec

__all__ = ["OpNode", "Workload", "WorkloadIssue", "vgg16", "resnet18",
           "resnet50", "mobilenet_v2", "lm_workload", "MODEL_BUILDERS",
           "MVM_KINDS", "OTHER_KINDS", "warn_unknown_kind"]

MVM_KINDS = ("conv", "fc", "matmul")

# Non-MVM kinds the cost model prices on the post-processing unit.  The
# hand builders emit the first five; traced graphs (repro.trace) also
# surface the rest.  Kinds outside this vocabulary are priced as plain
# elementwise work after a one-time warning (see warn_unknown_kind) —
# an explicit fallback instead of mispricing or crashing.
OTHER_KINDS = frozenset({
    "pool", "act", "add", "norm", "embed",
    "softmax", "reduce", "sort", "gather", "scatter", "elementwise",
})

_warned_kinds: set = set()


def warn_unknown_kind(kind: str) -> bool:
    """True (with a once-per-kind RuntimeWarning) for op kinds outside
    the priced vocabulary; callers fall back to elementwise pricing."""
    import warnings

    if kind in MVM_KINDS or kind == "dwconv" or kind in OTHER_KINDS:
        return False
    if kind not in _warned_kinds:
        _warned_kinds.add(kind)
        warnings.warn(
            f"unknown op kind {kind!r}: pricing as elementwise on the "
            "post-processing unit", RuntimeWarning, stacklevel=3)
    return True


@dataclasses.dataclass
class OpNode:
    """One operation node.

    For MVM kinds, the reshaped two-dimensional weight matrix view is
    ``K × N`` with ``V`` input vectors pushed through it (im2col for
    convs: K = Cin·Kh·Kw, N = Cout, V = Hout·Wout·batch).
    ``c_in`` is retained so channel-wise FlexBlock patterns can bind.
    """

    name: str
    kind: str                        # conv|dwconv|fc|matmul|pool|act|add|norm|embed
    inputs: Tuple[str, ...] = ()
    K: int = 0
    N: int = 0
    V: int = 0
    c_in: int = 0
    kernel: Tuple[int, int] = (1, 1)
    elements: int = 0                # for non-MVM ops: elements processed
    sparsity: FlexBlockSpec = dataclasses.field(default_factory=dense_spec)
    weight_count: Optional[int] = None
    prunable: bool = True            # e.g. depthwise convs may be excluded

    @property
    def is_mvm(self) -> bool:
        return self.kind in MVM_KINDS

    @property
    def macs(self) -> int:
        if self.is_mvm:
            return self.K * self.N * self.V
        return 0

    @property
    def weights(self) -> int:
        if self.weight_count is not None:
            return self.weight_count
        return self.K * self.N if self.is_mvm else 0


class WorkloadIssue(NamedTuple):
    """One structural problem found by :meth:`Workload.validate`.

    ``kind`` is one of ``dangling-edge`` / ``name-mismatch`` / ``cycle``
    / ``isolated``; ``path`` is an object path relative to the workload
    (e.g. ``nodes['s0b0_add'].inputs[1]``).  Kept dependency-free so the
    core stays importable without :mod:`repro.analysis`.
    """

    kind: str
    path: str
    message: str


class Workload:
    """An ordered DAG of :class:`OpNode`."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: Dict[str, OpNode] = {}
        # content digest of the traced program this DAG was lowered from
        # (repro.trace); None for hand-built workloads.  Part of the
        # explore-cache key so traced DAGs are addressed by program.
        self.source_digest: Optional[str] = None

    # -- construction --------------------------------------------------------
    def add(self, node: OpNode) -> OpNode:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name!r}")
        for inp in node.inputs:
            if inp not in self.nodes:
                raise ValueError(f"{node.name}: unknown input {inp!r}")
        self.nodes[node.name] = node
        return node

    def conv(self, name, cin, cout, hw, k=3, stride=1, inputs=(),
             depthwise=False, prunable=True):
        """Add a conv; returns (node, out_hw)."""
        out_hw = math.ceil(hw / stride)
        v = out_hw * out_hw
        if depthwise:
            node = OpNode(name=name, kind="dwconv", inputs=tuple(inputs),
                          K=k * k, N=cout, V=v, c_in=cin, kernel=(k, k),
                          weight_count=k * k * cout, prunable=False)
        else:
            node = OpNode(name=name, kind="conv", inputs=tuple(inputs),
                          K=cin * k * k, N=cout, V=v, c_in=cin,
                          kernel=(k, k), prunable=prunable)
        self.add(node)
        return node, out_hw

    def fc(self, name, cin, cout, inputs=(), v=1, prunable=True):
        return self.add(OpNode(name=name, kind="fc", inputs=tuple(inputs),
                               K=cin, N=cout, V=v, c_in=cin,
                               prunable=prunable))

    def simple(self, name, kind, elements, inputs=()):
        return self.add(OpNode(name=name, kind=kind, elements=elements,
                               inputs=tuple(inputs)))

    # -- DAG structure --------------------------------------------------------
    def successors(self) -> Dict[str, List[str]]:
        """Producer → consumers adjacency (insertion-ordered)."""
        succ: Dict[str, List[str]] = {name: [] for name in self.nodes}
        for node in self.nodes.values():
            for inp in node.inputs:
                if inp not in succ:
                    raise ValueError(
                        f"{node.name}: unknown input {inp!r}")
                succ[inp].append(node.name)
        return succ

    def topo_order(self) -> List[str]:
        """Topological op order (Kahn), stable w.r.t. insertion order.

        :meth:`add` already forbids forward references, so workloads built
        through the public API are topologically ordered by construction —
        but the scheduler (:mod:`repro.core.schedule`) must not trust
        callers that splice ``nodes`` directly, so cycles raise
        ``ValueError`` here.
        """
        succ = self.successors()
        indeg = {name: len(node.inputs) for name, node in self.nodes.items()}
        ready = deque(name for name, d in indeg.items() if d == 0)
        order: List[str] = []
        while ready:
            name = ready.popleft()
            order.append(name)
            for s in succ[name]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        if len(order) != len(self.nodes):
            stuck = sorted(n for n, d in indeg.items() if d > 0)
            raise ValueError(
                f"workload {self.name!r} has a dependency cycle "
                f"involving {stuck}")
        return order

    def levels(self) -> List[List[str]]:
        """ASAP dependency levels: ``levels()[i]`` holds the ops whose
        longest input chain has exactly ``i`` predecessors — ops within a
        level are mutually independent and may run concurrently (the
        grouping the partitioned scheduler exploits).  Raises on cycles.
        """
        depth: Dict[str, int] = {}
        for name in self.topo_order():
            node = self.nodes[name]
            depth[name] = (max(depth[i] for i in node.inputs) + 1
                           if node.inputs else 0)
        out: List[List[str]] = [[] for _ in range(max(depth.values(), default=-1) + 1)]
        for name in self.nodes:              # insertion order within levels
            out[depth[name]].append(name)
        return out

    def validate(self) -> List["WorkloadIssue"]:
        """Exhaustive structural audit of the DAG.

        Unlike :meth:`topo_order`, which raises on the first cycle, this
        reports *every* problem at once — dangling edge targets, dict-key /
        node-name mismatches (the splice hazard duplicate detection in
        :meth:`add` cannot see), cycle members, and isolated ops — as
        :class:`WorkloadIssue` records.  ``repro.analysis`` converts these
        into coded diagnostics (CIM301–CIM304); library callers can treat a
        non-empty ``[i for i in w.validate() if i.kind != "isolated"]`` as
        fatal.
        """
        issues: List[WorkloadIssue] = []
        for key, node in self.nodes.items():
            if key != node.name:
                issues.append(WorkloadIssue(
                    "name-mismatch", f"nodes[{key!r}]",
                    f"dict key {key!r} != node.name {node.name!r}"))
            for i, inp in enumerate(node.inputs):
                if inp not in self.nodes:
                    issues.append(WorkloadIssue(
                        "dangling-edge", f"nodes[{key!r}].inputs[{i}]",
                        f"{key!r} consumes unknown op {inp!r}"))
        # Kahn over the *resolvable* edges so cycles are reported even
        # when dangling edges coexist; stuck nodes are the cycle members.
        indeg = {k: sum(1 for i in n.inputs if i in self.nodes)
                 for k, n in self.nodes.items()}
        consumers: Dict[str, List[str]] = {k: [] for k in self.nodes}
        for k, n in self.nodes.items():
            for inp in n.inputs:
                if inp in self.nodes:
                    consumers[inp].append(k)
        ready = deque(k for k, d in indeg.items() if d == 0)
        visited = 0
        while ready:
            k = ready.popleft()
            visited += 1
            for c in consumers[k]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if visited != len(self.nodes):
            stuck = [k for k, d in indeg.items() if d > 0]
            for k in stuck:
                issues.append(WorkloadIssue(
                    "cycle", f"nodes[{k!r}]",
                    f"{k!r} is part of a dependency cycle "
                    f"(members: {sorted(stuck)})"))
        if len(self.nodes) > 1:
            for k, n in self.nodes.items():
                if not n.inputs and not consumers[k]:
                    issues.append(WorkloadIssue(
                        "isolated", f"nodes[{k!r}]",
                        f"{k!r} has no inputs and no consumers — "
                        f"disconnected from the DAG"))
        return issues

    # -- queries --------------------------------------------------------------
    def mvm_ops(self, scope: str = "all") -> List[OpNode]:
        ops = [n for n in self.nodes.values() if n.is_mvm or n.kind == "dwconv"]
        if scope == "conv_only":
            ops = [n for n in ops if n.kind in ("conv", "dwconv")]
        return ops

    def other_ops(self) -> List[OpNode]:
        return [n for n in self.nodes.values()
                if not n.is_mvm and n.kind != "dwconv"]

    def total_macs(self, scope: str = "all") -> int:
        return sum(n.macs for n in self.mvm_ops(scope))

    def total_weights(self) -> int:
        return sum(n.weights for n in self.nodes.values())

    def set_sparsity(self, spec, *,
                     kinds: Iterable[str] = ("conv", "fc", "matmul")) -> "Workload":
        """Assign a FlexBlock spec to every prunable MVM op (in place).

        ``spec`` is either a :class:`FlexBlockSpec` or a callable
        ``op -> FlexBlockSpec`` for per-op binding (e.g. channel-wise
        patterns whose block height is the op's own ``c_in``).
        """
        for n in self.nodes.values():
            if n.kind in kinds and n.prunable:
                n.sparsity = spec(n) if callable(spec) else spec
        return self

    def __len__(self):
        return len(self.nodes)

    def __repr__(self):
        return (f"Workload({self.name!r}, ops={len(self.nodes)}, "
                f"macs={self.total_macs():.3e}, weights={self.total_weights():.3e})")


# ---------------------------------------------------------------------------
# Paper evaluation models.
# ---------------------------------------------------------------------------

def vgg16(img: int = 32, num_classes: int = 100) -> Workload:
    """VGG16 (CIFAR variant when img=32, ImageNet when img=224)."""
    w = Workload(f"vgg16-{img}")
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    hw, cin, prev, i = img, 3, (), 0
    for v in cfg:
        if v == "M":
            hw //= 2
            node = w.simple(f"pool{i}", "pool", cin * hw * hw, inputs=prev)
            prev = (node.name,)
        else:
            node, hw = w.conv(f"conv{i}", cin, v, hw, k=3, inputs=prev)
            act = w.simple(f"relu{i}", "act", v * hw * hw, inputs=(node.name,))
            prev, cin = (act.name,), v
            i += 1
    flat = cin * hw * hw
    if img >= 224:
        f1 = w.fc("fc1", flat, 4096, inputs=prev)
        f2 = w.fc("fc2", 4096, 4096, inputs=(f1.name,))
        w.fc("fc3", 4096, num_classes, inputs=(f2.name,))
    else:
        f1 = w.fc("fc1", flat, 512, inputs=prev)
        w.fc("fc2", 512, num_classes, inputs=(f1.name,))
    return w


def _resnet(name: str, blocks, bottleneck: bool, img: int,
            num_classes: int) -> Workload:
    w = Workload(f"{name}-{img}")
    stem_stride = 2 if img >= 224 else 1
    node, hw = w.conv("stem", 3, 64, img, k=7 if img >= 224 else 3,
                      stride=stem_stride)
    prev = (node.name,)
    if img >= 224:
        hw //= 2
        p = w.simple("stem_pool", "pool", 64 * hw * hw, inputs=prev)
        prev = (p.name,)
    cin = 64
    expansion = 4 if bottleneck else 1
    for stage, (n_blocks, width) in enumerate(zip(blocks, (64, 128, 256, 512))):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            tag = f"s{stage}b{b}"
            if bottleneck:
                c1, hw1 = w.conv(f"{tag}_c1", cin, width, hw, k=1, inputs=prev)
                c2, hw2 = w.conv(f"{tag}_c2", width, width, hw1, k=3,
                                 stride=stride, inputs=(c1.name,))
                c3, hw3 = w.conv(f"{tag}_c3", width, width * 4, hw2, k=1,
                                 inputs=(c2.name,))
                out_c, out_hw, last = width * 4, hw3, c3
            else:
                c1, hw1 = w.conv(f"{tag}_c1", cin, width, hw, k=3,
                                 stride=stride, inputs=prev)
                c2, hw2 = w.conv(f"{tag}_c2", width, width, hw1, k=3,
                                 inputs=(c1.name,))
                out_c, out_hw, last = width, hw2, c2
            sc_inputs = [last.name]
            if stride != 1 or cin != out_c:
                sc, _ = w.conv(f"{tag}_sc", cin, out_c, hw, k=1,
                               stride=stride, inputs=prev)
                sc_inputs.append(sc.name)
            add = w.simple(f"{tag}_add", "add", out_c * out_hw * out_hw,
                           inputs=tuple(sc_inputs))
            prev, cin, hw = (add.name,), out_c, out_hw
    gap = w.simple("gap", "pool", cin, inputs=prev)
    w.fc("fc", cin, num_classes, inputs=(gap.name,))
    return w


def resnet18(img: int = 32, num_classes: int = 100) -> Workload:
    return _resnet("resnet18", (2, 2, 2, 2), False, img, num_classes)


def resnet50(img: int = 32, num_classes: int = 100) -> Workload:
    return _resnet("resnet50", (3, 4, 6, 3), True, img, num_classes)


def mobilenet_v2(img: int = 32, num_classes: int = 100) -> Workload:
    """MobileNetV2: inverted residuals; depthwise convs are not prunable
    (§VII-B restricts pruning to standard convs)."""
    w = Workload(f"mobilenetv2-{img}")
    node, hw = w.conv("stem", 3, 32, img, k=3, stride=2 if img >= 224 else 1)
    prev, cin = (node.name,), 32
    # (expansion t, out channels c, repeats n, stride s)
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    for i, (t, c, n, s) in enumerate(cfg):
        for j in range(n):
            stride = s if j == 0 else 1
            tag = f"ir{i}_{j}"
            hidden = cin * t
            cur = prev
            if t != 1:
                e, _ = w.conv(f"{tag}_exp", cin, hidden, hw, k=1, inputs=cur)
                cur = (e.name,)
            d, hw2 = w.conv(f"{tag}_dw", hidden, hidden, hw, k=3,
                            stride=stride, inputs=cur, depthwise=True)
            p, _ = w.conv(f"{tag}_pw", hidden, c, hw2, k=1, inputs=(d.name,))
            if stride == 1 and cin == c:
                a = w.simple(f"{tag}_add", "add", c * hw2 * hw2,
                             inputs=(p.name, prev[0]))
                prev = (a.name,)
            else:
                prev = (p.name,)
            cin, hw = c, hw2
    head, _ = w.conv("head", cin, 1280, hw, k=1, inputs=prev)
    gap = w.simple("gap", "pool", 1280, inputs=(head.name,))
    w.fc("fc", 1280, num_classes, inputs=(gap.name,))
    return w


# ---------------------------------------------------------------------------
# LM architecture lowering: turn a repro model config into an MVM DAG so the
# modeling plane can cost LM inference on CIM hardware.
# ---------------------------------------------------------------------------

def lm_workload(cfg, *, seq_len: int = 128, batch: int = 1) -> Workload:
    """Lower an :class:`repro.configs.base.ArchConfig` into per-layer MVM ops.

    One representative layer block is emitted per *distinct* layer kind and
    scaled by its repeat count via ``V`` (the simulator costs are linear in
    V, so folding repeats keeps the DAG compact — the paper's Fig. 7 notes
    runtime scales with op count).
    """
    w = Workload(f"lm-{cfg.name}")
    v = seq_len * batch
    d = cfg.d_model
    head_dim = cfg.head_dim
    q_out = cfg.n_heads * head_dim
    kv_out = cfg.n_kv_heads * head_dim
    L = cfg.n_layers
    emb = w.add(OpNode(name="embed", kind="embed", elements=v * d,
                       weight_count=cfg.vocab_size * d))
    prev = (emb.name,)
    if cfg.attention != "none":
        q = w.fc("attn_q", d, q_out, inputs=prev, v=v * L)
        k = w.fc("attn_k", d, kv_out, inputs=prev, v=v * L)
        vv = w.fc("attn_v", d, kv_out, inputs=prev, v=v * L)
        # score/context matmuls: activation×activation, costed as matmul.
        # Per head and layer the score GEMM pushes one seq_len-long vector
        # batch of head_dim-deep queries against the K^T matrix, so
        # V = heads × layers × batch × seq_len — spelled out explicitly
        # (the old `n_heads * v * L // seq_len * seq_len` relied on
        # left-to-right // precedence to cancel the seq_len factor).
        sc = w.add(OpNode(name="attn_scores", kind="matmul",
                          inputs=(q.name, k.name),
                          K=head_dim, N=seq_len,
                          V=cfg.n_heads * batch * L * seq_len,
                          prunable=False, weight_count=0))
        # context matmul (probs·V): same volume shape as the score GEMM
        # transposed — seq_len-deep reduction producing head_dim columns
        # for every (head, layer, batch, query) vector.  The historical
        # DAG omitted it, undercounting attention MACs by half; the
        # traced-model differential harness (repro.trace) pinned it.
        ctx = w.add(OpNode(name="attn_ctx", kind="matmul",
                           inputs=(sc.name, vv.name),
                           K=seq_len, N=head_dim,
                           V=cfg.n_heads * batch * L * seq_len,
                           prunable=False, weight_count=0))
        o = w.fc("attn_o", q_out, d, inputs=(ctx.name,), v=v * L)
        prev = (o.name,)
    if cfg.n_experts > 1:
        # MoE: top-k experts active per token; V scales by top_k
        g = w.fc("moe_gate", d, cfg.n_experts, inputs=prev, v=v * L)
        n_up = 2 if cfg.gated_mlp else 1
        up = w.fc("expert_up", d, cfg.d_ff * n_up, inputs=(g.name,),
                  v=v * L * cfg.top_k)
        down = w.fc("expert_down", cfg.d_ff, d, inputs=(up.name,),
                    v=v * L * cfg.top_k)
        # expert weights replicated n_experts times for storage accounting
        up.weight_count = d * cfg.d_ff * n_up * cfg.n_experts
        down.weight_count = cfg.d_ff * d * cfg.n_experts
        prev = (down.name,)
    elif cfg.d_ff > 0:
        n_up = 2 if cfg.gated_mlp else 1
        up = w.fc("mlp_up", d, cfg.d_ff * n_up, inputs=prev, v=v * L)
        down = w.fc("mlp_down", cfg.d_ff, d, inputs=(up.name,), v=v * L)
        prev = (down.name,)
    if cfg.ssm_state > 0:
        din = cfg.ssm_inner(d)
        xp = w.fc("ssm_in_proj", d, din * 2, inputs=prev, v=v * L)
        op = w.fc("ssm_out_proj", din, d, inputs=(xp.name,), v=v * L)
        prev = (op.name,)
    norm = w.simple("final_norm", "norm", v * d, inputs=prev)
    w.fc("lm_head", d, cfg.vocab_size, inputs=(norm.name,), v=v)
    return w


MODEL_BUILDERS = {
    "vgg16": vgg16,
    "resnet18": resnet18,
    "resnet50": resnet50,
    "mobilenetv2": mobilenet_v2,
}
