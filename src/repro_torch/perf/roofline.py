"""Three-term roofline model for the NVIDIA H100 SXM (the reference's
``repro.perf.roofline``, rebuilt for the card).

  compute term    = FLOPs_per_device / peak FLOP/s (dense bf16)
  memory term     = HBM bytes_per_device / HBM bandwidth
  collective term = effective link bytes_per_device / link bandwidth

All three are per-device seconds of one step and directly comparable: the
largest is the bottleneck. Collective bytes come from records of the
collectives a step issued, ``(op, result_bytes, group)``, as a
``TorchDispatchMode`` over the ``_c10d_functional`` ops gives them
(``record_collectives``), and the reference's ring-algorithm effective-byte
formulas, op for op:

  all-gather(out S, group g):       S * (g-1)/g
  reduce-scatter(out S, group g):   S * (g-1)          (input = S*g)
  all-reduce(out S, group g):       2 * S * (g-1)/g    (RS + AG)
  all-to-all(out S, group g):       S * (g-1)/g
  collective-permute(out S):        S                  (broadcast too)

The link rate depends on the group: a group of at most
``HW["nvlink_domain"]`` GPUs (one HGX board) talks over NVLink, a wider one
crosses nodes at each GPU's InfiniBand rate.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          is_traceable_wrapper_subclass)
from torch.utils.flop_counter import flop_registry

__all__ = ["HW", "hbm_bytes", "link_bw", "parse_collectives",
           "collective_bytes", "record_collectives", "op_name", "PeakMemory",
           "roofline_terms", "model_flops", "RooflineReport"]

HW = {
    # NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: dense BF16 tensor
    # core 989.4 TFLOP/s (1979 with sparsity)
    "peak_flops_bf16": 989e12,
    # the same datasheet: FP32 on the CUDA cores, 67 TFLOP/s
    "peak_flops_fp32": 67e12,
    # the same datasheet: HBM3, 3.35 TB/s
    "hbm_bw": 3.35e12,
    # the same datasheet: NVLink 4, 900 GB/s per GPU both ways, 450 each way
    "nvlink_bw": 450e9,
    # GPUs that share one NVLink domain (HGX H100 8-GPU board)
    "nvlink_domain": 8,
    # ConnectX-7 InfiniBand NDR, 400 Gb/s per GPU: 50 GB/s each way
    "ib_bw": 50e9,
    # the same datasheet: 80 GB of HBM3 (hbm_bytes() reads the card's)
    "hbm_bytes": 80e9,
}

# op names of the reference's HLO parser, for each functional collective
_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def op_name(name: str) -> str | None:
    """The reference's op name of a functional collective (its packet's
    name, e.g. ``"all_gather_into_tensor"``), or None."""
    return _OPS.get(name)


def hbm_bytes() -> float:
    """The card's memory where there is one, else the datasheet's 80 GB."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HW["hbm_bytes"]


def link_bw(group: int) -> float:
    """Bytes/s each way per GPU for a collective over ``group`` GPUs."""
    return HW["nvlink_bw"] if group <= HW["nvlink_domain"] else HW["ib_bw"]


def _effective(op: str, size: int, g: int) -> float:
    if op == "all-gather":
        return size * (g - 1) / max(g, 1)
    if op == "reduce-scatter":
        return size * (g - 1)
    if op == "all-reduce":
        return 2 * size * (g - 1) / max(g, 1)
    if op == "all-to-all":
        return size * (g - 1) / max(g, 1)
    return size  # collective-permute


def parse_collectives(records, trips: dict | None = None) -> list[dict]:
    """Every collective of ``records``: ``(op, result_bytes, group)`` or the
    same with a fourth entry, the scope names the op ran under.

    ``trips`` maps scope names to trip counts, as the reference's: a
    collective recorded once under scope s stands for ``trips[s]`` runs;
    nested scopes multiply. Ops of size 0 are dropped, as the reference's
    parser drops them.
    """
    out = []
    for rec in records:
        op, size, g = rec[0], int(rec[1]), int(rec[2])
        scope = rec[3] if len(rec) > 3 else ""
        if size == 0:
            continue
        eff = _effective(op, size, g)
        mult = 1
        if trips and scope:
            for s, n in trips.items():
                if s in scope:
                    mult *= max(1, int(n))
        out.append({"op": op, "result_bytes": size, "group": g,
                    "effective_bytes": eff * mult, "trip_mult": mult})
    return out


def collective_bytes(records, trips: dict | None = None) -> dict:
    """The reference's per-op sums over ``parse_collectives(records)``, and
    ``link_s``: each op's effective bytes over its group's link rate."""
    ops = parse_collectives(records, trips)
    by_op: dict = {}
    for o in ops:
        d = by_op.setdefault(o["op"], {"count": 0, "result_bytes": 0,
                                       "effective_bytes": 0.0})
        d["count"] += o["trip_mult"]
        d["result_bytes"] += o["result_bytes"] * o["trip_mult"]
        d["effective_bytes"] += o["effective_bytes"]
    return {
        "total_effective_bytes": sum(o["effective_bytes"] for o in ops),
        "n_collective_sites": len(ops),
        "n_collective_execs": sum(o["trip_mult"] for o in ops),
        "link_s": sum(o["effective_bytes"] / link_bw(o["group"]) for o in ops),
        "by_op": by_op,
    }


# ops whose H100 kernels allocate, beyond their outputs, scratch the size
# of their first argument and free it before they return (torch 2.11,
# chip_smoke.py's per-op allocator readings at the LM cells' shapes):
# softmax's backward a copy of its gradient (1 GiB for a float32
# (2, 32, 1024, 4096) one), logsumexp one of its input
_SCRATCH = frozenset({torch.ops.aten._softmax_backward_data.default,
                      torch.ops.aten.logsumexp.default})
_LIFT_FRESH = torch.ops.aten.lift_fresh.default
# the dispatch of a tensor with no handler of its own (a plain tensor or a
# Parameter)
_PLAIN = torch.Tensor.__torch_dispatch__


def _tensors(xs, acc: list) -> list:
    """``acc`` and the tensors among an op's arguments or outputs (lists
    and tuples of them included)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            acc.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, acc)
    return acc


def _storages(t, func) -> list:
    """The storages behind a tensor: a DTensor's local shard's, a wrapper
    subclass's inner tensors'; none behind a fake tensor (DTensor's
    sharding propagation runs each op on fake tensors of the global shape
    first). Raises where there is none to count."""
    if type(t) is torch.Tensor:
        return [t.untyped_storage()]
    if isinstance(t, FakeTensor):
        return []
    if is_traceable_wrapper_subclass(t):
        names, _ = t.__tensor_flatten__()
        inner = [getattr(t, n) for n in names]
        return [s for x in inner if isinstance(x, torch.Tensor)
                for s in _storages(x, func)]
    try:
        return [t.untyped_storage()]
    except (RuntimeError, NotImplementedError) as e:
        raise TypeError(f"PeakMemory: {func} gave a {t.layout} "
                        f"{type(t).__name__} with no storage to count") from e


class PeakMemory:
    """The bytes of storage that a window of ops allocates and frees, and
    their peak: what ``torch.cuda.max_memory_allocated()`` less
    ``memory_allocated()`` at the window's start reads for the same ops,
    less the allocator's rounding, on ``meta``, CPU and CUDA tensors alike.

    Fed by ``record_collectives(memory=...)`` (or ``with PeakMemory():``),
    it sees every op the dispatcher runs in the window:

    - a storage is counted once, when it first comes out of an op without
      having gone in (a view or an in-place op allocates nothing), and
      freed when it dies (a weak reference on the storage, whose Python
      object torch keeps while the storage lives);
    - a storage that existed before the window (an argument, a module's
      buffer) is watched from its first use: its death frees its bytes, as
      the allocator sees a donated leaf replaced by its update;
    - a DTensor counts by its local shard. DTensor's own dispatch (its
      redistributions' chunks, copies and collective outputs, its local
      ops) runs below a mode that handles its ops, which then does not
      see it (the FLOP counter's case): this mode hands a DTensor
      op back to DTensor, under which its local ops come back here, so
      those temporaries count too.

    A kernel's own scratch (memory it allocates and frees before it
    returns) does not come out of the op. The H100's largest, measured
    there (``_SCRATCH``: softmax's backward, logsumexp), are counted as
    live while their op runs, on every device, so that ``meta`` reads the
    card's peak. It does not see other kernels' scratch (a cuBLAS
    workspace; a reduction's staging buffer, 140 MB in the largest of the
    LM cell's sums), what C++ code allocates outside the dispatcher, nor
    ops run on another thread without the mode (autograd's CUDA thread
    carries it).

    ``peak_bytes`` is the largest net change of the live bytes since the
    window opened; ``top()`` the largest storages allocated in the window
    and live at that peak, grouped by (op, local shape, dtype).
    """

    def __init__(self):
        self.live = 0
        self.peak_bytes = 0
        self._refs: dict = {}     # storage key -> its weak reference
        self._born: set = set()   # keys of the window's live allocations
        self._events: list = []   # (key, +-bytes, info or None)
        self._peak_at = 0
        self._open = True

    def __enter__(self):
        self._mode = _Inner(memory=self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self.close()

    # -- bookkeeping (weakref callbacks may run between any two lines) --
    def _died(self, key, nbytes, ref):
        if self._open and self._refs.get(key) is ref:
            del self._refs[key]
            self._born.discard(key)
            self._events.append((key, -nbytes, None))
            self.live -= nbytes

    def _watch(self, st, nbytes, info):
        key = st._cdata
        self._refs[key] = weakref.ref(
            st, functools.partial(self._died, key, st.nbytes()))
        if nbytes:
            self._born.add(key)
            self._events.append((key, nbytes, info))
            self.live += nbytes
            if self.live > self.peak_bytes:
                self.peak_bytes = self.live
                self._peak_at = len(self._events)

    def _scratch(self, func, arg, nbytes):
        """A kernel's scratch, live while its op runs: a peak of its own."""
        if self.live + nbytes > self.peak_bytes:
            key = ("scratch", len(self._events))
            self._events.append((key, nbytes, (f"{func} scratch", arg.shape,
                                               arg.dtype)))
            self.peak_bytes = self.live + nbytes
            self._peak_at = len(self._events)
            self._events.append((key, -nbytes, None))

    def seen(self, func, args, kwargs, out) -> None:
        """Account one op on plain tensors: its inputs' storages, then its
        outputs', then its kernel's scratch. ``lift_fresh``'s input is a
        tensor just made from Python data (``torch.tensor``), outside the
        dispatcher: it counts as allocated here, not as resident."""
        refs = self._refs
        if func is not _LIFT_FRESH:
            ins = _tensors(args, [])
            if kwargs:
                _tensors(kwargs.values(), ins)
            for t in ins:
                for st in _storages(t, func):
                    if st._cdata not in refs:
                        self._watch(st, 0, None)
        for t in _tensors((out,), []):
            for st in _storages(t, func):
                if st._cdata not in refs and st.nbytes():
                    self._watch(st, st.nbytes(), (func, t.shape, t.dtype))
        if func in _SCRATCH:
            self._scratch(func, args[0],
                          args[0].numel() * args[0].element_size())

    def born(self, t: torch.Tensor) -> bool:
        """Whether ``t``'s storages were allocated in the window (asked of
        a tensor that is still alive)."""
        return all(st._cdata in self._born for st in _storages(t, "born"))

    def close(self) -> None:
        """Stop counting; what died until now is counted, nothing after."""
        self._open = False
        self._refs.clear()

    def top(self, n: int = 8) -> list[dict]:
        """The ``n`` largest groups of storages allocated in the window and
        live at the peak: op, shape, dtype, bytes of one, count."""
        live: dict = {}
        for key, nbytes, info in self._events[:self._peak_at]:
            if nbytes > 0:
                live[key] = (nbytes, info)
            else:
                live.pop(key, None)
        groups: dict = {}
        for nbytes, info in live.values():
            g = groups.setdefault((info, nbytes), [0])
            g[0] += 1
        rows = [{"op": str(info[0]), "shape": list(info[1]),
                 "dtype": str(info[2]), "bytes": nbytes, "count": c[0]}
                for (info, nbytes), c in groups.items()]
        return sorted(rows, key=lambda r: -r["bytes"] * r["count"])[:n]


class _Inner(TorchDispatchMode):
    """The mode below any FLOP counter: every op on plain tensors comes
    here, and a tensor subclass's op (DTensor's) is handed back to the
    subclass (NotImplemented), whose own ops on its inner tensors (its
    local ops and redistributions) then come here too. It appends every
    functional collective to ``records`` (explicit ones and those DTensor
    issues inside an op's dispatch alike) and, given a ``memory``, counts
    every op's storages. Fake tensors (DTensor's sharding propagation) run
    through, unseen."""

    def __init__(self, memory=None, records=None):
        super().__init__()
        self.memory = memory
        self.records = records

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__torch_dispatch__ is not _PLAIN for t in types):
            if any(not issubclass(t, FakeTensor) for t in types):
                return NotImplemented
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if self.memory is not None:
            self.memory.seen(func, args, kwargs, out)
        if self.records is not None:
            _record(self.records, func, args, kwargs, out)
        return out


def _record(records, func, args, kwargs, out) -> None:
    """Append ``(op, result_bytes, group)`` where ``func`` is a functional
    collective."""
    pkt = func.overloadpacket
    if not (getattr(pkt, "_qualified_op_name", "").startswith(
            "_c10d_functional::") and pkt.__name__ in _OPS):
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = args[-1] if isinstance(args[-1], str) else kwargs.get("group_name")
    g = _resolve_process_group(group).size()
    res = out if isinstance(out, (list, tuple)) else [out]
    records.append((_OPS[pkt.__name__],
                    sum(t.numel() * t.element_size() for t in res), g))


class _Flops(TorchDispatchMode):
    """The mode above ``_Inner``: it sees the ops the step itself calls, a
    DTensor op once (its sharding propagation and local ops run below it),
    and adds the FLOPs of each that ``torch.utils.flop_counter`` has a
    formula for."""

    def __init__(self, flops):
        super().__init__()
        self.flops = flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        pkt = func.overloadpacket
        if pkt in flop_registry:
            from repro_torch.dist.sharding import is_sharded

            key = "sharded" if any(map(is_sharded, args)) else "local"
            self.flops[key] += flop_registry[pkt](*args, **kwargs,
                                                  out_val=out)
        return out


@contextlib.contextmanager
def record_collectives(flops: dict | None = None,
                       memory: PeakMemory | None = None):
    """Yields a list that fills with ``(op, result_bytes, group)`` for every
    functional collective dispatched inside the context: explicit
    redistributions (``constrain``, ``shard_map``'s inputs),
    ``torch.distributed._functional_collectives``, and the collectives
    DTensor issues inside an op's own dispatch (an operand it redistributes
    to run the op): each once, as ``CommDebugMode`` counts them.

    ``flops``, a dict, also gathers the FLOPs of every op that
    ``torch.utils.flop_counter`` has a formula for: under ``"sharded"``
    those of DTensor ops, on their global shapes, and under ``"local"``
    those of plain tensors' ops that the window itself calls (a per-rank
    function's, on one rank's shards); the local ops DTensor runs beneath
    its own ops are not counted again.

    ``memory``, a :class:`PeakMemory`, counts the window's storages as
    well (DTensor's own dispatch included), in the same run of the ops.
    """
    records: list = []
    if flops is not None:
        flops.setdefault("sharded", 0)
        flops.setdefault("local", 0)
    try:
        with _Inner(memory, records):
            with (_Flops(flops) if flops is not None
                  else contextlib.nullcontext()):
                yield records
    finally:
        if memory is not None:
            memory.close()


def model_flops(n_params: int, n_tokens: int, kind: str = "train",
                n_active_params: int | None = None) -> float:
    """6*N*D for train, 2*N*D per forward (MoE: N = active params)."""
    n = n_active_params if n_active_params is not None else n_params
    per_tok = 6.0 * n if kind == "train" else 2.0 * n
    return per_tok * n_tokens


@dataclasses.dataclass
class RooflineReport:
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops_total: float
    useful_flops_ratio: float  # MODEL_FLOPS / (FLOPs * n_devices)

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float, *, n_devices: int,
                   model_flops_total: float = 0.0,
                   extra_flops: float = 0.0,
                   extra_bytes: float = 0.0,
                   group: int | None = None,
                   collective_s: float | None = None) -> RooflineReport:
    """The three terms of one step.

    The collective term is ``collective_s`` when given (``collective_bytes``'s
    ``link_s``, each op at its own group's rate), else the bytes over the
    link rate of ``group`` GPUs (``n_devices`` when None).
    """
    f = flops_per_device + extra_flops
    by = bytes_per_device + extra_bytes
    c = f / HW["peak_flops_bf16"]
    m = by / HW["hbm_bw"]
    if collective_s is None:
        collective_s = coll_bytes_per_device / link_bw(
            n_devices if group is None else group)
    terms = {"compute": c, "memory": m, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    ratio = (model_flops_total / (f * n_devices)) if f > 0 else 0.0
    return RooflineReport(c, m, collective_s, bottleneck, f, by,
                          coll_bytes_per_device, model_flops_total, ratio)
