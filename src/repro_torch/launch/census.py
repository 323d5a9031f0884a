"""The dry run's counts: one ``TorchDispatchMode`` over a step on a live
mesh (no twin in the reference, where XLA's compiled module gives them).

``Census`` sees every ATen op on each rank's *local* tensors: it defers
ops on DTensors (returning ``NotImplemented``, so that DTensor first
turns them into local ops and collectives, which the mode then sees), and
skips the ops DTensor runs on global shapes only to propagate metadata.
So every number is per device, as the reference's ``cost_analysis`` and
``memory_analysis`` are:

* ``flops``: ``torch.utils.flop_counter``'s formulas on the local shapes
  (the kernels' custom ops register theirs, ``kernels/flash_attention.py``
  and ``kernels/ssd_scan.py``); ops without a formula count none, as
  ``FlopCounterMode`` counts them;
* ``bytes_accessed``: the bytes of every op's tensor inputs plus its
  outputs, views and collectives excepted: eager traffic with no fusion,
  so an upper bound on what a fused program moves (XLA's figure counts
  fused regions once);
* ``peak_bytes``: the most bytes held at once by tensors the step
  allocated (each storage from its creating op until it is freed; an
  in-place write into an input, such as a donated argument, allocates
  nothing; sizes
  rounded up to the CUDA caching allocator's 512-byte blocks), above
  whatever was alive before: the temp column, to compare with
  ``torch.cuda.max_memory_allocated()`` above the arguments;
* ``collectives``: every collective, DTensor's ``_c10d_functional`` ops
  and the dist layer's own ``torch.distributed`` calls
  (``dist.collectives``, ``dist.compression``, ``decode_attn``'s ring of
  sends, recorded as ``collective-permute``), keyed as
  ``launch.hlo.collective_bytes`` keys them: ``bytes_by_kind``,
  ``count_by_kind`` and ``total_bytes`` in per-device *operand* bytes,
  and ``largest_by_kind`` (the largest single op of each kind); the
  per-op records (kind, bytes, group size, the first operand's shape) in
  program order stay on the
  census as ``ops``.  ``bytes_by_kind`` is the census
  ``trace.schedule_to_trace`` replays on the NoC.
"""
from __future__ import annotations

import weakref
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the CUDA caching allocator's block size (allocations round up to it)
BLOCK = 512

_FUNCOL = {"all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_out": "all-gather",
           "reduce_scatter_tensor": "reduce-scatter",
           "all_reduce": "all-reduce",
           "all_to_all_single": "all-to-all"}
_C10D = {"allreduce_": "all-reduce", "allgather_": "all-gather",
         "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "send": "collective-permute"}
_SKIP = {"wait_tensor", "recv_", "recv_any_source_", "barrier",
         "monitored_barrier_"}


def _tensors(x):
    """The tensors in an argument (lists of lists included)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    """``t``'s storage, or None for a tensor without one."""
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def _group_size(args) -> int:
    """The group size of a collective's arguments: an int (funcol's
    ``group_size``), else the group named by a string (funcol's
    ``group_name``) or passed as a ``ProcessGroup`` (c10d's ops)."""
    from torch.distributed import distributed_c10d as c10d
    for a in args:
        if isinstance(a, int) and not isinstance(a, bool):
            return a
    for a in args:
        try:
            if isinstance(a, str):
                return int(c10d._resolve_process_group(a).size())
            if not isinstance(a, (torch.Tensor, list, tuple)) \
                    and hasattr(a, "size"):
                return int(a.size())
        except (TypeError, RuntimeError, ValueError, KeyError):
            continue
    return 1


class Census(TorchDispatchMode):
    """Counts of the ops run while it is entered (see the module
    docstring).  Enter it inside the case's ``FakeTensorMode`` (or around
    a real run): ``with case.mode, Census() as c: case.fn(*case.args)``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.ops: list[dict] = []
        self.live = 0
        self.peak_bytes = 0
        self._seen: set[int] = set()
        self._in_prop = 0
        self._undo: list = []
        self._names: Counter = Counter()

    # -- counts --------------------------------------------------------
    def collectives(self) -> dict:
        by_kind: dict[str, int] = defaultdict(int)
        largest: dict[str, int] = defaultdict(int)
        counts: Counter = Counter()
        for op in self.ops:
            by_kind[op["kind"]] += op["bytes"]
            largest[op["kind"]] = max(largest[op["kind"]], op["bytes"])
            counts[op["kind"]] += 1
        return {"bytes_by_kind": dict(by_kind),
                "count_by_kind": dict(counts),
                "largest_by_kind": dict(largest),
                "total_bytes": int(sum(by_kind.values()))}

    def op_census(self, top: int = 12) -> list[tuple[str, int]]:
        """The most frequent ops (the reference's HLO ``op_census``)."""
        return self._names.most_common(top)

    def summary(self) -> dict:
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes_accessed),
                "peak_bytes": int(self.peak_bytes),
                "collectives": self.collectives()}

    # -- the mode ------------------------------------------------------
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        real = ShardingPropagator._propagate_tensor_meta_non_cached
        census = self

        def propagate(prop, op_schema):
            census._in_prop += 1
            try:
                return real(prop, op_schema)
            finally:
                census._in_prop -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        self._undo.append(lambda: setattr(
            ShardingPropagator, "_propagate_tensor_meta_non_cached", real))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            while self._undo:
                self._undo.pop()()

    def _freed(self, nbytes: int, key: int) -> None:
        self.live -= nbytes
        self._seen.discard(key)

    def _track(self, out, ins=()) -> None:
        """Count the storages of ``out`` that are new: an output on the
        storage of one of the op's inputs ``ins`` (an in-place write, as
        into a donated argument) allocates nothing."""
        held = {id(_storage(t)) for t in ins}
        for t in _tensors(out):
            if t.device.type == "meta":
                continue    # shapes alone (a cache's layout), no memory
            st = _storage(t)
            if st is None:
                continue
            key = id(st)
            if key in self._seen or key in held:
                continue
            nb = -(-st.nbytes() // BLOCK) * BLOCK
            if nb == 0:
                continue
            self._seen.add(key)
            self.live += nb
            self.peak_bytes = max(self.peak_bytes, self.live)
            weakref.finalize(st, self._freed, nb, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._in_prop:
            return out
        ns, name = func.namespace, func._opname
        if ns in ("_c10d_functional", "c10d", "c10d_functional"):
            kind = (_FUNCOL if ns != "c10d" else _C10D).get(name)
            if name not in _SKIP and kind is not None:
                # per-device operand bytes: the input (a reduce-scatter's
                # whole input, an all-gather's own shard)
                src = _tensors(args[0] if ns != "c10d" or name in (
                    "allreduce_", "send") else args[1])
                self.ops.append({"kind": kind,
                                 "bytes": int(sum(map(_nbytes, src))),
                                 "group_size": _group_size(args),
                                 "shape": list(src[0].shape) if src
                                 else []})
            self._track(out)
            return out
        ins = _tensors(list(args) + list(kwargs.values()))
        if not func.is_view and ns != "prim":
            self._names[name] += 1
            formula = self._formulas.get(func.overloadpacket)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            self.bytes_accessed += sum(map(_nbytes, ins)) + sum(
                map(_nbytes, _tensors(out)))
            self._track(out, ins)
        return out
