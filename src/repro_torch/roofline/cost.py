"""The cost of one window dispatch, counted on fake tensors: the port's
counterpart of XLA's ``cost_analysis``, which the reference reads off a
compiled window engine (``capture.py::compiled_cost``, ``engine_cost``,
``CostCapturingEngine``).

:func:`count_cost` calls the engine ONCE on fakes of its arguments
(``analysis/boardcheck.py::trace_engine``, the board certifier's trace:
nothing is launched, built or allocated on a card, and the real state is
never written), with a dispatch mode on top that adds up, per operator:

  * FLOPs of the matmul family (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    convolutions, SDPA), by ``torch.utils.flop_counter``'s formulas (2
    FLOPs a multiply-add). Other operators count no FLOPs. An operator
    the counter has no formula for and that decomposes (a composite) is
    counted through its decomposition;
  * bytes: each tensor argument read once and each output written once
    (numel x element size), as a roofline counts an operator's traffic.
    View and alias operators (``view``, ``transpose``, ``expand``,
    ``detach`` ...) and allocations (``empty*``) count none; the
    destination of ``copy_``, ``fill_`` and ``zero_`` counts as written
    only;
  * the hand-written kernels: a launch is a ctypes call the trace never
    sees, so each wrapper's traced branch records its module's ``cost``
    (``kernels.note_traced``), which is added here; K3's exponentials
    come back as ``exps``.

How this differs from XLA's count: XLA counts a compiled, fused program,
so an elementwise chain inside one fusion reads its inputs and writes its
output once, and elementwise ops count FLOPs too. Here every eager
operator is its own read and write (the traffic the eager or CUDA-graph
window really has, no fusion assumed), and elementwise operators count
bytes and no FLOPs. The counts keep XLA's report names (``hlo_flops``,
``hlo_bytes`` in :class:`~repro_torch.roofline.capture.WindowCapture`)
so the records stay comparable.

The count is host work (about a millisecond an operator on fake
tensors): a window of g identical steps costs g times one step, so the
entry points trace a one-step stack and scale it by the window size.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
# metadata queries: no operator runs
_METADATA = {_aten.sym_size, _aten.sym_stride, _aten.sym_numel,
             _aten.sym_storage_offset, _aten.size, _aten.stride,
             _aten.numel, _aten.dim, _aten.storage_offset,
             _aten.is_contiguous, _aten.sym_is_contiguous,
             _aten.is_strides_like_format,
             _aten.is_non_overlapping_and_dense}
# allocations and aliases: no traffic
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten.lift_fresh,
         _aten.detach, _aten.alias, _aten._unsafe_view, _aten.set_,
         _aten.resize_}
# in-place writes that do not read their destination
_WRITE_ONLY = {_aten.copy_, _aten.fill_, _aten.zero_}


def _tensors(tree) -> list:
    return [t for t in pytree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Adds up ``flops`` and ``bytes`` of the operators dispatched under
    it (module docstring). Used on top of the trace's modes."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in _METADATA or func.namespace == "prim":
            return func(*args, **kwargs)
        if packet not in flop_registry and not func.is_view \
                and packet not in _FREE:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if func.is_view or packet in _FREE:
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        ins = args
        if packet in _WRITE_ONLY:
            ins = args[1:]
        seen = set()
        for t in _tensors((ins, kwargs)):
            if id(t) not in seen:
                seen.add(id(t))
                self.bytes += _nbytes(t)
        self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out


def count_cost(engine: Callable, state, shell, stack) -> Dict[str, float]:
    """The cost of one call ``engine(state, shell, stack)`` (a window's
    dispatch), counted on fake tensors without running it: ``flops``,
    ``bytes`` and ``exps`` (K3's exponentials), each a float. A
    ``WindowGraphs`` is counted through its ``.engine``. Raises
    ``RuntimeError`` where the engine cannot be traced on fakes."""
    from repro_torch.analysis.boardcheck import trace_engine

    counter = CostCounter()
    tr = trace_engine(engine, state, shell, stack, top=counter)
    if tr.failure is not None:
        raise RuntimeError(
            "count_cost: the engine could not be traced on fake tensors: "
            f"{type(tr.failure).__name__}: {tr.failure}") from tr.failure
    k = tr.kernel_cost
    return {"flops": float(counter.flops + k.get("flops", 0)),
            "bytes": float(counter.bytes + k.get("bytes", 0)),
            "exps": float(k.get("exps", 0))}
