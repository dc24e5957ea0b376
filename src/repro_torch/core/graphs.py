"""One CUDA-graph replay a clock-gated window: the port's counterpart of the
reference's ``jax.jit`` of a window engine.

An *engine* is ``(state, shell, xs) -> (state, shell, ys)`` (the
``WindowScheduler``'s contract), where every leaf of ``xs`` has the
window's length on axis 0. ``WindowGraphs`` captures the engine once for
each window length and then runs each window as one replay:

  * static inputs — the caller's ``xs`` (host arrays or tensors) and shell
    are copied into buffers the graph owns before each replay (host
    arrays through pinned memory, without a host sync). The engine updates
    its state in place (the KV cache, the train state), so the state's
    tensors are the graph's own static buffers: a state leaf that is not
    one of them (e.g. the previous replay's ``pos`` output) is copied in;
  * one memory pool (``GraphPool``; every capture on a card runs on
    the card's one capture stream) for every capture of a
    ``WindowGraphs``: the full
    window and the tail window share it and reuse each other's freed
    memory, and are replayed in the order they were captured (all full
    windows, then the tail). ``pool=`` hands several ``WindowGraphs`` one
    pool, for graphs that are always replayed in the order they were
    captured, each one's outputs consumed before the next replays (the
    co-emulator's two sides). A capture first empties the allocator's
    cache: the memory the eager windows freed goes back to the card,
    where the pool can take it;
  * outputs live in the pool and each replay writes them anew: the
    scheduler queues its pinned copies of the shell snapshot and ``ys``
    on the replay's stream, before the next replay;
  * launch counts — the kernel wrappers count launches in Python, which a
    replay does not run. The counts a capture adds are taken back and
    added again on every replay, so each replay counts the launches it
    executes. The take-back diffs the capturing thread's own tally
    (``kernels.count_launch``): the launches other threads make
    meanwhile (the async farm's slot threads) stay counted;
  * threads — a capture may run on any thread (an async farm's slot
    thread captures its board's window at first use). Captures take one
    process-wide lock, so they run one at a time, and each runs under
    ``capture_error_mode="thread_local"``: another thread's eager work
    (its launches, the allocator's ``cudaMalloc``) neither breaks the
    capture nor joins it, and no capture is in progress while a
    capturing thread synchronises the card or empties the cache;
  * warm-up — a capture must follow an eager run of the engine (lazy
    library loads, cuBLAS workspaces). ``warmup="clone"`` runs it for one
    step on clones of the state and shell and discards it (its launches
    are taken back too: they touch no data of the run); ``warmup="eager"``
    runs the first window of each length eagerly as a real window and
    captures that length when it comes again, just before its first
    replay (for a state too large to clone, such as a train state; a
    length that never comes again is never captured, and no eager window
    runs beside a pool that is already held). ``windows`` counts the
    windows each way ran.

A failed capture raises; nothing falls back to the eager engine.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict

import torch

from repro_torch.kernels import count_launch, thread_launches
from repro_torch.utils import tree_clone, tree_leaves, tree_map


def counted_kernels() -> dict:
    """The kernel wrappers that count their launches, by kernel."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_gemm import ops as gg_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    return {"k1": fa_ops.flash_attention, "k2": da_ops.decode_attention,
            "k3": ssm_ops.ssm_scan, "k4": lru_ops.rglru_scan,
            "k5": gg_ops.grouped_gemm}


def launch_counts() -> Dict[str, int]:
    """Every kernel's launches in this process, from all threads."""
    return {k: fn.launches for k, fn in counted_kernels().items()}


def thread_counts() -> Dict[str, int]:
    """Every kernel's launches counted on the calling thread."""
    return {k: thread_launches(fn) for k, fn in counted_kernels().items()}


def _add_counts(delta: Dict[str, int], sign: int = 1) -> None:
    for k, fn in counted_kernels().items():
        if delta.get(k):
            count_launch(fn, sign * delta[k])


def _diff(after, before):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


# device index -> the one side stream every capture on that card runs on
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}
# held by every capture (and its warm-up, sync and cache release): one
# capture at a time in the process, whichever thread makes it
_CAPTURE_LOCK = threading.RLock()


def capture_stream() -> "torch.cuda.Stream":
    """The side stream of every capture on the current card, made at its
    first use and kept for the process.

    cuBLAS keeps one workspace per (handle, stream), allocated at the
    stream's first product; inside a capture that allocation lands in
    the graph's private pool and stays there for the life of the process.
    A new stream per capture left one workspace per capture in such pools
    (5.34-5.47 GiB after chip_smoke.py's earlier phases); on one stream
    per card there is one workspace, however many pools a process makes.
    Pools sharing the stream is safe: each graph allocates only in its
    own private pool, so two pools never hand each other blocks."""
    index = torch.cuda.current_device()
    with _CAPTURE_LOCK:
        if index not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=index)
        return _CAPTURE_STREAMS[index]


class GraphPool:
    """A CUDA-graph memory pool; every capture into it runs on the card's
    capture stream (``capture_stream``): the caching allocator hands a
    freed block only to a later allocation on the block's own stream, so
    captures that are to reuse each other's freed memory share the stream
    as well as the pool. Created on the card at the first capture."""

    def __init__(self):
        self._handle = None

    def handle_and_stream(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle, capture_stream()


def capture_graph(fn, pool=None, stream=None):
    """fn() recorded once in a CUDA graph on a side stream (``stream``, or
    the card's capture stream), under the process's capture lock and in
    the thread-local capture mode; returns the graph and fn's result,
    whose storage each replay writes anew. The launches fn counts while
    it is recorded (on this thread) are taken back: a capture executes
    nothing."""
    with _CAPTURE_LOCK:
        stream = stream if stream is not None else capture_stream()
        stream.wait_stream(torch.cuda.current_stream())
        # the calling thread's cuBLAS handle, made now if this thread has
        # none yet: creating one inside the capture invalidates it (a
        # slot thread's first product may be the one it captures)
        torch.cuda.current_blas_handle()
        graph = torch.cuda.CUDAGraph()
        before = thread_counts()
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = fn()
        delta = _diff(thread_counts(), before)
        _add_counts(delta, -1)
    graph.launches = delta
    return graph, out


def _window_len(xs) -> int:
    lens = {int(x.shape[0]) for x in tree_leaves(xs)}
    if len(lens) != 1:
        raise ValueError(f"xs leaves disagree on the window length: {lens}")
    return lens.pop()


def _static_like(x, device):
    t = torch.as_tensor(x)
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def _fill(dst, src):
    """Copy ``src`` (a host array or tensor) into the device buffer
    ``dst`` without a host sync; a no-op where ``src`` is ``dst``."""
    if torch.is_tensor(src) and src.data_ptr() == dst.data_ptr() \
            and src.shape == dst.shape:
        return
    src = torch.as_tensor(src)
    if src.device.type == "cpu":
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


class _Captured:
    def __init__(self, graph, state_in, shell_in, xs_in, out):
        self.graph = graph
        self.state_in, self.shell_in, self.xs_in = state_in, shell_in, xs_in
        self.out = out

    def replay(self, state, shell, xs):
        tree_map(_fill, self.state_in, state)
        tree_map(_fill, self.shell_in, shell)
        tree_map(_fill, self.xs_in, xs)
        self.graph.replay()
        _add_counts(self.graph.launches)
        return self.out


class WindowGraphs:
    """``engine`` run as one CUDA-graph replay a window (module docstring).
    Call it as the engine itself: ``graphs(state, shell, xs)``."""

    def __init__(self, engine: Callable, *, warmup: str = "clone",
                 pool: "GraphPool | None" = None):
        if warmup not in ("clone", "eager"):
            raise ValueError(f"unknown warm-up {warmup!r}")
        self.engine = engine
        self.warmup = warmup
        self.graphs: Dict[int, _Captured] = {}
        self.windows = {"graph": 0, "eager": 0}
        self.warmup_launches: Dict[str, int] = {}
        self.capture_s = 0.0
        self._pool = pool if pool is not None else GraphPool()
        self._warm: set = set()     # lengths run eagerly ("eager" warm-up)

    def _device(self, state):
        for t in tree_leaves(state):
            if torch.is_tensor(t):
                if t.device.type != "cuda":
                    raise ValueError("WindowGraphs runs on CUDA tensors, "
                                     f"not {t.device}")
                return t.device
        raise ValueError("the state holds no tensor")

    def _capture(self, state, shell, xs):
        with _CAPTURE_LOCK:
            t0 = time.perf_counter()
            device = self._device(state)
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            shell_in = tree_clone(shell)
            xs_in = tree_map(lambda x: _static_like(x, device), xs)
            tree_map(_fill, xs_in, xs)
            if self.warmup == "clone":
                before = thread_counts()
                # one step of the window: every step runs the same
                # operations
                self.engine(tree_clone(state), tree_clone(shell_in),
                            tree_map(lambda x: x[:1], xs_in))
                delta = _diff(thread_counts(), before)
                _add_counts(delta, -1)
                for k, n in delta.items():
                    self.warmup_launches[k] = \
                        self.warmup_launches.get(k, 0) + n
            handle, stream = self._pool.handle_and_stream()
            graph, out = capture_graph(
                lambda: self.engine(state, shell_in, xs_in), pool=handle,
                stream=stream)
            self.graphs[_window_len(xs)] = _Captured(graph, state, shell_in,
                                                     xs_in, out)
            self.capture_s += time.perf_counter() - t0

    def prepare(self, state, shell, xs) -> None:
        """Capture the window length of ``xs`` now (warm-up "clone" only),
        so no capture, and none of its host syncs, falls inside a run."""
        if self.warmup != "clone":
            raise ValueError("prepare() needs warm-up on clones")
        if _window_len(xs) not in self.graphs:
            self._capture(state, shell, xs)

    def __call__(self, state, shell, xs):
        g = _window_len(xs)
        if g not in self.graphs:
            if self.warmup == "eager" and g not in self._warm:
                self._warm.add(g)
                self.windows["eager"] += 1
                return self.engine(state, shell, xs)
            self._capture(state, shell, xs)
        self.windows["graph"] += 1
        return self.graphs[g].replay(state, shell, xs)
