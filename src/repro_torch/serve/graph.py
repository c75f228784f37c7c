"""A step captured into one CUDA graph and replayed: the port's
counterpart of the reference's jitted serving step.

:class:`CapturedStep` runs ``fn(*inputs)`` over static input tensors.
On a CUDA device its first call runs ``fn`` once on a side stream (the
warm-up, whose result is that call's result: it builds and loads the
kernels, fills the launch plans' caches and creates the cuBLAS
workspace, host work that a capture must not do) and then captures
``fn`` into a ``torch.cuda.CUDAGraph`` on the same stream; every later
call replays the graph and returns its static output, which the next
call overwrites. Before each call the caller writes the step's inputs
into :attr:`CapturedStep.inputs` in place. State that ``fn`` updates in
place (the KV caches) must keep its storage for the step's life: the
graph holds its addresses. The CUDA generators that ``fn`` draws from
are registered with the graph, so each replay draws what the same call
would draw eagerly and advances the generator as it would; the warm-up
is the first call's own draw, so nothing is drawn twice. A step that
cannot be captured raises; it never runs eagerly instead. On the CPU,
which has no graphs, every call runs ``fn`` eagerly on the same static
tensors.

Steps of one owner may share a memory pool (``pool``, from
``torch.cuda.graph_pool_handle()``): a later capture then reuses the
blocks that an earlier one freed (its temporaries) instead of holding a
pool of its own. That is safe because the graphs replay one at a time on
the owner's stream, each keeps its static output alive, and the owner
reads a step's output before it replays another step of the pool (whose
temporaries may lie where that output lies).

The kernel wrappers' ``launches`` counters tick when a wrapper launches
its kernel; during a capture they tick though nothing runs. A capture
takes back what moved during it, and each replay adds it again, so the
counts stay launches on the device.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional, Sequence

import torch


def launch_counted():
    """The five kernel wrappers whose ``launches`` count their kernels."""
    from repro_torch.kernels import packed_mac as pm
    from repro_torch.kernels import ternary_mac as tm

    return (tm.ternary_cim_matmul, tm.ternary_exact_matmul,
            pm.packed_cim_matmul_decode, pm.packed_cim_matmul,
            pm.packed_cim_matmul_decode_stream)


def _add_launches(moved: Dict[Callable, int], sign: int = 1) -> None:
    for fn, n in moved.items():
        fn.launches += sign * n


class CapturedStep:
    """``fn`` over the static tensors ``inputs``: a captured CUDA graph on
    a CUDA ``device``, eager on the CPU (see the module docstring);
    ``generators`` are the CUDA generators ``fn`` draws from; ``pool``
    a graph pool shared with the owner's other steps (None: a private
    one). ``capture_seconds`` is the wall time of the warm-up and the
    capture (None until then); ``pool_bytes`` the device memory that the
    capture added to the reserved pools (None until then);
    ``captured_launches`` maps each kernel wrapper to the launches one
    replay makes; ``replays`` counts the calls that replayed the graph."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 device: torch.device, generators: Sequence[torch.Generator] = (),
                 pool: Optional[tuple] = None):
        self.fn = fn
        self.inputs = tuple(inputs)
        self.generators = tuple(generators)
        self.device = torch.device(device)
        self.pool = pool
        self.graphed = self.device.type == "cuda"
        self.graph = None
        self.output = None
        self.capture_seconds: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self.captured_launches: Dict[Callable, int] = {}
        self.replays = 0

    def __call__(self):
        if not self.graphed:
            return self.fn(*self.inputs)
        if self.graph is None:
            return self._capture()
        self.graph.replay()
        self.replays += 1
        _add_launches(self.captured_launches)
        return self.output

    def _capture(self):
        t0 = time.perf_counter()
        first = self._warm_up()
        before = {fn: fn.launches for fn in launch_counted()}
        try:
            graph = self._record()
        finally:
            moved = {fn: fn.launches - n for fn, n in before.items()
                     if fn.launches != n}
            _add_launches(moved, -1)
        self.graph, self.captured_launches = graph, moved
        self.capture_seconds = time.perf_counter() - t0
        return first

    def _warm_up(self):
        """Run ``fn`` once, for real, on the capture's side stream."""
        self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            out = self.fn(*self.inputs)
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        return out

    def _record(self):
        """Capture ``fn`` into a new graph; sets :attr:`output`."""
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        # a graph that the garbage collector frees during the capture
        # (an unreachable owner's) would destroy itself in the middle of
        # it, which ends the capture: collect first, and not during it
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self._stream):
                # read after the context has emptied the allocator's cache
                reserved = torch.cuda.memory_reserved(self.device)
                self.output = self.fn(*self.inputs)
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        finally:
            if enabled:
                gc.enable()
        return graph
