"""BODY_25's stage loop as one CUDA graph a shape, captured once and replayed.

``StageGraphs`` runs a function of one tensor (``OpenPoseBody25.stages``:
the feature F to the last PAF and heat maps, 96 convs, 96 epilogues, the
concatenations and the two f32 heads) as a CUDA graph kept per input
shape, strides, dtype and device:

  * the first call of a key runs the function op by op. That is the
    warm-up a capture needs: it builds the kernels, picks cuDNN's plans and
    sets the launchers' attributes;
  * the second call captures the function on a side stream of the key's
    device into its static input (a copy of the call's input), under a
    lock and with ``capture_error_mode="thread_local"`` so that other
    threads' CUDA calls go on, and replays it;
  * later calls copy their input into the static input, replay, and copy
    the outputs out, so no caller holds a buffer that the next replay
    overwrites.

The graphs of one device share one memory pool: replays are serial on the
current stream and each replay's outputs are copied out before the next
one, so a graph may reuse the memory of another's intermediates.

A call replays only where grad is off, no ``torch.export`` or
``torch.compile`` traces it, the tensors the function reads are the
module's own parameters and the input is a CUDA tensor. Anything else runs
op by op: ``functional_call`` with other tensors
(``PoseEstimator.program(params=)``, ``deploy.export_program``) never
replays their addresses. A key's graph holds the ``data_ptr`` of every
parameter it read: an in-place update (``load_state_dict``) keeps them and
the replay reads the new values; a parameter moved to new storage makes
the next call capture anew.

Counters (``utils/profiling``): ``net.stages.graph`` counts the calls that
replayed, ``net.stages.eager`` those that ran op by op. A capture's
counts (``net.dense_epilogue``, the kernels' launch counts) stand for the
replay that follows it in the same call, and each later replay adds them
again, so the counters count every kernel the device runs.
"""

from __future__ import annotations

import operator
import threading
from typing import Callable, Sequence

import torch

from tpupose_torch.utils import profiling

_SEEN = object()        # a key whose first call ran op by op


class _Graph:
    __slots__ = ("graph", "ptrs", "static_in", "outs", "counts")


class StageGraphs:
    """The graphs of one module's stage loop; ``own`` are the module's
    parameters that the loop reads, in the order the caller lists them."""

    def __init__(self, own: Sequence[torch.Tensor]):
        self.own = list(own)
        self._keys: dict = {}
        self._devices: dict = {}        # device -> (pool, capture stream)
        self._lock = threading.Lock()

    def __reduce__(self):
        # a copy of the module (deepcopy, pickle) starts with no graphs, over
        # the copy's own parameters
        return type(self), (self.own,)

    def refusal(self, x: torch.Tensor, tensors: Sequence[torch.Tensor]) -> str | None:
        """None where a call on ``x`` reading ``tensors`` may replay; else
        the first rule it breaks: "grad", "export", "params", "device"."""
        if torch.is_grad_enabled():
            return "grad"
        if torch.compiler.is_exporting() or torch.compiler.is_compiling():
            return "export"
        if len(tensors) != len(self.own) or not all(map(operator.is_, tensors, self.own)):
            return "params"
        if not x.is_cuda:
            return "device"
        return None

    def __call__(self, fn: Callable[[torch.Tensor], tuple[torch.Tensor, ...]], x: torch.Tensor,
                 tensors: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
        """``fn(x)``, op by op or replayed (see the module's docstring)."""
        if self.refusal(x, tensors) is not None:
            profiling.count("net.stages.eager")
            return fn(x)
        key = (tuple(x.shape), x.stride(), x.dtype, x.device)
        ptrs = tuple([t.data_ptr() for t in tensors])
        with self._lock, torch.cuda.device(x.device):
            g = self._keys.get(key)
            if g is None:
                self._keys[key] = _SEEN
                profiling.count("net.stages.eager")
                return fn(x)
            if g is _SEEN or g.ptrs != ptrs:
                g = self._keys[key] = self._capture(fn, x, ptrs)
            else:
                with torch.inference_mode():
                    g.static_in.copy_(x)
                g.graph.replay()
                profiling.add_counts(g.counts)
            outs = tuple(t.clone() for t in g.outs)
        profiling.count("net.stages.graph")
        return outs

    def _capture(self, fn, x: torch.Tensor, ptrs: tuple) -> _Graph:
        """Captures ``fn`` on a copy of ``x`` and replays it once."""
        if x.device not in self._devices:
            self._devices[x.device] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(x.device))
        pool, stream = self._devices[x.device]
        g = _Graph()
        g.ptrs, g.static_in, g.graph = ptrs, x.clone(), torch.cuda.CUDAGraph()
        before = profiling.counters()
        with torch.cuda.graph(g.graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
            g.outs = fn(g.static_in)
        after = profiling.counters()
        g.counts = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        g.graph.replay()
        return g
