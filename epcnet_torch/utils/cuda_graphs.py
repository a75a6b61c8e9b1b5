"""An eval forward replayed as a CUDA graph (the embed layer's,
``train/step.py::model_embed_fn``).

``GraphedForward(fn)`` calls ``fn(x)`` eagerly at the first call of each
input (shape, dtype, device, inference mode), captures a second call as a
CUDA graph, and from then on copies x into the graph's input, replays it
and returns a copy of its output: the host launches one graph where the
eager forward launches each kernel and op. ``fn`` must fix every shape by
its input's and never wait for the card (a model's ``forward_checked``,
where the model sets ``graphable``).

Callers on several threads (a serving index's HTTP handlers and its query
worker) share it: one lock covers the capture and each copy, replay and
copy back, and each call's stream waits for the last replay of its graph
to finish before it writes the graph's input, so no call reads another's
descriptors whatever streams they run on. At most ``MAX_GRAPHS`` graphs
are kept (their memory pools with them); the least recently used goes.

A replay runs no Python: the launch counters of the kernels' wrappers
(``sparse_conv_cuda.launches``, ...) count the eager call and the capture,
which records each launch once, and nothing at a replay; a profiler
records the replay's kernels, with no span of the program around them.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable

import torch

MAX_GRAPHS = 4


class GraphedForward:
    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        self.fn = fn
        # key -> (graph, its input, its output, the event its last replay recorded)
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        key = (tuple(x.shape), x.dtype, x.device, torch.is_inference_mode_enabled())
        with self._lock:
            entry = self.graphs.get(key)
            if entry is None:
                return self._capture(key, x)
            self.graphs.move_to_end(key)
            graph, static_in, static_out, done = entry
            stream = torch.cuda.current_stream(x.device)
            stream.wait_event(done)  # the last replay has read its input
            static_in.copy_(x)
            graph.replay()
            out = static_out.clone()
            done.record(stream)
            return out

    def _capture(self, key, x: torch.Tensor) -> torch.Tensor:
        out = self.fn(x)  # also the warm-up a capture needs
        static_in = x.clone()
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads' work on the card (a serving index's
        # background sync) may go on during the capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static_out = self.fn(static_in)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(x.device))
        if len(self.graphs) >= MAX_GRAPHS:
            self.graphs.popitem(last=False)
        self.graphs[key] = (graph, static_in, static_out, done)
        return out
