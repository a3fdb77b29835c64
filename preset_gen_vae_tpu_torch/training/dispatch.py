"""K-step dispatch: the train epoch's steps in groups of K, each group one
CUDA graph replay on the card, and the validation step as graph replays.

Counterpart: the JAX loop's K-step ``lax.scan`` and whole-validation scan
(``preset_gen_vae_tpu/training/loop.py:225-233`` for K, ``:392-424`` for
the scans, ``:588-622`` for the groups and the remainder, ``:739-758``
for the validation). There, K train steps run as one device dispatch and
the steps left over one dispatch each; here a CUDA graph that holds K
whole steps (the gather from the resident corpus, forward, loss,
backward, Adam, the scalar rows) is captured once per run and replayed
once per group, and a second graph that holds one whole step is replayed
once per step left over (the remainder).

A graphed call runs its first call eagerly, on the stream it will be
captured on: that warm-up is real work (the run's first group of steps,
or its first validation batch) and does cuDNN's algorithm search, builds
the lazy device tables and Adam's state. The next call captures the graph
and replays it; later calls replay it. Everything the captured work reads
or writes lives in tensors that outlast the graph: the model's parameters
and buffers, Adam's state (``capturable``, its learning rate a device
tensor), the static index buffer filled before each replay, the beta
scalar, and the outputs captured with the graph, copied out after each
replay. The step's generator is registered with the graph, so that a
replay draws what K eager steps would and advances the generator as
much. The capture runs under ``torch.cuda.set_sync_debug_mode('error')``:
a step that makes the host wait cannot be captured and raises, naming
the call. A failed capture raises; nothing falls back to eager steps.

The remainder's one-step graph shares the group's call (``shares``): it
is captured on the group's stream at its first call, after the group's
warm-up, which did the same step's set-up at the same shapes, so it runs
no warm-up of its own. Where the group's graph was captured first (two
groups or more an epoch), it is captured into that graph's memory pool:
the two replay in the order they were captured, every epoch, and each
replay's outputs are copied out before the next, so that the remainder
reserves no second step's activations. With one group an epoch the
remainder comes first, in the run's first epoch, and has a pool of its
own.

On the CPU a graphed call runs its body eagerly every time, with the same
static buffers and copies: the plain version that the tests hold against
one step at a time.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, List, Optional, Tuple

import torch


def dispatch_k(steps_per_dispatch: int, n_batches: int) -> int:
    """K for an epoch of ``n_batches`` train batches (loop.py:225-233
    there): -1 is the whole epoch, and K is capped at the batch count."""
    k = n_batches if steps_per_dispatch == -1 else int(steps_per_dispatch)
    return max(1, min(k, max(1, n_batches)))


def dispatch_sizes(n_batches: int, k: int) -> List[int]:
    """The epoch's dispatches in order, by their number of steps: groups of
    K, then the remainder one step each (loop.py:597-622 there); all
    single steps for K = 1."""
    groups = n_batches // k if k > 1 else 0
    return [k] * groups + [1] * (n_batches - groups * k)


class GraphedCall:
    """``body()`` -> outputs, replayed from a CUDA graph on the card.

    ``warm_up()`` wraps the eager work that stands for the first call; the
    first ``__call__`` after it captures ``body`` (on the same stream) and
    replays it, later calls replay it, each returning the captured
    outputs, which the next replay overwrites. A call that ``shares``
    another is captured on that call's stream after that call's warm-up,
    and into that call's memory pool where that call's graph exists by
    then. On the CPU ``__call__`` runs ``body()``."""

    def __init__(self, body: Callable, device: torch.device, what: str,
                 generator: Optional[torch.Generator] = None,
                 shares: Optional["GraphedCall"] = None):
        self.body, self.device, self.what, self.generator = body, device, what, generator
        self.shares = shares
        self.warm, self.graph, self.outputs = False, None, None
        self.captures, self.replays, self.capture_s = 0, 0, 0.0
        if shares is not None:
            self.stream = shares.stream
        else:
            self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    @contextlib.contextmanager
    def warm_up(self):
        if self.stream is None:
            yield
        else:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                yield
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self.warm = True

    @property
    def captured(self) -> bool:
        """Whether the next call replays a graph captured before it (on the
        CPU, where nothing is captured, always)."""
        return self.stream is None or self.graph is not None

    def _capture(self) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        shared = self.shares.graph if self.shares is not None else None
        pool = shared.pool() if shared is not None else None
        mode = torch.cuda.get_sync_debug_mode()
        # an earlier run's graph that the garbage collector destroys during
        # the capture would invalidate it: collect first, then not during
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=self.stream):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    self.outputs = self.body()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of {self.what} failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
        self.graph = graph
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def __call__(self):
        if self.stream is None:
            return self.body()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        return self.outputs


class TrainGroups:
    """K train steps as one graphed call. ``step(sel)`` takes one train
    step on the index row ``sel`` (a device tensor) and returns its
    metrics with the latents; ``run(idx)`` takes the K steps of the (K, B)
    index rows ``idx`` -> ((K, n_keys) scalar rows, (2, K, B, dim_z)
    latents ``z0_mu`` and ``z0``), static buffers on the card. The
    remainder's steps are a ``TrainGroups`` of K = 1 that ``shares`` the
    groups' call."""

    def __init__(self, k: int, batch_size: int, step: Callable, keys: Tuple[str, ...],
                 device: torch.device, what: str, generator: Optional[torch.Generator],
                 shares: Optional[GraphedCall] = None):
        self.k, self.step, self.keys = k, step, keys
        self.idx = torch.zeros((k, batch_size), dtype=torch.int64, device=device)
        self.call = GraphedCall(self._body, device, what, generator, shares)

    def _body(self):
        rows, latents = [], []
        for j in range(self.k):
            m = self.step(self.idx[j])
            rows.append(torch.stack([m[key] for key in self.keys]))
            latents.append(torch.stack([m["z0_mu"], m["z0"]]))
        return torch.stack(rows), torch.stack(latents, dim=1)

    def run(self, idx: torch.Tensor):
        self.idx.copy_(idx)
        return self.call()


class EvalReplays:
    """The validation step as a graphed call: ``run(sel)`` evaluates the
    padded batch of index row ``sel`` (a device tensor) -> ((n_keys,)
    scalars, (2, B, dim_z) float32 latents), static buffers on the card."""

    def __init__(self, batch_size: int, step: Callable, device: torch.device, what: str):
        self.step = step
        self.idx = torch.zeros((batch_size,), dtype=torch.int64, device=device)
        self.call = GraphedCall(lambda: self.step(self.idx), device, what)

    def run(self, sel: torch.Tensor):
        self.idx.copy_(sel)
        return self.call()
