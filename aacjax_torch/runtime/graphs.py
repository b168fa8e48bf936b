"""Captured device programs: the port's counterpart of the reference's `jax.jit`.

The reference runs each of its device programs (the decode steps, the SBR
and SBR + PS programs, the encoder's analysis and quantize) as one compiled
executable, keyed by its static arguments and its input shapes.  Eager
PyTorch instead enqueues every operation from Python on every call: the
SBR program alone is some 690 kernel launches a chunk.  A `Program` is
that function captured once per key as a CUDA graph and replayed on every
later call, so a call costs one graph launch on the host.

The key is what the reference's jit is keyed by: the program's name and
static arguments (flags, `out_int16`, the PS band mode, the encoder's
configuration), the structure of the arguments with every tensor's shape,
strides and dtype and every non-tensor value, and the indexed device
(`_build.indexed`).  `MAX_ENTRIES` programs stay captured, the least
recently used going first.

On CPU tensors a Program calls its eager function: there are no CPU
graphs, and the CPU was asked for.  On CUDA tensors it never runs
eagerly after its first call:

  * the first call of a key runs the function once on the device's side
    stream, on the caller's tensors: the warm-up, which does every lazy
    one-time setup (the kernel library, the constant tables, the PS
    decorrelator's shared-memory opt-in, cuBLAS's workspace for that
    stream) outside the capture.  Its results, copied as a replay's are,
    are the call's results, and its launches count as launches;
  * it then captures the function on the same stream from static copies of
    the inputs, with capture_error_mode="thread_local" (the pipelined
    runtime's other threads keep copying and waiting on events meanwhile).
    A capture that fails raises; nothing falls back to eager;
  * every later call copies its tensors into the static inputs, replays the
    graph on the caller's current stream and copies the outputs out of the
    graph's memory into new tensors of the caching allocator.  The next
    replay overwrites the graph's outputs, while a pipelined caller still
    reads chunk n's PCM on its copy-down stream as chunk n + 1 computes;
    the caller's own tensors follow the allocator's stream rules as an
    eager result's do (the runtime marks them with `record_stream`).

The reference donates the carried state (the overlap, the predictor, SBR
and PS state) so that XLA can update it in place.  Here the state is an
input and an output like any other: copied in, and handed out as a new
tensor.  Returning the graph's own buffer instead would let two callers of
one program (two decoders of one shape, the virtual shards of a card)
hold the same state tensor.  PERF.md measures what the copies cost.

All graphs of a device share one memory pool.  Their replays cannot
overlap: a replay first waits for the device's previous replay (an event,
whatever stream it ran on) and copies its outputs out before the next may
start, so a graph's scratch may be another graph's.

The kernel wrappers count their launches (`tail.launches`, ...).  While a
thread captures, `_build.launch` records the entry point's name instead of
counting; each replay adds the launches its graph holds.
"""
from __future__ import annotations

import collections
import threading
import time

import torch

from aacjax_torch.kernels import _build

MAX_ENTRIES = 64    # captured programs kept, all devices together

_lock = threading.RLock()
_entries: collections.OrderedDict = collections.OrderedDict()
_pools: dict = {}         # device -> the memory pool id of its graphs
_side: dict = {}          # device -> the stream of warm-ups and captures
_last: dict = {}          # device -> event after its latest replay


def _flatten(tree, leaves: list):
    """The structure of `tree` (nested tuples, lists and str-keyed dicts of
    tensors and constants) with every tensor's shape, strides and dtype;
    the tensors are appended to `leaves` in order."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("T", tuple(tree.shape), tree.stride(), tree.dtype)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("D", tuple(keys), tuple(_flatten(tree[k], leaves)
                                        for k in keys))
    if isinstance(tree, (tuple, list)):
        return ("L" if isinstance(tree, list) else "U",
                tuple(_flatten(v, leaves) for v in tree))
    hash(tree)      # a constant of the key; an unhashable one raises
    return ("C", tree)


def _unflatten(spec, leaves):
    """Inverse of _flatten over an iterator of tensors."""
    kind = spec[0]
    if kind == "T":
        return next(leaves)
    if kind == "D":
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    if kind in ("L", "U"):
        out = [_unflatten(s, leaves) for s in spec[1]]
        return out if kind == "L" else tuple(out)
    return spec[1]


def _count(held: collections.Counter) -> None:
    """Add a replay's kernel launches to the wrappers' counters."""
    from aacjax_torch.kernels import (enc_scans, pred, ps_decorr, synth,
                                      tail, tns)
    counters = dict(aacjax_tail=tail, aacjax_synth=synth, aacjax_tns=tns,
                    aacjax_pred=pred, aacjax_ps_decorrelate=ps_decorr,
                    aacjax_enc_spread=enc_scans.spread_count,
                    aacjax_enc_rate_cost=enc_scans.rate_cost_count)
    for name, n in held.items():
        counters[name].launches += n


def _cuda(device) -> torch.device:
    """`device` indexed; a CUDA device without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return _build.indexed(device)


class Entry:
    """One captured program: the graph, its static inputs and outputs, the
    kernel launches it holds, and what its capture cost."""

    def __init__(self, graph, inputs, outputs, out_spec, held, capture_s,
                 pool_bytes):
        self.graph = graph
        self.inputs = inputs          # static input tensors, in leaf order
        self.outputs = outputs        # the graph's output tensors
        self.out_spec = out_spec
        self.held = held              # Counter: entry point -> launches
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes  # what the device reserved in capture
        self.replays = 0


class Program:
    """`fn` compiled as the reference's jit compiles it: captured once per
    key, replayed after (see the module docstring).  `static` holds the
    static arguments that `fn` closes over, for the key."""

    def __init__(self, name: str, fn, static: tuple = ()):
        self.name = name
        self.fn = fn
        self.static = static

    def key(self, args: tuple):
        """(key, tensors) of a call: see the module docstring."""
        leaves: list = []
        spec = _flatten(args, leaves)
        devs = {_build.indexed(t.device) for t in leaves}
        if len(devs) != 1:
            raise ValueError(f"{self.name}: tensors on "
                             f"{sorted(map(str, devs))}; a program runs on "
                             "one device")
        return (self.name, self.static, spec, devs.pop()), leaves

    def __call__(self, *args):
        key, leaves = self.key(args)
        dev = key[3]
        if dev.type == "cpu":
            return self.fn(*args)
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: tensors on {dev}; expected cpu "
                             "or cuda")
        with _lock:
            entry = _entries.get(key)
            if entry is None:
                return self._first(key, dev, args, leaves)
            _entries.move_to_end(key)
            return self._replay(entry, dev, leaves)

    def _first(self, key, dev, args, leaves):
        """Warm up on the side stream (this call's result), then capture."""
        cur = torch.cuda.current_stream(dev)
        side = _side.get(dev)
        if side is None:
            side = _side[dev] = torch.cuda.Stream(dev)
            _pools[dev] = torch.cuda.graph_pool_handle()
        side.wait_stream(cur)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            inputs = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                          device=dev).copy_(t)
                      for t in leaves]
            out = self.fn(*args)
            graph = torch.cuda.CUDAGraph()
            held: list = []
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            graph.capture_begin(pool=_pools[dev],
                                capture_error_mode="thread_local")
            try:
                with _build.capturing(held):
                    got = self.fn(*_unflatten(key[2], iter(inputs)))
            except BaseException as e:
                try:
                    graph.capture_end()
                except RuntimeError:
                    # an invalidated capture ends before the allocator
                    # stops sending this stream's allocations to the pool
                    torch._C._cuda_endAllocateToPool(dev.index, _pools[dev])
                torch._C._cuda_releasePool(dev.index, _pools[dev])
                _pools[dev] = torch.cuda.graph_pool_handle()
                raise RuntimeError(f"{self.name}: CUDA graph capture "
                                   f"failed: {e}") from e
            graph.capture_end()
            capture_s = time.perf_counter() - t0
        cur.wait_stream(side)
        outputs: list = []
        out_spec = _flatten(got, outputs)
        eager: list = []
        _flatten(out, eager)
        for t in eager:
            t.record_stream(cur)
        _evict()
        _entries[key] = Entry(graph, inputs, outputs, out_spec,
                              collections.Counter(held), capture_s,
                              torch.cuda.memory_reserved(dev) - reserved)
        # the warm-up's results leave as a replay's do, as copies: a state
        # that comes back as the next call's input keys that call alike
        return _unflatten(out_spec, iter([t.clone() for t in eager]))

    def _replay(self, entry: Entry, dev, leaves):
        cur = torch.cuda.current_stream(dev)
        last = _last.get(dev)
        if last is not None:
            cur.wait_event(last)
        with torch.cuda.device(dev):
            for s, t in zip(entry.inputs, leaves):
                s.copy_(t)
            entry.graph.replay()
            outs = [t.clone() for t in entry.outputs]
            ev = torch.cuda.Event()
            ev.record(cur)
        _last[dev] = ev
        entry.replays += 1
        _count(entry.held)
        return _unflatten(entry.out_spec, iter(outs))


def _evict() -> None:
    """Drop the least recently used programs beyond MAX_ENTRIES - 1, after
    their device's last replay ended."""
    while len(_entries) >= MAX_ENTRIES:
        (_, _, _, dev), _ = _entries.popitem(last=False)
        if _last.get(dev) is not None:
            _last[dev].synchronize()


def entries() -> list[dict]:
    """One record per captured program: its name, static arguments,
    device, capture seconds, pool bytes reserved during the capture, the
    kernel launches it holds and its replays so far."""
    with _lock:
        return [dict(name=k[0], static=k[1], device=str(k[3]),
                     capture_s=e.capture_s, pool_bytes=e.pool_bytes,
                     held=dict(e.held), replays=e.replays)
                for k, e in _entries.items()]


def clear(device=None) -> None:
    """Drop every captured program (of `device` only, when given) and its
    device's pool, after the device's last replay: the next call of each
    key warms up and captures anew.  A CUDA device without CUDA raises."""
    dev = None if device is None else _cuda(device)
    with _lock:
        for key in [k for k in _entries if dev is None or k[3] == dev]:
            del _entries[key]
        for d in [d for d in _pools if dev is None or d == dev]:
            if _last.get(d) is not None:
                _last.pop(d).synchronize()
            _side[d].synchronize()
            _pools[d] = torch.cuda.graph_pool_handle()
