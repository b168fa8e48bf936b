"""Multi-device sharding of the decode and encode programs: counterpart of
`aacjax/runtime/mesh.py`.

Parallel axes, as in the reference:
  * 'stream': data parallelism over channel slots (concurrent streams).
    Every per-channel operation is slot-local, and the stereo pairs, the
    coupling slots and the Parametric Stereo output slot of a stream sit
    next to its own slots, so a shard of whole streams needs nothing from
    another shard.
  * 'frame': sequence parallelism over the frame axis.  Every frame's
    IMDCT is independent; the only cross-frame coupling is the overlap-add
    carry, whose halo is one frame per shard boundary (three for ELD).

The reference is single-controller: one jitted program per mesh, which
GSPMD partitions, with zero collectives.  So is this port, without
`torch.distributed`: one process and one Python thread hold every shard.  A
shard is a contiguous block of channel slots (whole streams: blocks split
on stream boundaries, `split_streams`) times a block of frames.  Each
sharded program takes per-shard inputs, runs the port's own single-device
program on each shard's device (its compiled form, a CUDA graph on the
card: runtime/graphs.py; the kernels unchanged, each launched for its
shard) and returns per-shard outputs.  The caller enqueues each
device's work on that device's current CUDA stream; data that crosses
devices moves with `Tensor.to`, which orders itself against the current
streams of both devices (a peer copy between two cards, nothing at all
between two shards of one card).

Where the reference replicates an array and leaves GSPMD to gather across
shards (the stereo pair and coupling slot indices, the coupling entry
lists, `last_valid`, the PS output routing), a shard here selects the
entries whose slots and frames it holds and rebases their indices to the
shard.

The frame axis.  The overlap-add pcm[t] = (first[t] + second[t-1]) *
valid[t] reaches one frame back; the ELD low-delay synthesis, whose carry
is [C, 3F], three.  Frame shard k of frames [t0, t1) also holds the `halo`
frames before t0 (back to the chunk's start at most, where the carry in
takes over); their PCM is dropped and their `valid` and `last_valid` roles
are masked, so the fused tail, the synthesis and the ELD product run
unchanged, with each frame's arithmetic as it is unsharded.  The carry out
of the chunk is the new overlap of the last frame shard that holds a valid
frame of the row, or the carry in for a row with none.  The Main-profile
predictor is a recurrence over frames: its state goes from frame shard to
frame shard in order, and each shard's halo takes the predicted spectra of
the previous shard's last frames.  A chunk's PCM comes back whole in time
on each stream shard's first device, where its state and the stream-only
SBR / PS programs live.

Devices: `make_mesh(n_stream, n_frame, devices)`, by default one CUDA
device a shard.  A device repeats only where the caller passes it so:
`[torch.device("cpu")] * 8` shards eight ways on the CPU, as the
reference's tests shard over eight virtual CPU devices, and
`[torch.device("cuda:0")] * 4` makes four virtual shards of one card.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from aacjax_torch.kernels import _build
from aacjax_torch.kernels import pipeline as P


class Mesh:
    """A [n_stream, n_frame] grid of indexed devices.  `shape` maps the axis
    names to their sizes (`mesh.shape["stream"]`, as in the reference)."""

    def __init__(self, devices):
        grid = tuple(tuple(_build.indexed(d) for d in row) for row in devices)
        if not grid or not grid[0] or len({len(r) for r in grid}) != 1:
            raise ValueError("a mesh needs a rectangular grid of devices")
        for d in (d for row in grid for d in row):
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported mesh device {d}")
        self.devices = grid
        self.shape = {"stream": len(grid), "frame": len(grid[0])}

    @property
    def row_devices(self) -> tuple:
        """The first device of each stream shard: its state and its
        stream-only programs live there."""
        return tuple(row[0] for row in self.devices)

    @property
    def device_set(self) -> tuple:
        """Each device of the mesh once, in grid order."""
        return tuple(dict.fromkeys(d for row in self.devices for d in row))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape['stream']}x{self.shape['frame']}, "
                f"{[[str(d) for d in r] for r in self.devices]})")


def make_mesh(n_stream: int, n_frame: int = 1, devices=None) -> Mesh:
    """A ('stream', 'frame') mesh over the first n_stream * n_frame of
    `devices` (default: every CUDA device, one shard each; raises without
    CUDA).  Raises when fewer devices are given than shards."""
    if n_stream < 1 or n_frame < 1:
        raise ValueError(f"mesh shape {n_stream}x{n_frame}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices= (for example "
                "[torch.device('cpu')] * 8) to shard on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_stream * n_frame
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh([devices[i * n_frame:(i + 1) * n_frame]
                 for i in range(n_stream)])


@dataclass(frozen=True)
class Layout:
    """How a chunk splits: the slot block of each stream shard, the frames
    each frame shard delivers, and how many frames before them it reads."""
    rows: tuple       # ((lo, hi), ...) per stream shard
    frames: tuple     # ((t0, t1), ...) per frame shard
    halo: int = 1

    def lead(self, k: int) -> int:
        """The first frame frame shard k holds: its t0 less the halo, no
        earlier than the chunk's start."""
        return max(0, self.frames[k][0] - self.halo)


def split_streams(n_slots, n_stream: int) -> tuple:
    """Slot blocks of `n_stream` shards over streams laid out contiguously
    with n_slots[i] slots each: the same number of whole streams a shard."""
    n = len(n_slots)
    if n % n_stream:
        raise ValueError(f"{n} streams do not split over {n_stream} "
                         "'stream' shards")
    per = n // n_stream
    edges = np.concatenate([[0], np.cumsum(n_slots, dtype=np.int64)])
    return tuple((int(edges[i * per]), int(edges[(i + 1) * per]))
                 for i in range(n_stream))


def split_frames(T: int, n_frame: int) -> tuple:
    if T % n_frame:
        raise ValueError(f"{T} frames a chunk do not split over {n_frame} "
                         "'frame' shards")
    per = T // n_frame
    return tuple((k * per, (k + 1) * per) for k in range(n_frame))


def layout(mesh: Mesh, n_slots, T: int, halo: int = 1) -> Layout:
    return Layout(split_streams(n_slots, mesh.shape["stream"]),
                  split_frames(T, mesh.shape["frame"]), halo)


# -- row blocks ---------------------------------------------------------------
class RowBlocks:
    """A [C, ...] tensor, or a dict of them, held as row blocks: part i
    holds rows bounds[i] on devices[i]."""
    __slots__ = ("parts", "bounds", "devices")

    def __init__(self, parts: list, bounds: tuple, devices: tuple):
        self.parts, self.bounds, self.devices = list(parts), bounds, devices

    def matches(self, bounds: tuple, devices: tuple) -> bool:
        return self.bounds == bounds and self.devices == devices


def _cat(parts: list, device):
    if isinstance(parts[0], dict):
        return {k: _cat([p[k] for p in parts], device) for k in parts[0]}
    return torch.cat([p.to(device) for p in parts])


def _rows(x, lo: int, hi: int, device):
    if isinstance(x, dict):
        return {k: _rows(v, lo, hi, device) for k, v in x.items()}
    return x[lo:hi].to(device)


def gather(x, device):
    """x whole on `device`: the parts of a RowBlocks concatenated there (a
    single part already there as it is); anything else as it is."""
    if not isinstance(x, RowBlocks):
        return x
    if x.devices == (_build.indexed(device),):
        return x.parts[0]
    return _cat(x.parts, device)


def scatter(x, bounds: tuple, devices: tuple) -> RowBlocks:
    """x as row blocks over bounds / devices: kept when it already is so,
    else gathered on its first part's device and split.  A block on the
    device the whole lies on is a view of it."""
    if isinstance(x, RowBlocks):
        if x.matches(bounds, devices):
            return x
        x = gather(x, x.devices[0])
    return RowBlocks([_rows(x, lo, hi, d) for (lo, hi), d in
                      zip(bounds, devices)], bounds, devices)


def blocks(x, lo: int, hi: int):
    """(part, local lo, local hi) for every part of x that holds rows of
    [lo, hi); a whole x is its own single part."""
    if not isinstance(x, RowBlocks):
        yield x, lo, hi
        return
    for part, (a, b) in zip(x.parts, x.bounds):
        if max(lo, a) < min(hi, b):
            yield part, max(lo, a) - a, min(hi, b) - a


def row_of(x, s: int):
    """Row s of x (tensor or dict of tensors), wherever it lies."""
    for part, a, _ in blocks(x, s, s + 1):
        if isinstance(part, dict):
            return {k: v[a] for k, v in part.items()}
        return part[a]
    raise IndexError(s)


@dataclass
class Shards:
    """A chunk split over a mesh: parts[i][k] is the dict of stream shard i,
    frame shard k, on mesh.devices[i][k]."""
    parts: list
    layout: Layout


# -- the python packer's batch ------------------------------------------------
def packed_tensor(name: str, a, device) -> torch.Tensor:
    """A packed numpy array as the device step takes it: flags as int32,
    the predictor's `used` mask as uint8."""
    if a.dtype == np.bool_:
        a = a.astype(np.int32)
    elif name == "pred_used":
        a = a.astype(np.uint8)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


_PAIR_PLANES = ("ms_mask", "is_scale")


def batch_shardings(mesh: Mesh, batch: dict, lay: Layout) -> list:
    """The python packer's batch (runtime/pack.py, numpy) split per shard
    [i][k]: the [C, T, ...] planes sliced to the shard's slots and frames
    (halo included); the stereo pairs and coupling entries whose slots the
    shard holds, rebased (a shard with no pair gets the packer's zero
    pair); last_valid rebased, -1 where the row's last valid frame is not
    one the shard delivers."""
    lv = np.asarray(batch["last_valid"])
    pl, pr = np.asarray(batch["pair_l"]), np.asarray(batch["pair_r"])
    cce = sorted({k.split("_", 2)[2] for k in batch
                  if k.startswith("cce_src_")})
    out = []
    for lo, hi in lay.rows:
        row = []
        in_p = (pl >= lo) & (pl < hi)
        for k, (t0, t1) in enumerate(lay.frames):
            s = lay.lead(k)
            shard = {key: v[lo:hi, s:t1] for key, v in batch.items()
                     if key not in ("last_valid", "pair_l", "pair_r")
                     + _PAIR_PLANES and not key.startswith("cce_")}
            if in_p.any():
                shard.update(pair_l=pl[in_p] - lo, pair_r=pr[in_p] - lo,
                             **{p: batch[p][in_p, s:t1]
                                for p in _PAIR_PLANES})
            else:
                zero = np.zeros((1,) + batch["ms_mask"][:, s:t1].shape[1:],
                                np.float32)
                shard.update(pair_l=np.zeros(1, np.int32),
                             pair_r=np.zeros(1, np.int32),
                             ms_mask=zero, is_scale=zero)
            for kind in cce:
                src = np.asarray(batch[f"cce_src_{kind}"])
                dst = np.asarray(batch[f"cce_dst_{kind}"])
                sel = (dst >= lo) & (dst < hi)
                shard[f"cce_src_{kind}"] = src[sel] - lo
                shard[f"cce_dst_{kind}"] = dst[sel] - lo
                shard[f"cce_gain_{kind}"] = batch[f"cce_gain_{kind}"][sel,
                                                                     s:t1]
            lvr = lv[lo:hi]
            shard["last_valid"] = np.where((lvr >= t0) & (lvr < t1),
                                           lvr - s, -1).astype(np.int32)
            row.append(shard)
        out.append(row)
    return out


def shard_batch(mesh: Mesh, batch: dict, lay: Layout) -> Shards:
    """batch_shardings, each shard's arrays on its device."""
    parts = [[{k: packed_tensor(k, v, mesh.devices[i][j])
               for k, v in shard.items()} for j, shard in enumerate(row)]
             for i, row in enumerate(batch_shardings(mesh, batch, lay))]
    return Shards(parts, lay)


# -- the native parser's batch ------------------------------------------------
def spec_batch_shardings(mesh: Mesh, batch: dict, lay: Layout) -> list:
    """The native parser's batch (host tensors: meta, the spectra in one of
    their forms, the TNS, predictor and coupling planes) split per shard
    [i][k]: the [C, T, ...] planes sliced to the shard's slots and frames,
    the halo frames' `valid` role cleared in a copy of `meta`; the coupling
    entries (slot, slot, t) whose target slot and frame the shard holds,
    rebased."""
    out = []
    for lo, hi in lay.rows:
        row = []
        for k, (t0, t1) in enumerate(lay.frames):
            s = lay.lead(k)
            shard = {}
            for key, v in batch.items():
                if key.startswith("cce_"):
                    continue
                part = v[lo:hi, s:t1]
                if key == "meta" and t0 > s:
                    part = part.clone()
                    part[:, :t0 - s, 5] = 0
                shard[key] = part
            for kind in ("post", "time"):
                idx = batch.get(f"cce_{kind}_idx")
                if idx is None:
                    continue
                sel = ((idx[:, 1] >= lo) & (idx[:, 1] < hi)
                       & (idx[:, 2] >= s) & (idx[:, 2] < t1))
                shard[f"cce_{kind}_idx"] = idx[sel] - torch.tensor(
                    [lo, lo, s], dtype=idx.dtype)
                shard[f"cce_{kind}_gain"] = batch[f"cce_{kind}_gain"][sel]
            row.append(shard)
        out.append(row)
    return out


def shard_spec_batch(mesh: Mesh, batch: dict, lay: Layout) -> Shards:
    """spec_batch_shardings, each shard's tensors on its device."""
    parts = [[{k: v.to(mesh.devices[i][j]) for k, v in shard.items()}
              for j, shard in enumerate(row)]
             for i, row in enumerate(spec_batch_shardings(mesh, batch, lay))]
    return Shards(parts, lay)


# -- the decode steps ---------------------------------------------------------
# A shard's step runs as the reference's jitted program (a CUDA graph on the
# card, runtime/graphs.py) on the kernel route; the plain route
# (flags.use_pallas False, the reference's XLA route that the checks compare
# with) runs the eager functions.
_STEPS = {"step": (P.decode_step, P.jitted_decode_step, P.step_front,
                   P.step_back),
          "spec": (P.decode_spec_step, P.jitted_decode_spec_step,
                   P.spec_front, P.spec_back)}


def _whole_step(kind: str, flags: P.PipelineFlags):
    """fn(batch, overlap[, pred_state]): a whole chunk's step of `kind`."""
    eager, jitted, _, _ = _STEPS[kind]
    if flags.use_pallas:
        return jitted(flags)
    return lambda b, ov, *pred: eager(b, ov, flags, *pred)


def _pred_shard_fn(kind: str, flags: P.PipelineFlags, h: int):
    """One frame shard of a predicted chunk: fn(b, ov, pred_state, halo) ->
    (pcm, new overlap, new predictor state, the shard's own predicted
    spectra), b unpacked, halo the previous shard's last h predicted frames
    (None for h == 0)."""
    _, _, front, back = _STEPS[kind]

    def fn(b, ov, pred_state, halo):
        spec = front(b, flags)
        own = {key: b[key][:, h:].contiguous() for key in
               ("pred_mode", "pred_reset", "pred_nbins", "pred_used")}
        spec_own, pred_state = P.predict(spec[:, h:].contiguous(), own,
                                         pred_state, flags)
        spec = torch.cat([halo, spec_own], dim=1) if h else spec_own
        return (*back(spec, b, ov, flags), pred_state, spec_own)
    return fn


@functools.lru_cache(maxsize=None)
def _pred_shard_program(kind: str, flags: P.PipelineFlags, h: int):
    from aacjax_torch.runtime import graphs
    return graphs.Program(f"{kind}_pred_shard",
                          _pred_shard_fn(kind, flags, h), (flags, h))


def _row_step(parts: list, devs: tuple, lay: Layout, ov, pred_state,
              flags: P.PipelineFlags, kind: str):
    """One stream shard's chunk over its frame shards: (pcm [rows, T, F] on
    devs[0], new overlap, new predictor state or None)."""
    whole = _whole_step(kind, flags)
    if len(parts) == 1:
        if flags.has_pred:
            return whole(parts[0], ov, pred_state)
        return (*whole(parts[0], ov), None)
    if flags.has_pred and flags.eld:
        raise ValueError("ELD has no Main-profile prediction")
    home = devs[0]
    pcms, carry, prev = [], None, None
    for k, (b, dev) in enumerate(zip(parts, devs)):
        b = P.unpack_spec_batch(b)
        s = lay.lead(k)
        h = lay.frames[k][0] - s
        # frames before the chunk's start read the carry in; a shard that
        # starts later reads only its halo
        ov_k = ov.to(dev) if s == 0 else torch.zeros_like(ov, device=dev)
        if flags.has_pred:
            step = (_pred_shard_program(kind, flags, h) if flags.use_pallas
                    else _pred_shard_fn(kind, flags, h))
            pcm_k, new_k, pred_state, prev = step(
                b, ov_k, pred_state.to(dev),
                prev[:, -h:].to(dev) if h else None)
        else:
            pcm_k, new_k = whole(b, ov_k)
        new_k = new_k.to(home)
        lv_k = b["last_valid"].to(home)
        carry = (new_k if carry is None
                 else torch.where((lv_k >= 0)[:, None], new_k, carry))
        pcms.append(pcm_k[:, h:].to(home))
    state = pred_state.to(home) if flags.has_pred else None
    return torch.cat(pcms, dim=1), carry, state


def _sharded_step(flags, mesh, kind: str, shards: Shards, overlap,
                  pred_state=None):
    lay = shards.layout
    devs = mesh.row_devices
    ov = scatter(overlap, lay.rows, devs)
    preds = (scatter(pred_state, lay.rows, devs) if flags.has_pred
             else None)
    outs = [_row_step(shards.parts[i], mesh.devices[i], lay, ov.parts[i],
                      preds.parts[i] if preds is not None else None, flags,
                      kind)
            for i in range(len(lay.rows))]
    pcm, new_ov, new_pred = (RowBlocks([o[j] for o in outs], lay.rows, devs)
                             for j in range(3))
    return (pcm, new_ov, new_pred) if flags.has_pred else (pcm, new_ov)


def sharded_decode_step(flags: P.PipelineFlags, mesh: Mesh):
    """decode_step over the mesh: fn(shards (shard_batch), overlap[,
    pred_state]) -> (pcm, new overlap[, new predictor state]), RowBlocks
    over the stream shards.  The overlap and the state may come whole or
    as row blocks.  Each shard replays its compiled step on its device
    (jitted_decode_step) on the kernel route."""
    return functools.partial(_sharded_step, flags, mesh, "step")


def sharded_decode_spec_step(flags: P.PipelineFlags, mesh: Mesh):
    """decode_spec_step over the mesh, as sharded_decode_step, on shards of
    the native parser's batch (shard_spec_batch); with flags.has_pred it
    also takes and returns the predictor state."""
    return functools.partial(_sharded_step, flags, mesh, "spec")


# -- batched SBR / Parametric Stereo programs ---------------------------------
# Every dense plane and state FIFO is slot-local; the frame axis does not
# shard here (QMF analysis windows straddle the frames of a chunk), so these
# programs run per stream shard on its first device.
def stream_tree_shardings(mesh: Mesh, tree: dict, rows: tuple) -> list:
    """Row slices of every [C, ...] array of `tree` per stream shard; the
    PS output routing `out_src` (a global slot) rebased, which the layout
    keeps inside the shard."""
    out = []
    for lo, hi in rows:
        part = {k: v[lo:hi] for k, v in tree.items()}
        if "out_src" in part:
            src = part["out_src"] - lo
            if bool(((src < 0) | (src >= hi - lo)).any()):
                raise ValueError("a PS output slot routes across shards")
            part["out_src"] = src
        out.append(part)
    return out


def shard_stream_tree(mesh: Mesh, tree: dict, rows: tuple) -> list:
    """stream_tree_shardings, each shard's tensors on its stream shard's
    first device (numpy arrays become tensors)."""
    return [{k: torch.as_tensor(v).to(dev) for k, v in part.items()}
            for part, dev in zip(stream_tree_shardings(mesh, tree, rows),
                                 mesh.row_devices)]


def _per_row(fn, n_out: int, bounds, devs, *args):
    outs = [fn(*(a.parts[i] if isinstance(a, RowBlocks) else a[i]
                 for a in args)) for i in range(len(bounds))]
    return tuple(RowBlocks([o[j] for o in outs], bounds, devs)
                 for j in range(n_out))


def sharded_sbr_apply(mesh: Mesh, out_int16: bool = False):
    """The compiled sbr_apply (jitted_sbr_apply) per stream shard:
    fn(core_pcm, dense, state, cfg) -> (pcm, new state); core_pcm and state
    are RowBlocks, dense and cfg lists of per-shard dicts
    (shard_stream_tree)."""
    from aacjax_torch.kernels.sbr_batch import jitted_sbr_apply
    prog = jitted_sbr_apply(out_int16)

    def fn(core_pcm, dense, state, cfg):
        return _per_row(prog, 2, core_pcm.bounds, core_pcm.devices, core_pcm,
                        dense, state, cfg)
    return fn


def sharded_sbr_ps_apply(mesh: Mesh, out_int16: bool = False,
                         is34: bool = False):
    """The compiled sbr_ps_apply per stream shard: fn(core_pcm, dense,
    ps_dense, state, ps_state, cfg) -> (pcm, new SBR state, new PS
    state)."""
    from aacjax_torch.kernels.ps_batch import jitted_sbr_ps_apply
    prog = jitted_sbr_ps_apply(out_int16, is34)

    def fn(core_pcm, dense, ps_dense, state, ps_state, cfg):
        return _per_row(prog, 3, core_pcm.bounds, core_pcm.devices, core_pcm,
                        dense, ps_dense, state, ps_state, cfg)
    return fn


def sharded_sbr_ps_apply_dual(mesh: Mesh, out_int16: bool = False):
    """The compiled sbr_ps_apply_dual per stream shard: fn(core_pcm, dense,
    ps_dense, state, ps20, ps34, cfg) -> (pcm, SBR state, 20-band, 34-band
    state)."""
    from aacjax_torch.kernels.ps_batch import jitted_sbr_ps_apply_dual
    prog = jitted_sbr_ps_apply_dual(out_int16)

    def fn(core_pcm, dense, ps_dense, state, ps20, ps34, cfg):
        return _per_row(prog, 4, core_pcm.bounds, core_pcm.devices, core_pcm,
                        dense, ps_dense, state, ps20, ps34, cfg)
    return fn


# -- the batched encoder ------------------------------------------------------
# Both encoder programs lead with a flat channel-row axis (B = streams *
# channels rows on the analysis inputs, N = B * n_frames rows after it,
# b's frames contiguous) and never mix rows: each stream shard encodes its
# block of rows on its first device.
def _row_sharding(mesh: Mesh, n_rows: int) -> tuple:
    """Equal blocks of `n_rows` channel rows over the 'stream' shards."""
    n = mesh.shape["stream"]
    if n_rows % n:
        raise ValueError(f"{n_rows} channel rows do not split over {n} "
                         "'stream' shards")
    per = n_rows // n
    return tuple((i * per, (i + 1) * per) for i in range(n))


def sharded_encode_analysis(sample_index: int, cutoff_bin: int, frame: int,
                            n_frames: int, psy_key: tuple, mesh: Mesh):
    """The compiled encoder analysis (_jitted_analysis) per stream shard:
    fn(pcm_i16, w_idx, is_short), each a list of the shards' row blocks on
    their devices, -> the list of the shards' outputs (coefs, base, fit_sf,
    est, bin_band)."""
    from aacjax_torch.encode_batch import _jitted_analysis
    prog = _jitted_analysis(sample_index, cutoff_bin, frame, n_frames,
                            psy_key)

    def fn(pcm_i16, w_idx, is_short):
        return [prog(*a) for a in zip(pcm_i16, w_idx, is_short)]
    return fn


def sharded_encode_quantize(mesh: Mesh, w8: int):
    """The compiled encoder quantize (_jitted_quantize) per stream shard:
    fn(outs, off, is_short_row), lists over the shards, -> the list of
    (packed q, sf)."""
    from aacjax_torch.encode_batch import _jitted_quantize
    q = _jitted_quantize(w8)

    def fn(outs, off, is_short_row):
        return [q(c, b, f, bb, o, s) for (c, b, f, _e, bb), o, s in
                zip(outs, off, is_short_row)]
    return fn
