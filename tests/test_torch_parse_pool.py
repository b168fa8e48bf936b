"""The port's native parse on its pool of persistent workers
(aacjax_torch/native, `aacparse_batch_spec`): every output of a call under
2, 4 and all workers is the output under one, call after call on the same
pool; the coupling entries come out in stream order and the message is
the lowest failing stream's; two threads calling at once, a child forked
after the pool started, an idle pool's CPU time, a coupling-entry
overflow, and the counters `parse_workers` and `parse_tail_ns`."""
import os
import select
import sys
import threading
import time
import warnings

import numpy as np
import pytest

import aacjax_torch
from aacjax_torch import testing as TI
from aacjax_torch.host import native
from aacjax_torch.host.bitio import BitWriter
from aacjax_torch.runtime.batch import PARSE_COUNTERS
from aacjax_torch.runtime.stats import Trace
from aacjax_torch.testing import encoder as enc
from aacjax_torch.testing.specgen import random_cpe_spec
from aacjax_torch.testing.streams import make_lc_payload_chunks

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native parser not built")

T = 6
N_CALLS = 10
CPUS = len(os.sched_getaffinity(0))
GRAIN = 4  # the native kGrain
PLANES = ("spec", "meta", "tns_lpc", "tns_range", "cce_counts",
          "consumed_bits", "fil_sbr", "fil_drc", "spec_i16", "spec_scale")


def _lc_frames(n: int, seed: int) -> list[bytes]:
    cfg = TI.lc_stereo_config()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = BitWriter()
        enc.write_cpe(w, random_cpe_spec(rng, cfg, common=True), cfg)
        out.append(enc.end_frame(w))
    return out


def _uneven_chunk(route: str, n: int = 40, seed: int = 0):
    """n streams of uneven work: chunks of 1..T frames, empty streams, a
    concealed corrupt frame; on the LC routes coupling streams whose
    entries reach the device (AFTER_TNS onto TNS'd targets, AFTER_IMDCT)
    spread over the grains, and streams stopped at ERR_FALLBACK (a
    coupling channel with no slot).  Returns (configs, chunk, n_slots,
    the indices of the fallback streams)."""
    main = route == "main"
    cfg = TI.main_config() if main else TI.lc_stereo_config()
    chunk, n_slots, fallback = [], [], []
    for s in range(n):
        slots, k = 3, s % 10
        if k == 4:
            frames = None
        elif not main and s % 13 == 3:
            frames = TI.cce_stereo_payloads(T, 100 + s, 1, target_tns=True)
        elif not main and s % 13 == 8:
            frames = TI.cce_stereo_payloads(T - s % 3, 100 + s, 2)
        elif not main and s % 17 == 11:
            frames, slots = TI.cce_stereo_payloads(T, 100 + s, 2), 2
            fallback.append(s)
        else:
            n_frames = 1 + (seed + 7 * s) % T
            frames = (TI.main_stereo_payloads(n_frames, 100 + s) if main
                      else _lc_frames(n_frames, 100 + s))
            if s % 9 == 7 and n_frames > 2:
                frames[1] = frames[1][:5]
        chunk.append(frames)
        n_slots.append(slots)
    return [cfg] * n, chunk, np.array(n_slots, np.int32), fallback


def _parse(configs, chunk, n_slots, route: str, workers=None,
           counts=None, out=None):
    """One call; returns (status, has_tns, message, planes)."""
    prev_env = os.environ.get("AACJAX_PARSE_THREADS")
    if workers is not None:
        os.environ["AACJAX_PARSE_THREADS"] = str(workers)
    try:
        base = np.concatenate([[0], np.cumsum(n_slots)[:-1]]).astype(np.int32)
        C = int(n_slots.sum())
        out = out or native.SpecBatchArrays(C, T)
        prev = np.zeros(C, np.int32)
        status, has_tns, msg = native.parse_batch_spec(
            chunk, np.array([c.sample_index for c in configs], np.int32),
            np.array([c.chan_config for c in configs], np.int32), base,
            n_slots, prev, out, tables_pack=native.stream_tables(configs),
            want_qsf=route == "qsf", want_pred=route == "main",
            want_i16=True, counts=counts)
    finally:
        if workers is not None:
            if prev_env is None:
                del os.environ["AACJAX_PARSE_THREADS"]
            else:
                os.environ["AACJAX_PARSE_THREADS"] = prev_env
    planes = {k: np.array(getattr(out, k)) for k in PLANES}
    n_post, n_time = out.cce_counts
    planes.update(cce_post_idx=out.cce_post_idx[:n_post].copy(),
                  cce_post_gain=out.cce_post_gain[:n_post].copy(),
                  cce_time_idx=out.cce_time_idx[:n_time].copy(),
                  cce_time_gain=out.cce_time_gain[:n_time].copy(),
                  prev_shapes=prev)
    if route == "qsf":
        planes.update(spec_q=out.spec_q.copy(), spec_sf=out.spec_sf.copy(),
                      qsf_ok=out.qsf_ok.copy())
    if route == "main":
        planes.update(pred_meta=out.pred_meta.copy(),
                      pred_used=out.pred_used.copy())
    return status.copy(), has_tns, msg, planes


def _assert_same(got, want, what=""):
    status, has_tns, msg, planes = got
    w_status, w_has_tns, w_msg, w_planes = want
    np.testing.assert_array_equal(status, w_status, err_msg=what)
    assert (has_tns, msg) == (w_has_tns, w_msg), what
    assert planes.keys() == w_planes.keys()
    for k, v in planes.items():
        w = w_planes[k]
        assert v.shape == w.shape, (what, k)
        if v.dtype == np.float32:
            v, w = v.view(np.uint32), w.view(np.uint32)
        assert np.array_equal(v, w), (what, k)


@pytest.mark.parametrize("workers", ["2", "4", "all"])
@pytest.mark.parametrize("route", ["lc", "qsf", "main"])
def test_every_output_is_one_workers(route, workers):
    """N_CALLS calls in a row on one pool give what one worker gives,
    bit for bit: statuses, message, every plane, the coupling entries in
    stream order, and the band counts."""
    n_workers = CPUS if workers == "all" else int(workers)
    configs, chunk, n_slots, fallback = _uneven_chunk(route)
    one_counts = np.zeros(len(PARSE_COUNTERS), np.int64)
    want = _parse(configs, chunk, n_slots, route, 1, one_counts)
    status, _, msg, planes = want
    failed = np.flatnonzero(status)
    assert failed.size and msg.startswith(f"stream {failed[0]} ")
    assert one_counts[3] == 1
    if route != "main":
        assert (status[fallback] == native.ERR_FALLBACK).all()
        n_post, n_time = planes["cce_counts"]
        assert n_post > 0 and n_time > 0
        # stream order: the entries' source slots rise
        for k in ("cce_post_idx", "cce_time_idx"):
            src = planes[k][:, 0]
            assert (np.diff(src) >= 0).all(), k
    for call in range(N_CALLS):
        counts = np.zeros(len(PARSE_COUNTERS), np.int64)
        got = _parse(configs, chunk, n_slots, route, n_workers, counts)
        _assert_same(got, want, f"call {call}")
        np.testing.assert_array_equal(counts[:3], one_counts[:3])
        assert 1 <= counts[3] <= min(n_workers, -(-len(chunk) // GRAIN))
        assert counts[4] >= 0


def test_two_threads_at_once_match_serial(monkeypatch):
    """Two Python threads parse different chunks at once, with more
    workers than cores and a short switch interval; each call of each
    gives that chunk's serial result."""
    chunks = [_uneven_chunk("lc", seed=0), _uneven_chunk("qsf", 36, seed=3)]
    routes = ["lc", "qsf"]
    want = [_parse(*c[:3], r, 1) for c, r in zip(chunks, routes)]
    monkeypatch.setenv("AACJAX_PARSE_THREADS", str(2 * CPUS))
    barrier = threading.Barrier(2, timeout=60)
    errors, done = [], [0, 0]

    def run(i):
        try:
            barrier.wait()
            for call in range(N_CALLS):
                got = _parse(*chunks[i][:3], routes[i])
                _assert_same(got, want[i], f"thread {i} call {call}")
                done[i] += 1
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert done == [N_CALLS, N_CALLS]


def _big_chunk(route: str):
    """_uneven_chunk's 40 streams five times over: a call long enough
    that the helpers wake before the caller has parsed it alone."""
    configs, chunk, n_slots, _ = _uneven_chunk(route)
    return configs * 5, chunk * 5, np.tile(n_slots, 5)


def _most_workers(configs, chunk, n_slots, n_calls=5) -> int:
    most = 0
    for _ in range(n_calls):
        counts = np.zeros(len(PARSE_COUNTERS), np.int64)
        _parse(configs, chunk, n_slots, "lc", 4, counts)
        most = max(most, int(counts[3]))
    return most


def test_child_forked_after_the_pool_parses():
    """A parse on the pool, then fork: the child's parses give the
    parent's result, and its own pool's helpers take streams."""
    configs, chunk, n_slots = _big_chunk("lc")
    want = _parse(configs, chunk, n_slots, "lc", 4)
    read_fd, write_fd = os.pipe()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pid = os.fork()
    if pid == 0:  # the child: report and leave without pytest's exit
        code = 1
        try:
            got = _parse(configs, chunk, n_slots, "lc", 4)
            _assert_same(got, want, "child")
            most = _most_workers(configs, chunk, n_slots)
            os.write(write_fd, b"ok" if most > 1 else b"workers %d" % most)
            code = 0
        except BaseException as e:  # noqa: BLE001 - the child must exit
            os.write(write_fd, repr(e).encode()[:4000])
        finally:
            os._exit(code)
    os.close(write_fd)
    ready = []
    try:
        ready, _, _ = select.select([read_fd], [], [], 120)
        report = os.read(read_fd, 4096) if ready else b"no answer in 120 s"
    finally:
        os.close(read_fd)
        if not ready:
            os.kill(pid, 9)
        _, status = os.waitpid(pid, 0)
    assert report == b"ok", report
    assert os.waitstatus_to_exitcode(status) == 0
    # the parent's pool still parses too
    _assert_same(_parse(configs, chunk, n_slots, "lc", 4), want, "parent")


def test_idle_pool_takes_no_cpu():
    """After a parse on every CPU, the pool's workers sleep: the process
    spends under 20 ms of CPU time over half a second."""
    configs, chunk, n_slots = _big_chunk("lc")
    _parse(configs, chunk, n_slots, "lc", CPUS)
    time.sleep(0.3)  # past any spin of another library's threads
    c0 = time.process_time()
    time.sleep(0.5)
    assert time.process_time() - c0 < 0.02


def test_coupling_overflow_ends_the_same_for_any_worker_count():
    """A stream whose coupling entries no longer fit what is left of the
    capacity gets ERR_FALLBACK and the message; a later stream's entries
    go in if they fit; the same under 1, 2 and 4 workers."""
    cfg = TI.lc_stereo_config()
    n = 24
    chunk = [_lc_frames(T, 300 + s) for s in range(n)]
    # AFTER_IMDCT onto both channels: two time entries a frame
    chunk[2] = TI.cce_stereo_payloads(4, 1, 2)     # 8 entries: fit
    chunk[9] = TI.cce_stereo_payloads(4, 2, 2)     # 8: overflow
    chunk[17] = TI.cce_stereo_payloads(2, 3, 2)    # 4: fit
    n_slots = np.full(n, 3, np.int32)
    results = []
    for workers in (1, 2, 4):
        out = native.SpecBatchArrays(int(n_slots.sum()), T)
        out.time_cap = 12
        results.append(_parse([cfg] * n, chunk, n_slots, "lc", workers,
                              out=out))
    status, _, msg, planes = results[0]
    assert np.flatnonzero(status).tolist() == [9]
    assert status[9] == native.ERR_FALLBACK
    assert msg.startswith("stream 9: cce:")
    np.testing.assert_array_equal(planes["cce_counts"], [0, 12])
    src = planes["cce_time_idx"][:, 0]
    assert (src[:8] == 2 * 3 + 2).all() and (src[8:] == 17 * 3 + 2).all()
    for got in results[1:]:
        _assert_same(got, results[0])


def test_counters_say_how_the_pool_engaged():
    """parse_workers: 0 for no streams, 1 for a call of one grain (the
    caller alone), at most the workers asked and the grains, and more
    than one on a long call; the tail is never negative; a traced
    `_parse_native` records both under the chunk."""
    configs, chunk, n_slots, _ = _uneven_chunk("lc", 40)
    for n, lo, hi in ((0, 0, 0), (GRAIN, 1, 1), (40, 1, 4)):
        counts = np.zeros(len(PARSE_COUNTERS), np.int64)
        _parse(configs[:n], chunk[:n], n_slots[:n], "lc", 4, counts)
        assert lo <= counts[3] <= hi, (n, counts)
        assert counts[4] >= 0
    assert _most_workers(*_big_chunk("lc")) > 1
    with pytest.raises(ValueError):
        _parse(configs, chunk, n_slots, "lc", 4, np.zeros(3, np.int64))

    configs, chunks = make_lc_payload_chunks(n_streams=12, chunk_frames=4)
    dec = aacjax_torch.BatchDecoder(configs, chunk_frames=4, device="cpu")
    dec.trace = Trace()
    dec._parse_native(chunks[0], compact=True, chunk_id=5)
    c = dec.trace.counters
    assert 1 <= c[("parse_workers", 5)] <= -(-12 // GRAIN)
    assert c[("parse_tail_ns", 5)] >= 0
