"""The harness's pieces: discovery by name, the window's statistics, the
tail kernel's bytes and operations, the refusal without a card."""
import json
import subprocess
import sys

import numpy as np
import pytest

from portbench import registry, roofline
from portbench.window import Window

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_finds_its_config_traffic_and_route(name):
    c = registry.cell(BENCH, name)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert c.config["name"] == w["config"]
    assert c.traffic["streams"] > 0 and c.traffic["chunk_frames"] > 0
    for attr in ("CHECK", "SBR", "OUT_SAMPLES", "KEY_FLAGS", "decoder",
                 "serve", "instrument"):
        assert hasattr(c.route, attr)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    assert callable(registry.metric(m["name"]).read)


def test_a_new_file_is_found_by_its_name(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "made_up.x.py").write_text(
        "def read(run):\n    return 42.0\n")
    monkeypatch.setattr(registry, "HERE", tmp_path)
    assert registry.metric("made_up.x").read(None) == 42.0
    with pytest.raises(FileNotFoundError):
        registry.metric("absent")


def test_configs_files_are_the_benchmarks():
    for c in BENCH["configs"]:
        cfg = json.loads((registry.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def _window(latencies, period=0.1, warmup=2, seconds=2.01):
    """A closed loop: each chunk is handed over `period` after the last,
    and a chunk's extra latency holds back every later one."""
    w = Window(seconds=seconds, chunk_audio_s=10.0, warmup_chunks=warmup)
    t = 0.0
    for lat in latencies:
        t += period
        w.handed.append(t)
        w.record(t + lat)
        t += lat - latencies[0]
    return w


def test_rate_and_p95_over_every_chunk():
    w = _window([0.05] * 40)
    ks = w.chunks()
    assert ks[0] == 2 and len(ks) == 20          # done at 0.15 + 0.1 k
    assert w.realtime_x() == pytest.approx(20 * 10.0 / 2.0)
    assert w.latencies_s() == pytest.approx([0.05] * 20)
    assert w.p95_ms() == pytest.approx(50.0)


def test_one_stalled_chunk_moves_both():
    base = _window([0.05] * 40)
    lat = [0.05] * 40
    lat[10] = 1.0                       # chunk 10 stalls
    w = _window(lat)
    assert w.realtime_x() < base.realtime_x()
    assert w.p95_ms() > base.p95_ms()
    assert w.p95_ms() == pytest.approx(
        float(np.percentile(w.latencies_s(), 95)) * 1e3)
    assert len(w.latencies_s()) == len(w.chunks())


def test_warmup_chunks_are_not_in_the_window():
    w = _window([0.05] * 10, warmup=4)
    assert w.chunks()[0] == 4 and w.t_open == w.done[3]


def test_no_chunk_in_the_window_gives_no_number():
    w = Window(seconds=1.0, chunk_audio_s=1.0, warmup_chunks=3)
    w.handed.append(0.0)
    w.record(0.1)
    assert w.chunks() == [] and w.realtime_x() is None and w.p95_ms() is None


@pytest.mark.parametrize("C,T", [(1024, 16), (128, 2)])
def test_tail_bytes_and_operations_at_the_cells_shapes(C, T):
    n = C * T
    want = (n * 1024 * 2 + n * 64 * 4 + 6 * n * 4 + C * 4
            + 2 * C * 1024 * 4 + 80832 + n * 1024 * 2)
    assert roofline.tail_bytes(C, T, True, True) == want
    long_ops = 6144 + 9984 + 5376
    assert roofline.FFT_FLOPS[False] == long_ops
    assert roofline.tail_flops(C, T, 0.0, True) == n * (long_ops + 6 * 1024)
    short = roofline.tail_flops(C, T, 1.0, True)
    assert short == n * (6144 + 6656 + 2688 + 6 * 1024)
    b, by = roofline.bound_s(want, roofline.tail_flops(C, T, 0.015, True))
    assert by == "bytes" and b == pytest.approx(want / 3.35e12)


def test_tail_bound_at_the_bulk_shape_is_0_0239_ms():
    b, _ = roofline.bound_s(roofline.tail_bytes(1024, 16, True, True), 0)
    assert b * 1e3 == pytest.approx(0.0239, abs=5e-4)   # PERF.md PR 15


def test_without_a_card_the_command_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "lc256k.bulk", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=registry.ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_tail_roofline_reads_each_calls_types_from_the_kernel_name():
    from types import SimpleNamespace

    from portbench.metrics import tail_roofline_pct
    from portbench.trace import Profile
    C, T = 1024, 16
    f32_in = roofline.bound_s(roofline.tail_bytes(C, T, False, True), 0)[0]
    i16_in = roofline.bound_s(roofline.tail_bytes(C, T, True, True), 0)[0]
    whole = {"void filterbank_kernel<false, 0>(Params)": [2 * f32_in] * 3,
             "void filterbank_kernel<true, 0>(Params)": [4 * i16_in],
             "void filterbank_kernel<false, 2>(Params)": [1.0],
             "void tns_filter_kernel<1024, true>(float const*)": [1.0]}
    run = SimpleNamespace(
        profile=Profile(1.0, 0.5, {}, whole, [], 0.0),
        cell=SimpleNamespace(traffic={"streams": 512, "chunk_frames": T},
                             config={"channels": 2}),
        frame_share=lambda flag: 0.0)
    want = 100 * (3 * f32_in + i16_in) / (6 * f32_in + 4 * i16_in)
    assert tail_roofline_pct.read(run) == pytest.approx(want)
    run.profile = Profile(1.0, 0.5, {}, {}, [], 0.0)
    assert tail_roofline_pct.read(run) is None


def test_the_sbr_cache_stand_in_counts_lookups_hits_and_inserts():
    from types import SimpleNamespace

    from portbench.metrics import sbr_cache_hit_pct
    from portbench.trace import Tracer
    he = registry.route("he")
    dec = SimpleNamespace(_sbr_parse_cache={})

    def init():                 # the program makes its cache at chunk 1
        if not hasattr(dec, "_made"):
            dec._made = True
            dec._sbr_parse_cache = {("old", 0, 2): "sf"}
    dec._sbr_init = init
    tracer = Tracer(False)
    he._count_cache(dec, tracer)
    dec._sbr_init()
    cache = dec._sbr_parse_cache
    assert isinstance(cache, he.CountingCache) and ("old", 0, 2) in cache
    cache.get(("a", 1, 2))                   # before the window: not counted
    tracer.mark()
    for key in (("a", 1, 2), ("b", 1, 2), ("old", 0, 2)):
        if cache.get(key) is None:
            cache[key] = "sf"
    dec._sbr_init()                          # later chunks keep the stand-in
    assert dec._sbr_parse_cache is cache
    tracer._read_counters(2)                 # as the window closes
    got = {n: tracer.counted(f"sbr_cache_{n}")
           for n in ("lookups", "hits", "inserts")}
    assert got == {"lookups": 3, "hits": 1, "inserts": 2}
    run = SimpleNamespace(counted=tracer.counted)
    assert sbr_cache_hit_pct.read(run) == pytest.approx(100 / 3)
    assert sbr_cache_hit_pct.read(SimpleNamespace(
        counted=lambda n: 0)) is None
