"""The port's benchmark (aacjax_torch/bench.py) against the reference's
(bench.py) on the CPU.

The numbers are CPU timings and say nothing of the card; what is held is
the benchmark's definition: the same metrics, the same result and stage
keys less the documented differences (`vs_baseline` and the reference's
A/B key `compute_pallas_s` / `compute_xla_s` out, `device` in), the same
audio a chunk, the same corpora and traffic, the encoder's bitrate within
1 kbps, the budget split up front, and no run without a card.
"""
import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys

import jax  # noqa: F401  (JAX on the CPU beside torch, as the other tests)
import numpy as np
import pytest

import bench
from aacjax_torch import bench as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LC_ARGS = dict(streams=4, unique=2, seconds=0.6, chunk=8, repeats=1)
# bench.py:245-248, the keys of measure_stages_he's result
HE_STAGE_KEYS = {"host_s", "core_s", "core_compute_s", "sbr_h2d_s",
                 "sbr_dispatch_s", "sbr_compute_s", "d2h_s"}
HE_ADDED_KEYS = {"chunk_audio_s", "compute_realtime_x"}
# aacjax/encode_batch.py:544-545, the encoder's stats: bench_encode's stages
ENC_STAGE_KEYS = {"h2d_s", "analysis_s", "d2h_s", "host_s", "write_s",
                  "frames"}


@pytest.fixture
def short_chains(monkeypatch):
    """Chains of 2 calls in the stage splits: their CPU timings say nothing
    of the card, and the SBR + PS program costs seconds a call here."""
    for name in ("LC_CHAIN", "HE_CHAIN", "ENC_CHAIN"):
        monkeypatch.setattr(port, name, 2)


def _ref_args(monkeypatch, **kw) -> argparse.Namespace:
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    args = bench._parse_args()
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _port_args(**kw) -> argparse.Namespace:
    argv = []
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    return port._parse_args(argv)


def _finite_positive(stages: dict, signed=("pipeline_overlap_eff",)):
    for k, v in stages.items():
        assert isinstance(v, (int, float)) and math.isfinite(v), (k, v)
        if k not in signed:
            assert v > 0, (k, v)


class _Window:
    """A `timed` hook that records how often it was entered and left."""

    def __init__(self):
        self.entered = self.left = 0

    @contextlib.contextmanager
    def __call__(self):
        self.entered += 1
        yield
        self.left += 1


def _kbps(unit: str) -> float:
    return float(re.search(r"~(\d+) kbps", unit).group(1))


def test_flags_match_reference(monkeypatch):
    """The same flags and defaults, less --pallas (one device route)."""
    ref = vars(_ref_args(monkeypatch))
    ref.pop("pallas")
    assert vars(port._parse_args([])) == ref


def test_lc_matches_reference(monkeypatch, short_chains):
    want = bench.bench_lc(_ref_args(monkeypatch, **LC_ARGS))
    window = _Window()
    got = port.bench_lc(_port_args(**LC_ARGS), device="cpu", timed=window)
    assert (window.entered, window.left) == (1, 1)
    assert got["metric"] == want["metric"] == "aggregate_realtime_x"
    assert set(got) == set(want) - {"vs_baseline"} | {"device"}
    assert got["device"] == "cpu"
    ref_stages = set(want["stages"]) - {"compute_pallas_s", "compute_xla_s"}
    assert set(got["stages"]) == ref_stages
    assert got["stages"]["chunk_audio_s"] == want["stages"]["chunk_audio_s"]
    assert len(got["reps"]) == 1 and got["value"] > 0
    _finite_positive(got["stages"])


def test_encode_matches_reference(short_chains):
    want = bench.bench_encode(2, 0.5, 4, 1)
    window = _Window()
    got = port.bench_encode(2, 0.5, 4, 1, device="cpu", timed=window)
    assert (window.entered, window.left) == (1, 1)
    assert got["metric"] == want["metric"] == "encode_aggregate_realtime_x"
    assert set(got["stages_split"]) == set(want["stages_split"])
    assert (got["stages_split"]["chunk_audio_s"]
            == want["stages_split"]["chunk_audio_s"])
    assert abs(_kbps(got["unit"]) - _kbps(want["unit"])) <= 1
    assert set(got["stages"]) == ENC_STAGE_KEYS
    if "stages" in want:        # bench.py:473 drops them on some reps
        assert set(want["stages"]) == ENC_STAGE_KEYS
    assert got["stages"]["frames"] == 2 * 5 * 4     # streams x chunks x T
    _finite_positive(got["stages_split"])


@pytest.mark.parametrize("ps", [False, True], ids=["he", "ps"])
def test_bench_he(ps, short_chains):
    window = _Window()
    got = port.bench_he(2, 0.5, 8, 1, ps=ps, device="cpu", timed=window)
    assert (window.entered, window.left) == (1, 1)
    assert got["metric"] == ("he_aac_v2_aggregate_realtime_x" if ps
                             else "he_aac_aggregate_realtime_x")
    assert set(got) == {"metric", "value", "median", "reps", "unit",
                        "device", "stages"}
    assert set(got["stages"]) == HE_STAGE_KEYS | HE_ADDED_KEYS
    assert got["stages"]["chunk_audio_s"] == round(2 * 8 * 2048 / 44100, 2)
    _finite_positive(got["stages"])


def _bench_he_frames(seconds: float, chunk: int, ps: bool):
    """bench_he's corpus (bench.py:341-368), built with aacjax's
    encoder."""
    from scipy import signal as sig

    from aacjax.host import sbr as S
    from aacjax.host.asc import make_asc, parse_asc
    from aacjax.testing import encoder as enc
    from aacjax.testing.sbr_encoder import PSSpec, SBRFrameSpec, sbr_payload

    core_cfg = parse_asc(make_asc(2, 7, 1 if ps else 2))
    h = S.SBRHeader(amp_res=1, start_freq=4, stop_freq=3, xover_band=0)
    t = S.derive_tables(h, 44100)
    spec = SBRFrameSpec(num_env=2, freq_res=1, invf=[1] * t.n_q,
                        env_q=np.full((2, t.n_high), 25, np.int64),
                        noise_q=np.full((2, t.n_q), 24, np.int64))
    if ps:
        psd = PSSpec(iid_mode=0, num_env=2,
                     iid_par=np.stack([np.arange(10) % 15 - 7,
                                       7 - np.arange(10) % 15]),
                     icc_mode=0, icc_par=np.arange(20).reshape(2, 10) % 8,
                     ipd_par=np.arange(10).reshape(2, 5) % 8,
                     opd_par=np.arange(10)[::-1].reshape(2, 5) % 8)
        pay = sbr_payload([spec], h, 44100, ps=psd)
    else:
        pay = sbr_payload([spec, spec], h, 44100)
    n = int(seconds * 22050) // 1024 * 1024
    rng = np.random.default_rng(7)
    bl, al = sig.butter(8, 3600 / 11025.0)
    nch = 1 if ps else 2
    x = sig.lfilter(bl, al, rng.standard_normal((n, nch)), axis=0) * 9000
    frames = enc.encode_pcm_frames(x, core_cfg, target_sf=122,
                                   fil_payloads=[pay])
    return core_cfg, list(frames[:len(frames) // chunk * chunk])


@pytest.mark.parametrize("ps", [False, True], ids=["he", "ps"])
def test_he_corpus_matches_bench(ps):
    from aacjax_torch.testing import he_serving_corpus, ps_serving_corpus
    cfg, corpus = (ps_serving_corpus if ps else he_serving_corpus)(1, 0.5, 8)
    want_cfg, want = _bench_he_frames(0.5, 8, ps)
    assert (cfg.sample_rate, cfg.channels) == (want_cfg.sample_rate,
                                               want_cfg.channels)
    assert len(corpus) == 1 and len(want) == 8
    assert [bytes(f) for f in corpus[0]] == [bytes(f) for f in want]


def test_budget_split_up_front(monkeypatch):
    shares = port.budget_shares(900.0)
    assert list(shares) == list(port.MODES) == ["lc", "he", "ps", "encode"]
    assert all(v > 0 for v in shares.values())
    assert sum(shares.values()) <= 900.0
    # a mode that overruns its share by far leaves the next mode's intact
    clock = [0.0]
    monkeypatch.setattr(port.time, "time", lambda: clock[0])
    monkeypatch.setattr(port.time, "perf_counter", lambda: clock[0])
    got = {}

    def mode(name, overrun=0.0, fail=False):
        def fn(rb):
            got[name] = rb
            clock[0] += overrun
            if fail:
                raise RuntimeError("boom")
            return {"value": 1.0}
        return fn
    modes = port.run_modes({"he": mode("he", overrun=10 * shares["he"]),
                            "ps": mode("ps", fail=True),
                            "encode": mode("encode")}, shares)
    assert got == {k: shares[k] for k in ("he", "ps", "encode")}
    assert modes["he"] == modes["encode"] == {"value": 1.0}
    assert modes["ps"] == {"error": "RuntimeError('boom')"}
    assert not any("skipped" in m for m in modes.values())


def test_main_without_card(monkeypatch, capsys):
    """No card: main fails before any bench runs."""
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: False)

    def never(*a, **k):
        raise AssertionError("a bench ran without a card")
    for name in ("bench_lc", "bench_he", "bench_encode"):
        monkeypatch.setattr(port, name, never)
    for argv in ([], ["--lc-only"], ["--he", "--ps"], ["--encode"]):
        assert port.main(argv) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA card" in out.err


def test_cli_without_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "aacjax_torch.bench",
                        "--lc-only", "--streams", "2"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout == "" and "no CUDA card" in r.stderr


def test_profile_writes_trace(tmp_path):
    args = _port_args(streams=2, unique=1, seconds=0.4, chunk=8, repeats=1,
                      profile=tmp_path)
    args.no_stages = True
    got = port.bench_lc(args, device="cpu")
    assert "stages" not in got
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
