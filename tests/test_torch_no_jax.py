"""The port stands alone: it imports nothing of JAX, of the `aacjax`
package or of `bench.py` (the machine with the GPU has no JAX), its copies
of aacjax's host modules equal the originals but for their import lines,
its kernel modules import without nvcc or triton, and a CUDA request
without CUDA raises instead of running on the CPU."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

# port file -> the aacjax file it copies (the same relative path)
COPIES = ("tables.py", "host/bitio.py", "host/adts.py", "host/asc.py",
          "host/huffman.py", "host/huffman_books.npz", "host/syntax.py",
          "host/sbr.py", "host/sbr_tables.npz", "host/ps.py",
          "host/ps_tables.npz", "host/native.py", "host/aac_960_tables.npz",
          "host/latm.py", "host/ltp_batch.py", "host/refdec.py",
          "host/sbr_pack.py", "host/sbr_decode.py", "host/ps_decode.py",
          "host/ps_pack.py", "host/mp4.py", "host/native_write.py",
          "encode.py", "encode_he.py", "aurora.py",
          "kernels/windows.py", "runtime/pack.py", "testing/encoder.py",
          "testing/specgen.py", "testing/streams.py",
          "testing/sbr_encoder.py", "testing/mp4mux.py",
          "testing/ffmpeg_oracle.py")

# copies whose named top-level definitions differ from the original's: the
# port's binding loads the port's own parser (aacjax_torch/native, ABI 12),
# whose parse also writes the block-scaled int16 spectra in its threads
# (`parse_batch_spec(want_i16=True)`)
FORKED = {"host/native.py": {"__doc__", "_LIB_PATH", "_ABI_VERSION", "_load",
                             "parse_batch_spec"}}

_NO_JAX_DECODE = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
import numpy as np
import aacjax_torch
from aacjax_torch.host import native
from aacjax_torch.host.asc import make_asc, parse_asc
from aacjax_torch.testing.encoder import encode_pcm
assert native.available()
cfg = parse_asc(make_asc(2, 4, 2))
n = 1024 * 6
t = np.arange(n) / 44100.0
x = 8000 * np.sin(2 * np.pi * 440 * t)
pcm = np.stack([x, 0.8 * x], axis=1)
out, rate = aacjax_torch.decode_adts(encode_pcm(pcm, cfg, target_sf=120),
                                     device="cpu")
dec = out[1024:1024 + n] * 32768.0
err = dec[2048:n - 2048] - pcm[2048:n - 2048]
snr = 10 * np.log10(np.sum(pcm[2048:n - 2048] ** 2) / np.sum(err ** 2))
assert rate == 44100 and snr > 60.0, snr
# a Main-profile stream (prediction, TNS, short windows) and an ELD stream
# through LOAS
from aacjax_torch import testing as TI
main, rate = aacjax_torch.decode_adts(TI.main_stereo_adts(6, seed=0),
                                      chunk_frames=4, device="cpu")
assert main.shape == (6 * 1024, 2) and np.isfinite(main).all()
assert np.abs(main).max() > 0
eld_cfg = TI.er_config(39, 512, 2)
loas = TI.enc.loas_stream(TI.er_payloads(eld_cfg, 4, seed=1), eld_cfg)
eld, rate = aacjax_torch.decode_loas(loas, device="cpu")
assert eld.shape == (4 * 512, 2) and np.isfinite(eld).all()
dec = aacjax_torch.AACDecoder(device="cpu")
dec.feed(loas)
assert dec.read_chunk().shape == (2 * 512,)
# HE-AAC v1: the batched SBR program, and the streaming decoder's SBR path
he = TI.he_stream(4, ch=2)
pcm, rate = aacjax_torch.decode_adts(he, chunk_frames=2, device="cpu")
assert rate == 44100 and pcm.shape == (5 * 2048, 2)
assert np.isfinite(pcm).all() and np.abs(pcm).max() > 0.1
dec = aacjax_torch.AACDecoder(device="cpu")
dec.feed(he)
assert dec.read_chunk().shape == (2 * 2048,) and dec.output_sample_rate == 44100
# HE-AAC v2: the SBR + PS program (a mono stream decoded as stereo)
pcm, rate = aacjax_torch.decode_adts(TI.he_ps_stream(3), chunk_frames=2,
                                     device="cpu")
assert rate == 44100 and pcm.shape[1] == 2 and np.isfinite(pcm).all()
assert np.abs(pcm[:, 0] - pcm[:, 1]).max() > 0.01
# the batched encoder, an .m4a and a ranged read
from aacjax_torch.testing.encoder import adts_frame
enc_b = aacjax_torch.BatchEncoder(44100, 2, 128_000, n_streams=2,
                                  device="cpu")
chunks = list(enc_b.encode_pipelined(iter([np.stack([pcm[:4096] * 32768] * 2)])))
stream = b"".join(adts_frame(p, enc_b.config) for p in chunks[0][1])
out, rate = aacjax_torch.decode_adts(stream, device="cpu")
assert out.shape == (4096, 2) and np.isfinite(out).all()
m4a = aacjax_torch.encode_m4a(pcm[:4096] * 32768, 44100)
out, rate = aacjax_torch.decode_m4a(m4a, device="cpu")
assert out.shape == (4096, 2)
f = aacjax_torch.AACFile(m4a, device="cpu")
assert np.array_equal(f.read(1000, 500), out[1000:1500])
# the mesh: decode_pipelined on a 2x1 mesh of the CPU, as unsharded
import torch
from aacjax_torch.runtime import mesh as meshlib
from aacjax_torch.testing.streams import make_lc_payload_chunks
configs, chunks = make_lc_payload_chunks(n_streams=2, chunk_frames=4,
                                         n_chunks=2, seed=3)
outs = []
for mesh in (None, meshlib.make_mesh(2, 1, devices=[torch.device("cpu")] * 2)):
    d = aacjax_torch.BatchDecoder(configs, chunk_frames=4, device="cpu")
    outs.append(list(d.decode_pipelined(iter(chunks), out_int16=True,
                                        mesh=mesh)))
for a, b in zip(*outs):
    assert np.abs(a.astype(np.int32) - b).max() <= 1
loaded = sorted(k for k in sys.modules if k == "aacjax" or k.startswith("aacjax."))
assert loaded == [], loaded
print("ok", round(snr, 1))
"""


def test_decodes_with_jax_unimportable():
    """Import, encode and decode on the CPU with JAX unimportable; no
    module of the `aacjax` package is loaded at the end."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_DECODE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def _imported_modules(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "aacjax", "bench")


def test_no_file_imports_jax():
    """An AST scan of every module of the port, scripts/kernel_times.py and
    the card tests: no import of jax, aacjax or bench, at any depth of a file."""
    files = sorted((REPO / "aacjax_torch").rglob("*.py"))
    files += [REPO / "scripts" / "kernel_times.py", REPO / "tests" / "test_torch_cuda.py"]
    assert len(files) > 20
    offenders = {str(p.relative_to(REPO)): sorted(filter(_forbidden, names))
                 for p in files
                 if any(map(_forbidden, names := _imported_modules(p)))}
    assert offenders == {}


def test_scan_finds_nested_imports(tmp_path):
    """The scan sees imports inside functions, and tells `aacjax_torch`
    from `aacjax`."""
    src = tmp_path / "m.py"
    src.write_text("import aacjax_torch\nfrom aacjax_torch.host import adts\n"
                   "def f():\n    from aacjax.host import native\n"
                   "    import jax.numpy\n    import bench\n")
    got = sorted(filter(_forbidden, _imported_modules(src)))
    assert got == ["aacjax.host", "bench", "jax.numpy"]


_IMPORT_LINE = re.compile(r"^(\s*)(from|import) aacjax(?=[. ])", re.MULTILINE)


def _top_level(source: str) -> list[tuple[str | None, str]]:
    """(name or None, source text) of each top-level statement, in order;
    the module's docstring is named `__doc__`."""
    out = []
    for i, node in enumerate(ast.parse(source).body):
        name = getattr(node, "name", None)
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
        if (i == 0 and isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Constant)):
            name = "__doc__"
        out.append((name, ast.get_source_segment(source, node)))
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_port_copy_matches_original(rel):
    """Each copied host module is the original with `aacjax` renamed to
    `aacjax_torch` on its import lines, and nothing else changed; in a
    FORKED module, the named definitions may differ and everything else is
    the original's, in its order; data files are byte-equal."""
    orig, copy = REPO / "aacjax" / rel, REPO / "aacjax_torch" / rel
    if rel.endswith(".py"):
        want = _IMPORT_LINE.sub(r"\1\2 aacjax_torch", orig.read_text())
        if rel not in FORKED:
            assert copy.read_text() == want
            return
        forked = FORKED[rel]
        got, want = _top_level(copy.read_text()), _top_level(want)
        assert [n for n, _ in got] == [n for n, _ in want]
        assert forked <= {n for n, _ in want}
        for (name, g), (_, w) in zip(got, want):
            if name not in forked:
                assert g == w, name
    else:
        assert copy.read_bytes() == orig.read_bytes()


def test_qmf_numpy_helpers_match_reference():
    """The port's QMF module keeps the reference's numpy constants value for
    value: its copy of host/sbr_decode.py reads them."""
    from aacjax.kernels import qmf as jq
    from aacjax_torch.kernels import qmf as tq
    for name in ("prototype", "_analysis_consts", "_analysis_device_consts",
                 "_synthesis_consts"):
        got, want = getattr(tq, name)(), getattr(jq, name)()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), name
    for name in ("ANA_BANDS", "SYN_BANDS", "ANA_HIST", "SYN_HIST"):
        assert getattr(tq, name) == getattr(jq, name), name


def test_make_corpus_matches_bench():
    """The port's corpus is the reference's headline corpus, byte for
    byte (same seeds, same arithmetic, same encoder)."""
    import bench
    from aacjax_torch.testing import make_corpus
    cfg, streams = make_corpus(2, 0.2)
    want_cfg, want = bench.make_corpus(2, 0.2)
    assert (cfg.profile, cfg.sample_rate, cfg.channels) == (
        want_cfg.profile, want_cfg.sample_rate, want_cfg.channels)
    assert len(streams) == 2 and streams == want


def test_kernel_modules_import_without_toolchain():
    """Importing the kernel modules builds nothing and needs no triton."""
    code = ("import sys, aacjax_torch.kernels.tail, aacjax_torch.kernels.synth,"
            " aacjax_torch.kernels.tns, aacjax_torch.kernels.pred,"
            " aacjax_torch.kernels.ps_decorr, aacjax_torch.kernels.ps_batch\n"
            "from aacjax_torch.kernels import _build\n"
            "assert _build.lib.cache_info().currsize == 0\n"
            "assert 'triton' not in sys.modules\n"
            "print('ok')")
    env = dict(os.environ, PATH="/nonexistent")   # no nvcc, no make
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_cuda_request_without_cuda_raises(monkeypatch):
    from aacjax_torch.host.asc import make_asc, parse_asc
    import aacjax_torch
    from aacjax_torch.testing import tns_short_adts

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = parse_asc(make_asc(2, 4, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aacjax_torch.BatchDecoder([cfg])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aacjax_torch.decode_adts(tns_short_adts(2))
