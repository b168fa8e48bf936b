"""The port's graft entry points (aacjax_torch/graft_entry.py) on the CPU:
entry's decode step against aacjax's `__graft_entry__.entry` on the same
frames, the factoring of the dry run's mesh, and dryrun_multichip over an
8-shard CPU mesh (no subprocess: the port picks no backend at start)."""
import numpy as np
import pytest
import torch

from aacjax_torch import graft_entry as G
from aacjax_torch.testing import assert_pcm_close

CPU = torch.device("cpu")


def test_entry_matches_reference_entry():
    import jax

    import __graft_entry__ as graft
    fn, args = G.entry("cpu")
    pcm, ov = fn(*args)
    assert pcm.shape == (4, 4, 1024) and bool(torch.isfinite(pcm).all())
    jfn, jargs = graft.entry()
    want, want_ov = jax.jit(jfn)(*jargs)
    assert_pcm_close(pcm, np.asarray(want), False, "entry pcm")
    want_ov = np.asarray(want_ov)
    scale = max(1.0, float(np.abs(want_ov).max()))
    assert float(np.abs(ov.numpy() - want_ov).max()) <= 5e-5 * scale


def test_entry_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: entry() would use it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.entry()


@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (2, (2, 1)), (3, (3, 1)),
                                     (4, (2, 2)), (6, (3, 2)), (8, (4, 2)),
                                     (9, (3, 3)), (12, (6, 2))])
def test_dryrun_factors_as_the_reference(n, shape):
    assert G._factor(n) == shape


def test_dryrun_multichip_on_eight_cpu_shards():
    lines = G.dryrun_multichip(8, devices=[CPU] * 8)
    text = "\n".join(lines)
    print(text)
    assert lines[0].startswith("mesh 4x2")
    for path in ("decode_step pcm", "decode_spec_step", "HE-AAC core+SBR",
                 "encode_pipelined", "HE-AAC v2 SBR+PS"):
        assert path in text, path


def test_dryrun_refuses_fewer_devices_than_shards():
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        G.dryrun_multichip(4, devices=[CPU] * 2)
