"""Faults planted under the timed path, for the output check's tests: each
is `tamper(decoder, serve) -> serve` (portbench.run.run_cell)."""
from __future__ import annotations


def state_unchanged(dec, serve):
    """Every step returns the carried state as it found it: the overlap
    (and the SBR programs' state) never advance."""
    for attr, state in (("_device_step", "_ov"),
                        ("_sbr_dispatch", "_sbr_dev")):
        step = getattr(dec, attr)

        def stuck(*args, _step=step, _state=state, **kw):
            before = getattr(dec, _state, None)
            out = _step(*args, **kw)
            setattr(dec, _state, before)
            return out
        setattr(dec, attr, stuck)
    return serve


def half_batch(dec, serve):
    """The second half of the slots is left out of every chunk's PCM."""
    ch = dec.C // len(dec.streams)

    def served(d, chunks):
        for pcm in serve(d, chunks):
            pcm[(len(d.streams) // 2) * ch:] = 0
            yield pcm
    return served


def answer_altered(dec, serve):
    """Every chunk's PCM is altered where it is produced: every 97th sample
    of every row moves by 64 steps."""
    def served(d, chunks):
        for pcm in serve(d, chunks):
            flat = pcm.reshape(pcm.shape[0], -1)
            flat[:, ::97] += 64
            yield pcm
    return served


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
