"""AAC-LC by the repo's rate-controlled encoder (`AACEncoder`): stereo
PCM in, two coded channels, PNS and intensity stereo as the
configuration's `corpus.make` says."""
CODED_CHANNELS = 2


def encode(pcm, job: dict) -> bytes:
    from aacjax_torch.encode import AACEncoder
    return AACEncoder(job["sample_rate"], 2, job["bitrate"], pns=job["pns"],
                      intensity=job["intensity"]).encode(pcm)
