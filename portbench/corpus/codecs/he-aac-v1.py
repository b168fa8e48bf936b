"""HE-AAC v1 by the repo's `HEAACEncoder`: stereo PCM in, a stereo AAC-LC
core at half the rate with SBR, two coded channels."""
CODED_CHANNELS = 2


def encode(pcm, job: dict) -> bytes:
    from aacjax_torch.encode_he import HEAACEncoder
    return HEAACEncoder(job["sample_rate"], 2, job["bitrate"]).encode(pcm)
