"""HE-AAC v2 by the repo's `HEAACEncoder` with Parametric Stereo: stereo
PCM in, a mono AAC-LC core at half the rate with SBR, the stereo image in
the SBR extension's ps_data; one coded channel."""
CODED_CHANNELS = 1


def encode(pcm, job: dict) -> bytes:
    from aacjax_torch.encode_he import HEAACEncoder
    return HEAACEncoder(job["sample_rate"], 2, job["bitrate"],
                        ps=True).encode(pcm)
