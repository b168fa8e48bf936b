"""Examples on aacjax_torch, run as `python -m aacjax_torch.examples.<name>`:
player, serving, serving_async, transcode."""
