"""The port's host layer: copies of `aacjax/host` modules (and, beside
them, `aacjax_torch.tables`, `kernels.windows`, `runtime.pack` and the
`testing` encoders), identical to the originals except for their import
lines, which name `aacjax_torch`.  The port imports nothing of `aacjax`;
`tests/test_torch_no_jax.py` holds the copies to the originals."""
