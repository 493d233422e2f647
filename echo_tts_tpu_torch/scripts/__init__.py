"""Command-line entry points of the port (counterparts of the JAX package's
scripts/), run as `python -m echo_tts_tpu_torch.scripts.<name>`."""
