"""Runner layer: WAV I/O and the file-to-file CLI (port of lc3jax/runner)."""
