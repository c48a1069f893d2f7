"""lc3jax_torch: the LC3 batched decoder in PyTorch, with CUDA kernels.

A port of the `lc3jax` package (JAX on a TPU) to PyTorch on an NVIDIA H100.
This slice runs the fused bytes -> PCM decode of
`lc3jax.serving.BatchDecoder(device_parse=True)`:

- `coding.device.device_parse`: the range decoder (kernel `csrc/parse.cu`);
- `dsp.decoder.decode_step`: residual, noise fill, global gain, TNS (kernel
  `csrc/tns_synthesis.cu`), SNS, PLC, the IMDCT matmul, the LTPF (kernel
  `csrc/ltpf.cu`) and output scaling;
- `serving.BatchDecoder`, the entry point.

Every kernel has a plain PyTorch version beside it; a wrapper takes it only
for a tensor on the CPU, and for a CUDA tensor launches the kernel or
raises. Kernels are built with nvcc at first use (`_build.py`).

The package imports torch and never jax. It reuses, without copying, the
framework-free numpy modules of `lc3jax`: `lc3jax.config`, `lc3jax.tables`
(with `data/tables.npz`), `lc3jax.dsp.params.decoder_params`, `lc3jax.ref`
(`ref.fp.powf` for the global-gain table) and `lc3jax.metrics`. None of
them imports jax: `lc3jax/__init__.py` imports only `config`, and
`lc3jax/dsp/__init__.py` is a docstring.
"""

from lc3jax.config import FrameDuration, Lc3Config

__all__ = ["FrameDuration", "Lc3Config"]
