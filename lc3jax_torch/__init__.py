"""lc3jax_torch: the LC3 batched decoder and encoder in PyTorch, with CUDA
kernels.

A port of the `lc3jax` package (JAX on a TPU) to PyTorch on an NVIDIA H100.
These paths run on the card:

- decode, raw frame bytes -> PCM (`serving.BatchDecoder`, the fused mode of
  `lc3jax.serving.BatchDecoder(device_parse=True)`): the range decoder
  (kernel `csrc/parse.cu`), the spectral DSP, TNS (kernel
  `csrc/tns_synthesis.cu`), SNS, PLC, the IMDCT matmul, the LTPF (kernel
  `csrc/ltpf.cu`);
- encode, PCM -> fields -> bytes (`serving.BatchEncoder`, the host-pack
  mode of `lc3jax.serving.BatchEncoder`): `dsp.encoder.encode_step` on the
  card, with the SNS PVQ search (`csrc/sns_pvq.cu`), the TNS
  coefficients (autocorrelation to quantised reflection coefficients and
  bits, `csrc/tns_coefficients.cu`) and analysis lattice
  (`csrc/tns_analysis.cu`) and the bit model (`csrc/bitmodel.cu`) as
  kernels, then the repo's C++ packer on the host (`coding.host_pack`);
- encode, PCM -> bytes on the card (`serving.BatchEncoder(device_pack=True)`,
  the fused mode of `lc3jax.serving.BatchEncoder`): the same step with the
  bit model's `emit_pack` rows, then the range encoder and bit writer
  (kernel `csrc/pack.cu`, `coding.pack_kernel`).

`dsp.streaming` loops any of the four steps over a leading frame axis.

Around them, the stream and file entry points of `lc3jax`:

- `serving.BatchDecoder(device_parse=False)`: the repo's C++ parser on the
  host (`coding.host_parse`, bound beside the packer), the fields copied to
  the card, then `dsp.decoder.decode_step` (TNS synthesis and LTPF
  kernels); `lc3jax`'s default mode;
- `BatchDecoder.decode_stream`: host parse sequential or pipelined (a
  prefetch thread), device parse with the PCM fetched or left on the card,
  and `chunk_frames=T` over `dsp.streaming.decode_bytes_frames`;
- `checkpoint.save_state` / `load_state`: decoder and encoder state in
  `lc3jax`'s `.npz` format, restored onto any device;
- `runner.cli` (`python -m lc3jax_torch.runner.cli`): encode, decode,
  compare and inspect `.lc3` files, with its own `runner.wav`.

Every step runs compiled (`compiled`, the counterpart of lc3jax's
`jax.jit(..., donate_argnums=(0,))`): one CUDA graph per step, argument
shapes and live stream, captured at its first call and replayed after
that, each stream's state updated in place in static buffers of its own
(`dsp.decoder.make_decode_step`, `dsp.encoder.make_encode_step`,
`coding.device.make_decode_bytes_step`, `dsp.streaming.make_*_frames`,
the serving step caches, the sharded steps); on the CPU the same plumbing
calls the step eagerly.

`api` is the reference-parity facade of `lc3jax.api`: `Lc3Encoder` /
`Lc3Decoder` with per-channel `encode_frame` / `decode_frame` (one serving
coder at S = 1 a channel) and the reference's buffer calculators.

Beyond one card, and around every path:

- `parallel`: the stream axis sharded over a mesh of devices (each step
  run once per shard, no cross-shard operation) and over processes
  (`init_multihost`: one process per card, the way to scale out), as
  `lc3jax.parallel` shards it over a device mesh;
- `profiling`: a step's device busy time and a loop's device span from
  `torch.profiler`, a trace and a host wall timer (`lc3jax.profiling`).

Every kernel has a plain PyTorch version beside it; a wrapper takes it only
for a tensor on the CPU, and for a CUDA tensor launches the kernel or
raises. Kernels are built with nvcc at first use (`_build.py`). The entry
points run on the card unless the caller passes `device="cpu"`.

The package imports torch and never jax, nor anything of `lc3jax`: it keeps
its own copies of the configuration (`config.py`), the spec tables
(`tables.py`, `data/tables.npz`), the decoder constants (`dsp/params.py`),
the f32 helpers (`fp.py`), glibc's exp2f table (`data/exp2f.npz`), the
serving counters (`metrics.py`) and the WAV reader and writer
(`runner/wav.py`).
"""

from .config import FrameDuration, Lc3Config, SamplingFrequency

__all__ = ["FrameDuration", "Lc3Config", "SamplingFrequency"]
