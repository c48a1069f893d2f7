"""Builds the port's CUDA kernels with nvcc and loads them through ctypes.

Every `csrc/*.cu` file is compiled by hand, one nvcc per source and all of
them at once, then linked into one shared library with a plain C interface
(no PyTorch headers: such a file builds in seconds, one that includes them
in minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -c -o <name>.o lc3jax_torch/csrc/<name>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/lc3jax_torch/liblc3jax_torch_<hash>.so *.o

`--fmad=false` keeps every float multiply and add separately rounded, so the
TNS, LTPF and SNS kernels equal their plain PyTorch versions bit for bit
(eager PyTorch rounds once per op and never contracts to fma).

The library is built at first use into `build/lc3jax_torch/` at the repo
root, keyed by a hash of the sources and the flags, so an edited source
rebuilds and an unchanged one loads at once. Sources come from this checkout
only; nothing is fetched. A missing `nvcc` or a failed build raises: there
is no fallback for a CUDA tensor.

Each C entry point launches on the stream it is given, allocates nothing and
returns `cudaGetLastError()`; `check` turns a non-zero code into an error.
Pointers and the stream are passed as `ctypes.c_void_p`, ints as `c_int`.

The nvcc run and the library's load are the process's set-up spans
`kernels.build` and `kernels.load` (`metrics.process_spans`).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "lc3jax_torch"
CUDA_DEFAULT = Path("/usr/local/cuda")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C signatures: name -> argtypes (every entry returns int, a cudaError_t)
SIGNATURES = {
    "lc3t_tns_synthesis": [_PTR] * 7 + [_INT] * 2 + [_PTR],
    "lc3t_ltpf_both_passes": [_PTR] * 13 + [_INT] * 7 + [_PTR],
    "lc3t_parse": [_PTR] * 4 + [_INT] * 5 + [_PTR],
    "lc3t_sns_pvq": [_PTR] * 8 + [_INT] + [_PTR],
    "lc3t_tns_coefficients": [_PTR] * 13 + [_INT] * 3 + [_PTR],
    "lc3t_tns_analysis": [_PTR] * 6 + [_INT] * 2 + [_PTR],
    "lc3t_bitmodel": [_PTR] * 7 + [_INT] * 3 + [_PTR],
    "lc3t_pack": [_PTR] * 6 + [_INT] * 5 + [_PTR],
}

_lib = None
build_seconds: float | None = None  # the last kernels.build span, s (None: cached)


def find_nvcc() -> str | None:
    """nvcc from PATH, then $CUDA_HOME/bin, then the default toolkit."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), CUDA_DEFAULT):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"liblc3jax_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu if the hashed library is missing; return its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "lc3jax_torch: nvcc not found (PATH, $CUDA_HOME/bin, "
            f"{CUDA_DEFAULT}/bin); the CUDA kernels cannot be built, and a "
            "CUDA tensor has no plain fallback"
        )
    from .metrics import process_span

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [out.with_name(f"{out.stem}.{src.stem}.{os.getpid()}.o")
            for src in sorted(CSRC.glob("*.cu"))]
    with process_span("kernels.build") as built:
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                    for o, src in zip(objs, sorted(CSRC.glob("*.cu")))]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in compiles]
        results = [(cmd, p.communicate()[0], p.returncode) for cmd, p in zip(compiles, procs)]
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        if all(rc == 0 for _, _, rc in results):
            res = subprocess.run(link, capture_output=True, text=True)
            results.append((link, res.stdout + res.stderr, res.returncode))
    for o in objs:
        o.unlink(missing_ok=True)
    for cmd, text, rc in results:
        if rc != 0:
            raise RuntimeError(
                f"lc3jax_torch: nvcc failed with code {rc}:\n{' '.join(cmd)}\n{text}"
            )
    os.replace(tmp, out)
    build_seconds = built.span.ms / 1e3
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        from .metrics import process_span

        path = build()
        with process_span("kernels.load"):
            L = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(L, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            L.lc3t_error_string.argtypes = [ctypes.c_int]
            L.lc3t_error_string.restype = ctypes.c_char_p
        _lib = L
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        msg = lib().lc3t_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}: {msg})")


# kernel launches since the last reset, by C entry name, and by
# "name:tag" for a launch made with a tag; the one launch counter of the
# port, counted here and nowhere else (compiled.py adds a replayed graph's
# captured launches, which run no wrapper)
launches: collections.Counter = collections.Counter()


def launch(name: str, index: int, *args, tag: str | None = None) -> None:
    """Call the C entry `name` with `args` and the raw handle of the current
    stream of CUDA device `index`, made the current device around the call
    only when it is not; raise on a non-zero code, else count the launch in
    `launches` (under `name`, and under "name:tag" too where a tag is given).

    Kept to a few C calls (no Stream object, no device context on the usual
    path): for a kernel of a few microseconds this host work is most of what
    a caller waits for."""
    import torch

    fn = getattr(lib(), name)
    if index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        check(err, name)
    launches[name] += 1
    if tag is not None:
        launches[f"{name}:{tag}"] += 1


def record_on_stream(event, device) -> None:
    """Record `event` on the current stream of CUDA `device`: the stream on
    which a copy to that device, queued just before, runs (the host
    parser's ring waits on it, coding/host_parse.py). With `launch`, `fork`
    and `edge`, the one place outside the kernels that names a stream."""
    import torch

    event.record(torch.cuda.current_stream(device))


def fork(device, stream=None):
    """`stream` (a new stream on CUDA `device` when None), made to wait for
    the work queued so far on the device's current stream, and returned:
    the stream on which compiled.py warms a step up and captures it."""
    import torch

    if stream is None:
        stream = torch.cuda.Stream(device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def edge(index: int) -> None:
    """Launch the empty kernel of torch.cuda._sleep(0) on the current stream
    of CUDA device `index`: the edge of a profiling.py range. It is no
    kernel of the port, so `launches` does not count it."""
    import torch

    with torch.cuda.stream(torch.cuda.current_stream(index)):
        torch.cuda._sleep(0)
