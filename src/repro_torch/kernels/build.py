"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use, into ``build/kernels-<hash>/`` at the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides the root), keyed by a hash of the
sources and flags, so an edited source never loads a stale library.  All
sources compile in parallel, one ``nvcc`` process each.  A failed build
raises: nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("gather_distance", "beam_hop", "topk_score", "quant_gather")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures of the entry points, (name, argtypes)
SIGNATURES = {
    "gather_distance": [
        ("gather_distance_launch", [_P] * 5 + [_I] * 5 + [_P]),
        ("gather_one_launch", [_P] * 5 + [_I] * 5 + [_P]),
    ],
    "beam_hop": [
        ("beam_hop_launch", [_P] * 17 + [_I] * 9 + [_P]),
        ("beam_hop_q_launch", [_P] * 18 + [_I] * 9 + [_P]),
    ],
    "topk_score": [
        ("topk_score_launch", [_P] * 9 + [_I] * 5 + [_P]),
        ("topk_n_chunks", [_I] * 3),
    ],
    "quant_gather": [
        ("quant_gather_launch", [_P] * 6 + [_I] * 8 + [_P]),
    ],
}

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_SECONDS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_dir() -> Path:
    root = os.environ.get("REPRO_TORCH_BUILD_DIR")
    base = Path(root) if root else CSRC.parents[2] / "build"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return base / f"kernels-{h.hexdigest()[:16]}"


def build_all() -> dict:
    """Compile every missing library (in parallel) and load all of them.
    Returns ``{source: ctypes.CDLL}``.  Raises on any build failure."""
    with _LOCK:
        if len(_LIBS) == len(SOURCES):
            return _LIBS
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for name in SOURCES:
            so = out / f"lib{name}.so"
            if so.exists():
                continue
            tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
            log = open(out / f"{name}.log", "w")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT),
                           tmp, so, log)
        failed = []
        for name, (proc, tmp, so, log) in procs.items():
            rc = proc.wait()
            log.close()
            BUILD_SECONDS[name] = time.perf_counter() - t0
            if rc != 0:
                failed.append(name)
                continue
            os.replace(tmp, so)
        if failed:
            logs = "\n".join(
                (out / f"{n}.log").read_text()[-4000:] for n in failed
            )
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
        for name in SOURCES:
            lib = ctypes.CDLL(str(out / f"lib{name}.so"))
            for fn, argtypes in SIGNATURES[name]:
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS


def build_variant(name: str, defines, source=None, includes=(),
                  signatures=None) -> ctypes.CDLL:
    """A diagnostic build with extra ``-D`` macros, beside the regular
    libraries (nothing on the port's path loads it): of ``csrc/<name>.cu``,
    or of another version of it at ``source`` (its library name then
    carries a hash of that file and of the headers it can include).
    ``includes`` are searched before ``csrc/``; ``signatures`` replace
    ``SIGNATURES[name]`` for a source whose entry points differ.  Raises on
    a failed build."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    src = Path(source) if source is not None else CSRC / f"{name}.cu"
    tag = "-".join(d.lower() for d in defines)
    if source is not None:
        h = hashlib.sha256(src.read_bytes())
        for d in includes:  # csrc/'s headers are in build_dir()'s hash
            for header in sorted(Path(d).glob("*.cuh")):
                h.update(header.name.encode() + header.read_bytes())
        tag += "-" + h.hexdigest()[:12]
    so = out / f"lib{name}-{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        inc = [a for d in (*includes, CSRC) for a in ("-I", str(d))]
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), *inc,
             "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so.name}:\n"
                               f"{(proc.stdout + proc.stderr)[-4000:]}")
        os.replace(tmp, so)
    out_lib = ctypes.CDLL(str(so))
    for fn, argtypes in signatures or SIGNATURES[name]:
        f = getattr(out_lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return out_lib


def lib(name: str):
    """The loaded library for one source, building all of them on first
    use."""
    return build_all()[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the wrappers then take the
    plain version); False when all lie on one CUDA device; raises on a mix
    or on any other device."""
    devs = {t.device for t in tensors if t is not None}
    if {d.type for d in devs} == {"cpu"}:
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(
            f"tensors must lie all on the CPU or all on one CUDA device, "
            f"got {sorted(str(d) for d in devs)}"
        )
    return False


def require_cuda(*tensors) -> None:
    """Raise unless every tensor is a contiguous tensor on one CUDA device."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(
            f"the CUDA kernels need all tensors on one CUDA device, got "
            f"{sorted(str(d) for d in devs)}"
        )
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("the CUDA kernels need contiguous tensors")


def require_dtype(t, dtype, what: str) -> None:
    if t is not None and t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def ptxas_report() -> str:
    """The ``-Xptxas -v`` lines of the last build (each function, its
    registers and spills)."""
    out = build_dir()
    lines = []
    for name in SOURCES:
        p = out / f"{name}.log"
        if p.exists():
            lines += [ln for ln in p.read_text().splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Function properties" in ln]
    return "\n".join(lines)


def ptxas_spills() -> dict:
    """``{mangled function name: spill bytes (stores + loads)}`` from the
    last build's ``-Xptxas -v`` report."""
    spills, fn = {}, None
    for ln in ptxas_report().splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for")[1].strip()
        elif "spill stores" in ln and fn is not None:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            spills[fn] = nums[1] + nums[2]   # stack, stores, loads
            fn = None
    return spills
