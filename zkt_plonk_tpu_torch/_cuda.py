"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into a shared
library with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``)
under ``build/torch_kernels/`` at the repository root, at first use; all
sources build in parallel.  The libraries are loaded with ``ctypes``.
Nothing here runs at import time.

``launches`` holds one plain integer per kernel instance (``INSTANCES``):
a wrapper adds one to the instance it launches, where it launches it, and
nowhere else, through ``count``, which holds a lock so that the counts
stay exact when several threads launch at once (``parallel.BatchProver``).  An instance is a kernel at one limb count and reduction
mode: ``ec_add_complete`` is K4 at L = 16, ``ec_add_complete/L24`` K4 at
L = 24 (the BLS12 base fields), ``ntt_col_pass/strict`` K3 in its strict
mode (``reduction_consts``), ``fp_pow_chain/L24`` K2 at L = 24.

``work`` counts, beside the launches and under the same lock, the work
that a kernel's caller asks of it, computed from the call's arguments
whatever implements it: ``ec_bucket_adds``, the B x n x W bucket adds of
each ``ops/msm.bucket_accumulate`` call (B scalar vectors of W windows over
n points, before padding), and ``msm_digit_codes``, the B x W x n_pad
int16 codes of each ``ops/msm.digit_rows`` call (padding included), and
``ec_merge_adds``, the (G - 1) x BW x (K - 1) complete adds of each
``ops/msm.bucket_merge`` call (G groups of BW rows of K buckets, row
k = 0 never summed), on the card and in the plain version alike.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from functools import lru_cache
from typing import Dict

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

KERNELS = (
    "fp_binop", "fp_pow_chain", "ntt_col_pass", "ec_add_complete", "ec_bucket_accumulate",
    "msm_digits", "ec_bucket_merge",
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# the instances beyond each kernel's L = 16 lazy one
EXTRA_INSTANCES = (
    "fp_binop/L24", "fp_pow_chain/L24", "fp_pow_chain/strict", "ntt_col_pass/strict",
    "ec_add_complete/L24", "ec_bucket_accumulate/L24", "ec_bucket_merge/L24",
)
INSTANCES = KERNELS + EXTRA_INSTANCES

launches: Dict[str, int] = {name: 0 for name in INSTANCES}
work: Dict[str, int] = {"ec_bucket_adds": 0, "msm_digit_codes": 0, "ec_merge_adds": 0}

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def count(name: str) -> None:
    """Add one launch of instance ``name`` (from ``instance``)."""
    with _count_lock:
        launches[name] += 1


def count_work(name: str, k: int) -> None:
    """Add ``k`` to the work counter ``name``."""
    with _count_lock:
        work[name] += k


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def instance(kernel: str, L: int = 16, strict: bool = False) -> str:
    """The launch counter of ``kernel`` at L limbs in the given mode."""
    name = kernel + ("/L24" if L == 24 else "") + ("/strict" if strict else "")
    if name not in launches:
        raise ValueError(f"{kernel} has no instance for L = {L}, strict = {strict}")
    return name


def require_cuda(device) -> "torch.device":
    """``device`` as a torch.device; raises if CUDA is asked for but absent."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, every shared
    header under ``csrc/`` and the flags, so that any edit rebuilds it."""
    h = hashlib.sha256()
    headers = sorted(fn for fn in os.listdir(CSRC_DIR) if fn.endswith(".cuh"))
    for fn in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC_DIR, fn), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all() -> float:
    """Compile every kernel that is not built yet, one nvcc per source, all
    started together.  Returns the wall time in seconds; raises with the
    compiler's output if any build fails."""
    with _lock:
        t0 = time.perf_counter()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for name in KERNELS:
            out = _lib_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.tmp{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
                f.write(log)
            if proc.returncode != 0:
                failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    cached = _libs.get(name)
    if cached is not None:
        return cached
    path = _lib_path(name)
    if not os.path.exists(path):
        build_all()
    with _lock:
        if name not in _libs:
            _libs[name] = _declare(name, ctypes.CDLL(path))
        return _libs[name]


def _declare(name: str, cdll: ctypes.CDLL) -> ctypes.CDLL:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    LLP = ctypes.POINTER(ctypes.c_longlong)
    UP = ctypes.POINTER(ctypes.c_uint)
    U16P = ctypes.POINTER(ctypes.c_ushort)
    U8P = ctypes.POINTER(ctypes.c_ubyte)
    acc = [I, P, LL, P, P, P, I, I, I, LL, I, UP, P]
    sigs = {
        "fp_binop": {"zk_fp_binop": [I, I, P, P, P, LL, I, LLP, LLP, LLP, UP, P]},
        "fp_pow_chain": {"zk_fp_pow_chain": [I, P, P, LL, I, I, I, I, U16P, U8P, I, UP, P]},
        "ntt_col_pass": {"zk_ntt_fused_pass": [I, P, P, I, LL, LL, I, I, I, I, P, P, P, I, UP, P]},
        "ec_add_complete": {"zk_ec_add_complete": [I, P, P, P, LL, I, LLP, LLP, LLP, I, UP, P]},
        "ec_bucket_accumulate": {"zk_ec_bucket_accumulate": acc},
        "msm_digits": {"zk_msm_digits": [P, P, I, LL, I, LL, I, I, P]},
        "ec_bucket_merge": {"zk_ec_bucket_merge": [I, P, P, I, I, I, I, I, UP, P]},
    }
    occ = [I, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fns = dict(sigs[name])
    for inst in OCCUPANCY_INSTANCES:
        if inst.split("/")[0] == name:
            fns[_occupancy_fn(inst)] = occ
    for fn_name, argtypes in fns.items():
        fn = getattr(cdll, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return cdll


# the instances whose libraries report their occupancy
OCCUPANCY_INSTANCES = (
    "ec_add_complete", "ec_add_complete/L24", "ec_bucket_accumulate", "ec_bucket_accumulate/L24",
    "ec_bucket_merge", "ec_bucket_merge/L24",
)


def _occupancy_fn(inst: str) -> str:
    """The library export of ``inst``'s occupancy: zk_<kernel>_occupancy(L, ...)."""
    return f"zk_{inst.split('/')[0]}_occupancy"


def occupancy(inst: str):
    """(resident blocks per SM, registers per thread) of instance ``inst``'s
    main function, from the card (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    at the kernel's block size, cudaFuncGetAttributes)."""
    blocks, regs = ctypes.c_int(), ctypes.c_int()
    L = 24 if "/L24" in inst else 16
    fn = getattr(lib(inst.split("/")[0]), _occupancy_fn(inst))
    check(fn(L, ctypes.byref(blocks), ctypes.byref(regs)), f"{inst} occupancy")
    return blocks.value, regs.value


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError_t {err}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


@lru_cache(maxsize=None)
def field_consts(spec):
    """ctypes uint32 array [p, R^2, R^4 (NW words each), -p^-1 mod 2^32,
    2p, R mod p (NW words each)].  The kernels' word arithmetic
    (``csrc/field.cuh``) needs 2p < R = 2^(32*NW)."""
    nw = spec.n_limbs // 2
    p = spec.modulus
    R = 1 << (32 * nw)
    if 2 * p >= R:
        raise ValueError(f"the CUDA field kernels need 2p < 2^{32 * nw}; p has {p.bit_length()} bits")

    def words(v):
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]

    pinv = (-pow(p, -1, 1 << 32)) % (1 << 32)
    vals = words(p) + words(R * R % p) + words(pow(R, 4, p)) + [pinv]
    vals += words(2 * p) + words(R % p)
    return (ctypes.c_uint * len(vals))(*vals)


def ec_field_consts(spec):
    """``field_consts`` for the EC kernels K4 and K4a, whose lazy reduction
    (``csrc/ec.cuh``: values in [0, 2p) inside the formula) needs 4p < R,
    and whose interleaved sums of two products (``csrc/field.cuh``,
    ``mont_row``) hold below (2^32 + 1) 5p in NW + 1 words: 5p < R with
    that margin.  It holds at L = 16 for BN254's Fq (p < 0.19 R) and at
    L = 24 for the BLS12 base fields (0.102 R and 0.007 R)."""
    bits = 16 * spec.n_limbs
    if 5 * spec.modulus * ((1 << 32) + 1) >= 1 << (bits + 32):
        raise ValueError(
            f"the EC kernels' lazy reduction needs 5p < 2^{bits}; "
            f"p has {spec.modulus.bit_length()} bits"
        )
    return field_consts(spec)


def reduction_consts(spec):
    """(strict, consts) for K2 and K3: their lazy mode (values below 2p)
    where 4p < R, else their strict mode (every value below p, every
    product and sum brought below p), which needs only 2p < R: BLS12-381's
    Fr (p = 0.453 R).  ``field_consts`` refuses a field with 2p >= R."""
    return 4 * spec.modulus >= 1 << (16 * spec.n_limbs), field_consts(spec)


def ll_array(vals):
    return (ctypes.c_longlong * max(1, len(vals)))(*vals)


def broadcast_meta(out_shape, a, b, elem_dims: int):
    """Collapse the outer (non-element) dims of ``a``/``b`` expanded to
    ``out_shape`` into at most MAXD dims of (shape, stride_a, stride_b) in
    element units.  The trailing ``elem_dims`` dims must be contiguous."""
    outer = list(out_shape[: len(out_shape) - elem_dims])
    esize = 1
    for s in out_shape[len(out_shape) - elem_dims:]:
        esize *= s
    ea = a.expand(*out_shape)
    eb = b.expand(*out_shape)
    dims = []
    for d, size in enumerate(outer):
        if size == 1:
            continue
        dims.append([size, ea.stride(d) // esize, eb.stride(d) // esize])
    merged = []
    for size, sa, sb in dims:
        if merged and merged[-1][1] == sa * size and merged[-1][2] == sb * size:
            merged[-1][0] *= size
            merged[-1][1] = sa
            merged[-1][2] = sb
        else:
            merged.append([size, sa, sb])
    if not merged:
        merged = [[1, 0, 0]]
    return merged
