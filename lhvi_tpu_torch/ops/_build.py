"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into ONE shared library with a plain C interface,
loaded with ``ctypes``. The library lives in ``ops/_build/`` under a name
keyed by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is reused. Nothing is downloaded; a missing ``nvcc`` or a
failed build raises with the compiler's output.

Each exported C function launches one kernel on the stream it is given
and returns ``cudaGetLastError()``; :func:`check` turns a non-zero code
into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).parent / "csrc"
_BUILD = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_log = ""  # nvcc's output (ptxas register/shared-memory report)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_I64 = ctypes.c_int64
_SIGNATURES = {
    # x, p, J, h, inv_mass, eps, x_out, p_out, C, n, n_steps, layout,
    # chains, warps, smem, grid, j_smem, scratch (or null), barrier (or
    # null), stream
    "lhvi_quad_leapfrog": (_P,) * 8 + (_I,) * 9 + (_P, _P, _P),
    # x, diag, wdia, h, inv_mass, inv (or null), p0 (or null), u (or
    # null), eps, x_out, log_acc, C, n, n_emb, K, offsets (host int[K]),
    # n_steps, seed, offset, cluster, threads, chains, slice, smem, stream
    "lhvi_dia_proposal": (_P,) * 11 + (_I,) * 4 + (_P, _I, _U64, _U64)
                         + (_I,) * 5 + (_P,),
    # x, p, diag, wdia, h, inv_mass, inv (or null), eps, x_out, p_out, lp0,
    # lp1, C, n, n_emb, K, offsets (host int[K]), n_steps, cluster,
    # threads, chains, slice, smem, stream
    "lhvi_dia_leapfrog": (_P,) * 12 + (_I,) * 4 + (_P, _I) + (_I,) * 5
                         + (_P,),
    # q0, p0, J, h, inv_mass, eps, uniforms (or null), q_prop, sum_acc,
    # n_leaf, depth, diverged, scratch (or null), C, n, max_depth, seed,
    # offset, layout, slots, warps, smem, grid, k_tile, stream
    "lhvi_nuts_traj": (_P,) * 13 + (_I,) * 3 + (_U64, _U64) + (_I,) * 6
                      + (_P,),
    # grid, n, max_depth -> floats of global scratch the block layout needs
    "lhvi_nuts_traj_scratch": (_I, _I, _I),
    # log_w, lw_norm, cum, stats (step_z, ess), N, layout, cluster,
    # threads, per_thread, grid, scratch (or null), stream
    "lhvi_weight_pipeline": (_P,) * 4 + (_I,) * 6 + (_P, _P),
    # x, p, inv_mass, eps, beta, J, h, mid, is2 (null when absent),
    # tape (int4 nodes), bucket_tape, row_order, segs, color_ptr, cidx,
    # cconst, prm, w, disc values (or null), x_out, p_out, e0, e1,
    # C, n, n_rows, n_tape, n_buckets, n_segs, n_colors, acm, adm, pm,
    # max_tape, n_steps, threads, chains, stage, j_smem, smem, stream
    "lhvi_logpot_leapfrog": (_P,) * 23 + (_I,) * 17 + (_P,),
    # xc, prev, mean, m2, cross, bm_cur, bm_mean, bm_m2, then their outputs
    # mean, m2, cross, bm_cur, bm_mean, bm_m2 (null: that part skipped),
    # numel, cnt, bm_len, batch_no, vec, threads, grid, stream
    "lhvi_stream_diag": (_P,) * 14 + (_I64,) + (_I,) * 6 + (_P,),
    # xc, s1, s2, s1_out, s2_out, C, n, vec, threads, grid, stream
    "lhvi_moment_sums": (_P,) * 5 + (_I,) * 5 + (_P,),
}


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    """The cached library's path for the current sources (built if absent)."""
    global build_log
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(_CSRC.glob("*.cu*")):
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    out = _BUILD / f"liblhvi_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [_BUILD / f"{tag}.{s.stem}.o" for s in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    failed = [p.returncode for p in procs if p.returncode != 0]
    tmp = out.with_name(f"{tag}.tmp")
    if not failed:
        r = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                           capture_output=True, text=True)
        build_log += r.stdout + r.stderr
        failed = [r.returncode] if r.returncode != 0 else []
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{build_log}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(library_path()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        handle.lhvi_cuda_error_string.argtypes = [ctypes.c_int]
        handle.lhvi_cuda_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the launch geometries'
    grids are sized to fill them)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib().lhvi_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: error {code} ({msg})")
