"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
``sm_90a``, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, never at import, into ``build/`` at the root
of the checkout; the file name carries a hash of the sources, so an edit
rebuilds and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_uint)
# C entry points: name -> argument types; each returns a cudaError_t
SIGNATURES = {
    # the probes: mode, qkv, bias, mask, out, n_windows, N, C, num_heads,
    # mask_windows, scale, stream
    "mtlora_window_attn_fwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                               _P],
    # kernel 1: qkv, bias, mask, out, n_windows, N, C, num_heads,
    # mask_windows, group, smem, scale_c, stream
    "mtlora_window_attn_fwd_rows": [_P] * 4 + [_I] * 7 + [_F, _P],
    # kernel 1c: the same, and the resident mask tiles before smem
    "mtlora_window_attn_dense_fwd_rows": [_P] * 4 + [_I] * 8 + [_F, _P],
    # qkv, bias, mask, dout, dqkv, dbias_part, dbias, n_windows, N, C,
    # num_heads, mask_windows, group, smem, scale_c, scale, stream
    "mtlora_window_attn_bwd": [_P] * 7 + [_I] * 7 + [_F, _F, _P],
    # kernel 1c's backward: the same arguments; its group is whole cells
    "mtlora_window_attn_dense_bwd": [_P] * 7 + [_I] * 7 + [_F, _F, _P],
    # qb, kb, bias, out, nq, nH, rows, keys, stream
    "mtlora_quad_attn_fwd": [_P] * 4 + [_I] * 4 + [_P],
    # x, x_drop (null: one input), wt, at, bt, y, M, K, N, r, scale, stream
    "mtlora_lora_matmul_fwd": [_P] * 6 + [_I] * 4 + [_F, _P],
    # dy, wt, at, bt, dx, M, N, K, r, scale, stream
    "mtlora_lora_matmul_dx": [_P] * 5 + [_I] * 4 + [_F, _P],
    # kernel 7: x, ek_t, eb, mul, add, pk_t, pb, y, wpad, vec, M, cin,
    # hidden, n_out, stages, blocks, smem, stream
    "mtlora_head_mlp_fwd": [_P] * 10 + [_I] * 7 + [_P],
    # x, ek_t, eb, mul, add, pk_t, gy, dx, wpad, xpad, gypad, dhc, z, cols,
    # part, sums, dek_t, dpk_t, M, C, O, n, ng, stages, smem, sw, sp, stream
    "mtlora_head_mlp_bwd": [_P] * 18 + [_I] * 9 + [_P],
    # kernel 3: x, gamma, beta, wt, y, M, C, O, merge_wh, bm, splits,
    # blocks, stages, group, smem, stream
    "mtlora_merge_ln_fwd": [_P] * 5 + [_I] * 10 + [_P],
    # kernel 2 at the qkv sites: x, gamma, beta, wt, bias, at, bt, seed, y,
    # M, C, O, r, bm, splits, per_sm, blocks, stages, group, smem, scale,
    # drop threshold, use_drop, inv_keep, stream
    "mtlora_ln_lora_qkv_fwd": [_P] * 9 + [_I] * 11 + [_F, _U, _I, _F, _P],
    # x, gamma, beta, wt, bias, at, bt, seed, y, p, d, M, C, O, r, act, bm,
    # splits, per_sm, blocks, stages, group, smem, scale, drop threshold,
    # use_drop, inv_keep, stream
    "mtlora_ln_lora_tail_fwd": [_P] * 11 + [_I] * 12 + [_F, _U, _I, _F,
                                                         _P],
    # x, gamma, beta, wt, bias, at, bt, seed, gy, gp, gd, dx, lnd, mbuf, du,
    # gb, part, xfer, dgb, dat, dbt, M, C, O, r, act, bm, split, smem, sa,
    # sb, scale, drop threshold, use_drop, inv_keep, stream
    "mtlora_ln_lora_tail_bwd": [_P] * 21 + [_I] * 10 + [_F, _U, _I, _F, _P],
    # x, gamma, beta, wt, at, bt, seed, gy, dx, lnd, mbuf, gb, part, xfer,
    # dgb, dat, dbt, M, C, O, r, bm, split, stages, group, smem, sa, sb,
    # scale, drop threshold, use_drop, inv_keep, stream
    "mtlora_ln_lora_qkv_bwd": [_P] * 17 + [_I] * 11 + [_F, _U, _I, _F, _P],
    # x, gamma, beta, wt, gy, dx, lnd, gb, part, dgb, dwt, M, C, O,
    # merge_wh, bm, split, stages, group, smem, sw, stream
    "mtlora_merge_ln_bwd": [_P] * 11 + [_I] * 10 + [_P],
    # x, gamma, beta, w1, bias1, a1, bb1, w2, bias2, a2, bb2, seed, y,
    # M, C, H4, r, bm, smem, s1, s2, drop threshold, use_drop, inv_keep,
    # stream
    "mtlora_ln_mlp_fwd": [_P] * 13 + [_I] * 6 + [_F, _F, _U, _I, _F, _P],
    # x, gamma, beta, w1, bias1, a1, bb1, w2, a2, bb2, seed, gy, dx, lnd,
    # mbuf, hbuf, gb, part, dgb, da1, dh, dbb2, M, C, H4, r, bm, keep_w1,
    # smem, sa, sh, s1, s2, drop threshold, use_drop, inv_keep, stream
    "mtlora_ln_mlp_bwd": [_P] * 22 + [_I] * 9 + [_F, _F, _U, _I, _F, _P],
    # the probes: variant, mid1T, p1, b1, a2T, mid2T, T, M, H4, s0, s1, s2,
    # s3, stream
    "mtlora_adapter_mid_fwd": [_I] + [_P] * 5 + [_I] * 3 + [_F] * 4 + [_P],
    # kernel 5: mid1T, p1, b1, a2T, mid2T, part, T, M, H4, cols, chunks,
    # stripes, smem, s0, s1, s2, s3, stream
    "mtlora_adapter_mid_fwd_fused": [_P] * 6 + [_I] * 7 + [_F] * 4 + [_P],
    # kernel 5b: activation, mid1T, p1, b1, a2T, g, dmid1T, dp1, part, dw,
    # T, M, H4, chunks, stripes, tps, smem, s0, s1, s2, s3, stream
    "mtlora_adapter_mid_bwd": [_I] + [_P] * 9 + [_I] * 7 + [_F] * 4 + [_P],
    # kernel 6: base, pre, p2, mid, bs_cs, coef, gamma, beta, wt, y, T, B,
    # H, W, C, O, bm, splits, blocks, stages, group, smem, stream
    "mtlora_task_merge_fwd": [_P] * 10 + [_I] * 12 + [_P],
    # base, pre, p2, mid, bs_cs, coef, gamma, beta, wt, gy, lnd, gb, pbs,
    # part, dbase, dpre, dp2, dmid, dbs, dgb, dwt, T, B, H, W, C, O, split,
    # tg, stages, smem, sw, stream
    "mtlora_task_merge_bwd": [_P] * 21 + [_I] * 11 + [_P],
}

_lib = None
build_seconds = None   # wall time of the build this process ran, if any
ptxas_log = ""         # nvcc's -Xptxas -v report of that build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def library() -> ctypes.CDLL:
    """The kernels' library, built on the first call of the process."""
    global _lib, build_seconds, ptxas_log
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libmtlora_kernels_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(sources, objs)]
        outputs = [proc.communicate() for proc in procs]   # wait for all
        logs = []
        for src, proc, (stdout, stderr) in zip(sources, procs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{stdout}\n"
                                   f"{stderr}")
            logs.append(stderr)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n"
                               f"{link.stderr}")
        os.replace(tmp, out)
        for obj in objs:
            obj.unlink()
        build_seconds = time.perf_counter() - t0
        ptxas_log = "".join(logs)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
