"""Fused LayerNorm + frozen GEMM + shared LoRA, and the fused patch merge:
the CUDA kernels, their plain versions, counters.

Counterpart of ``mtlora_tpu/ops/pallas_ln_lora.py``, which holds two TPU
kernels:

  - ``fused_ln_lora_linear`` (kernel 2 and its backward 2b):
    ``y = LN(x) W + b + s (drop(LN x) A) B``; in the stage-tail mode
    (norm2 -> fc1 of the blocks with task streams: ``out_act``, ``out_p``,
    ``out_drop``) y goes through GELU and the kernel also writes the frozen
    pre-activation ``p = LN(x) W + b`` and ``dropout(y)`` on the second
    hash stream;
  - ``fused_merge_ln_linear`` (kernel 3 and 3b): the 2x2 patch merge of a
    ``[.., H, W, C]`` stream, ``LN(4C)`` and the ``4C -> 2C`` reduction,
    no bias and no LoRA, with a gradient for the reduction weight.

Kernel 2's forward is one source, ``csrc/ln_lora_tail_fwd.cu``, in two
compile-time modes: the qkv mode (y only; its plan :func:`qkv_fwd_plan`)
and the tail mode (its plan :func:`tail_fwd_plan`). Kernel 3's forward is
``csrc/merge_ln_fwd.cu``: persistent blocks that gather their merged rows
2x2 (concat order ``k = di + 2 dj``, ``merge_ln_reference`` :663-679) into
a bf16(ln) tile in shared memory and stream W through a TMA ring (its plan
:func:`merge_fwd_plan`). Kernel 3b is ``csrc/merge_ln_bwd.cu``, a row
kernel whose blocks of a cluster split the merged rows' columns (its plan
:func:`merge_bwd_plan`), then the weight product. Kernel 2b is a fused row kernel then the weight passes
of dA and dB in each mode:
``csrc/ln_lora_qkv_bwd.cu`` (y-only, the qkv sites; its plan
:func:`qkv_bwd_plan`) and ``csrc/ln_lora_tail_bwd.cu`` (the tail mode; its
plan :func:`tail_bwd_plan`), sharing ``csrc/row_block.cuh``.

Weights are passed in the port's module layouts (``nn.Linear.weight``
``wt [O, K]``, ``lora_shared_A`` ``at [r, K]``, ``lora_shared_B``
``bt [O, r]``) cast to the compute dtype, and their gradients come back in
the same layouts. ``gamma``, ``beta`` and the bias are cast to the
compute dtype too, as ``_ln_fused`` casts them. Cast points follow the TPU
kernel: LN in fp32 with ``var = E[x^2] - E[x]^2``; ``lnc`` rounded;
``p = lnc W`` in fp32 plus the bias; ``m = lnd A`` rounded, then
``u = m B`` in fp32; ``y = p + s u`` rounded once (tail mode: ``gelu(p +
s u)`` in the form that :func:`gelu_form` gives, and ``p`` rounded once).
The tail mode's backward (``csrc/ln_lora_tail_bwd.cu``) recomputes ``z =
p + s u`` and folds the cotangents of y, p and ``dropout(y)`` through
``gelu'(z)``: ``g = (gy + drop1(gd)) gelu'(z)``, ``gpt = bf16(g + gp)``
takes the place of ``gy`` in dln and ``du = bf16(s g)`` that of ``bf16(s
gy)`` (``_bwd_kernel`` :159-181).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mtlora_tpu_torch.ops import _build, dropout

EPS = 1e-5
TRAIN_W = ("kernel 2's train_w mode (the trainable reduction of a patch "
           "merge) is not ported: the port runs every merge, the reduction's "
           "gradient included, as kernel 3 (ROADMAP.md, Queue 2, kernel 2)")


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: fp32, or fp64 for fp64 inputs (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


# the tanh form of ``_gelu_fwd``/``_gelu_pair`` (``pallas_adapter_mlp.py``
# :92-115) and the sigmoid form of ``tools/adapter_variants.py`` (:42, :178)
GELU_C = 0.7978845608028654
GELU_D = 0.044715
SIG_A = 1.5957691216
SIG_B = 0.0713548163
ACT_FORMS = ("erf", "tanh", "sig", "none")


def gelu_form(cdt: torch.dtype) -> str:
    """The GELU of the kernels' sites for compute dtype ``cdt``, as the JAX
    kernels choose it (``cheap = cdt == bfloat16``): the tanh form in bf16,
    the exact erf otherwise (the JAX fp32 kernels take an
    Abramowitz-Stegun erf, 1.5e-7 from it)."""
    return "tanh" if cdt == torch.bfloat16 else "erf"


def act_pair(h, form: str):
    """``(act(h), act'(h))`` of one form of ``ACT_FORMS``: the exact-erf
    GELU, the tanh form ``0.5 h (1 + tanh(h (c + (c d) h^2)))``, the sigmoid
    form ``h sigma(h (a + b h^2))`` (an exact divide where the TPU refines
    an approximate reciprocal; at h below about -10 the TPU's Newton step
    gives NaN and this 0), or the identity."""
    if form == "erf":
        cdf = 0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))
        return h * cdf, cdf + h * torch.exp(-0.5 * h * h) * (
            1.0 / math.sqrt(2.0 * math.pi))
    h2 = h * h
    if form == "tanh":
        th = torch.tanh(h * (GELU_C + (GELU_C * GELU_D) * h2))
        return 0.5 * h * (1.0 + th), (
            0.5 * (1.0 + th) + 0.5 * h * (1.0 - th * th)
            * (GELU_C + (3.0 * GELU_C * GELU_D) * h2))
    if form == "sig":
        sg = 1.0 / (1.0 + torch.exp(-(h * (SIG_A + SIG_B * h2))))
        return h * sg, sg + h * sg * (1.0 - sg) * (SIG_A + 3 * SIG_B * h2)
    if form == "none":
        return h, torch.ones_like(h)
    raise ValueError(f"activation form {form!r} not in {ACT_FORMS}")


def gelu_pair(h, cdt: torch.dtype):
    """``(gelu(h), gelu'(h))`` in the form of compute dtype ``cdt``."""
    return act_pair(h, gelu_form(cdt))


def layer_norm_parts(x, gamma, beta):
    """``(ln, xhat, inv)`` of ``_layer_norm`` (``pallas_ln_lora.py:59``)
    in the accumulation dtype."""
    f = _acc(x.dtype)
    x32 = x.to(f)
    mu = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var + EPS)
    xhat = (x32 - mu) * inv
    return xhat * gamma.to(f) + beta.to(f), xhat, inv


def layer_norm_bwd(dln, xhat, inv, gamma):
    """``(dx, dgamma, dbeta)`` of the LayerNorm, from the cotangent of its
    output (``pallas_ln_lora.py:216-222``)."""
    dg = (dln * xhat).sum(0)
    db = dln.sum(0)
    dxhat = dln * gamma.to(dln.dtype)
    dx = inv * (dxhat - dxhat.mean(-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, dg, db


def _dropped(ln, seed, drop, stream=0):
    """``(lnd, keep)``: the dropped fp32 values and the mask, or
    ``(ln, None)`` without dropout."""
    if drop <= 0.0:
        return ln, None
    keep = dropout.keep_mask(seed, stream, ln.shape[0], ln.shape[1], drop)
    return dropout.apply(ln, keep, drop), keep


def _pre_activation(x, gamma, beta, wt, bias, at, bt, seed, scale: float,
                    drop: float):
    """``(ln, xhat, inv, lnd, keep, m, p, z)`` of kernel 2 in the
    accumulation dtype: ``p = lnc W^T + b``, ``z = p + s m B^T``; lnd and m
    rounded as the kernel rounds them (None without an adapter)."""
    cdt, f = x.dtype, _acc(x.dtype)
    ln, xhat, inv = layer_norm_parts(x, gamma, beta)
    p = ln.to(cdt).to(f) @ wt.to(f).t() + bias.to(f)
    z, lnd, keep, m = p, None, None, None
    if scale != 0.0:
        lnd, keep = _dropped(ln, seed, drop)
        lnd = lnd.to(cdt).to(f)
        m = (lnd @ at.to(f).t()).to(cdt).to(f)
        z = p + scale * (m @ bt.to(f).t())
    return ln, xhat, inv, lnd, keep, m, p, z


def ln_lora_plain(x, gamma, beta, wt, bias, at, bt, seed, scale: float,
                  drop: float):
    """y [M, O] of kernel 2 from x [M, K] (y-only mode)."""
    *_, z = _pre_activation(x, gamma, beta, wt, bias, at, bt, seed, scale,
                            drop)
    return z.to(x.dtype)


def ln_lora_tail_plain(x, gamma, beta, wt, bias, at, bt, seed, scale: float,
                       drop: float, act: bool = True, out_drop: bool = False):
    """Kernel 2's tail mode: ``(y, p, d)`` [M, O] in x's dtype with
    ``y = gelu(z)`` (``z`` itself when not ``act``; :func:`gelu_form`),
    the frozen pre-activation ``p`` and ``d = drop1(y)`` on hash stream 1 (None unless
    ``out_drop``)."""
    *_, p, z = _pre_activation(x, gamma, beta, wt, bias, at, bt, seed,
                               scale, drop)
    y = gelu_pair(z, x.dtype)[0] if act else z
    d = None
    if out_drop:
        keep = dropout.keep_mask(seed, 1, *y.shape, drop)
        d = dropout.apply(y, keep, drop).to(x.dtype)
    return y.to(x.dtype), p.to(x.dtype), d


def ln_lora_bwd_plain(x, gamma, beta, wt, bias, at, bt, seed, scale: float,
                      drop: float, gy):
    """``(dx, dgamma, dbeta, dat, dbt)`` of :func:`ln_lora_plain` with the
    cast points of ``_bwd_kernel`` (:124-222): ``gy`` rounded to the
    compute dtype for ``dln = gy W^T``, ``du = s gy`` and ``dm = du B^T``
    rounded, ``dB = m^T du``, ``dA = lnd^T dm``, the mask applied to
    ``dm A^T``. dx in x's dtype; the rest in the accumulation dtype, dat
    ``[r, K]`` and dbt ``[O, r]`` in the adapters' layouts."""
    cdt, f = x.dtype, _acc(x.dtype)
    ln, xhat, inv = layer_norm_parts(x, gamma, beta)
    gyf = gy.to(f)
    dln = gyf.to(cdt).to(f) @ wt.to(f)
    if scale != 0.0:
        lnd, keep = _dropped(ln, seed, drop)
        lnd = lnd.to(cdt).to(f)
        m = (lnd @ at.to(f).t()).to(cdt).to(f)
        du = (scale * gyf).to(cdt).to(f)
        dm = (du @ bt.to(f)).to(cdt).to(f)
        dbt = du.t() @ m
        dat = dm.t() @ lnd
        dlnd = dm @ at.to(f)
        dln = dln + (dlnd if keep is None else dropout.apply(dlnd, keep, drop))
    else:
        dat = torch.zeros(at.shape, dtype=f, device=x.device)
        dbt = torch.zeros(bt.shape, dtype=f, device=x.device)
    dx, dg, db = layer_norm_bwd(dln, xhat, inv, gamma)
    return dx.to(x.dtype), dg, db, dat, dbt


def ln_lora_bwd_rows_plain(x, gamma, beta, wt, bias, at, bt, seed,
                           scale: float, drop: float, gy):
    """What the y-only backward's row kernel stores, with the cast points
    of ``_bwd_kernel``: ``(dx, dgamma, dbeta, lnd, m, dm)``. ``du =
    bf16(s gy)``, ``dm = bf16(du B)``, ``dln = bf16(gy) W + drop0(dm A)``
    and its LayerNorm backward; the kernel draws no mask where ``scale`` is
    0 (dm is then 0). dx and the rows ``lnd = bf16(drop0(ln))`` [M, K], m,
    dm [M, r] in x's dtype, dgamma and dbeta in the accumulation dtype."""
    cdt, f = x.dtype, _acc(x.dtype)
    ln, xhat, inv = layer_norm_parts(x, gamma, beta)
    lnd, keep = _dropped(ln, seed, drop if scale != 0.0 else 0.0)
    lnd = lnd.to(cdt).to(f)
    m = (lnd @ at.to(f).t()).to(cdt).to(f)
    gyf = gy.to(f)
    du = (scale * gyf).to(cdt).to(f)
    dm = (du @ bt.to(f)).to(cdt).to(f)
    dlnd = dm @ at.to(f)
    dln = gyf.to(cdt).to(f) @ wt.to(f) + (
        dlnd if keep is None else dropout.apply(dlnd, keep, drop))
    dx, dg, db = layer_norm_bwd(dln, xhat, inv, gamma)
    return (dx.to(cdt), dg, db) + tuple(t.to(cdt) for t in (lnd, m, dm))


def ln_lora_bwd_weights_plain(lnd, m, dm, gy, scale: float):
    """``(dat, dbt)`` from the y-only row kernel's rows and gy, as the
    weight passes compute them: ``dA^T = dm^T lnd`` [r, K], ``dB^T =
    bf16(s gy)^T m`` [O, r], in the accumulation dtype."""
    f = _acc(lnd.dtype)
    du = (scale * gy.to(f)).to(gy.dtype).to(f)
    return dm.to(f).t() @ lnd.to(f), du.t() @ m.to(f)


def ln_lora_tail_bwd_rows_plain(x, gamma, beta, wt, bias, at, bt, seed,
                                scale: float, drop: float, gy, gp=None,
                                gd=None, act: bool = True):
    """What the tail mode's backward row kernel stores, with the cast
    points of ``_bwd_kernel``: ``(dx, dgamma, dbeta, lnd, m, dm, du)``.
    ``g = (gy + drop1(gd)) gelu'(z)`` (no ``gelu'`` without ``act``),
    ``gpt = bf16(g + gp)``, ``du = bf16(s g)``, ``dm = bf16(du B)``, ``dln
    = gpt W + drop0(dm A)`` and its LayerNorm backward (gp, gd may be
    None). dx and the rows ``lnd = bf16(drop0(ln))`` [M, K], m, dm [M, r]
    and du [M, O] in x's dtype, dgamma and dbeta in the accumulation
    dtype."""
    cdt, f = x.dtype, _acc(x.dtype)
    ln, xhat, inv = layer_norm_parts(x, gamma, beta)
    lnd, keep = _dropped(ln, seed, drop)
    lnd = lnd.to(cdt).to(f)
    m = (lnd @ at.to(f).t()).to(cdt).to(f)
    g = gy.to(f)
    if gd is not None:
        keep1 = dropout.keep_mask(seed, 1, *g.shape, drop)
        g = g + dropout.apply(gd.to(f), keep1, drop)
    if act:
        z = (ln.to(cdt).to(f) @ wt.to(f).t() + bias.to(f)
             + scale * (m @ bt.to(f).t()))
        g = g * gelu_pair(z, cdt)[1]
    gpt = (g if gp is None else g + gp.to(f)).to(cdt).to(f)
    du = (scale * g).to(cdt).to(f)
    dm = (du @ bt.to(f)).to(cdt).to(f)
    dlnd = dm @ at.to(f)
    dln = gpt @ wt.to(f) + (dlnd if keep is None
                            else dropout.apply(dlnd, keep, drop))
    dx, dg, db = layer_norm_bwd(dln, xhat, inv, gamma)
    return (dx.to(cdt), dg, db) + tuple(t.to(cdt) for t in (lnd, m, dm, du))


def ln_lora_tail_bwd_weights_plain(lnd, m, dm, du):
    """``(dat, dbt)`` from the row kernel's rows, as the weight passes
    compute them: ``dA^T = dm^T lnd`` [r, K], ``dB^T = du^T m`` [O, r],
    in the accumulation dtype."""
    f = _acc(lnd.dtype)
    return dm.to(f).t() @ lnd.to(f), du.to(f).t() @ m.to(f)


def ln_lora_tail_bwd_plain(x, gamma, beta, wt, bias, at, bt, seed,
                           scale: float, drop: float, gy, gp=None, gd=None,
                           act: bool = True):
    """``(dx, dgamma, dbeta, dat, dbt)`` of :func:`ln_lora_tail_plain`
    from the cotangents of y, p and d (gp, gd may be None): the rows of
    :func:`ln_lora_tail_bwd_rows_plain`, then
    :func:`ln_lora_tail_bwd_weights_plain` on them."""
    dx, dg, db, *rows = ln_lora_tail_bwd_rows_plain(
        x, gamma, beta, wt, bias, at, bt, seed, scale, drop, gy, gp, gd, act)
    return (dx, dg, db) + ln_lora_tail_bwd_weights_plain(*rows)


def merge_rows(x, H: int, W: int):
    """[L, H*W, C] -> [L*H/2*W/2, 4C] in the reference concat order
    ``[x(0,0), x(1,0), x(0,1), x(1,1)]`` (k = di + 2 dj)."""
    L, _, C = x.shape
    x = x.reshape(L, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
    return x.reshape(L * (H // 2) * (W // 2), 4 * C)


def unmerge_rows(d, L: int, H: int, W: int):
    """Inverse of :func:`merge_rows`: [L*H/2*W/2, 4C] -> [L, H*W, C]."""
    C = d.shape[1] // 4
    d = d.reshape(L, H // 2, W // 2, 2, 2, C).permute(0, 1, 4, 2, 3, 5)
    return d.reshape(L, H * W, C)


def merge_ln_plain(x, gamma, beta, wt, H: int, W: int):
    """y [L, H/2*W/2, O] of kernel 3 from x [L, H*W, C]: 2x2 merge, LN(4C)
    with ``gamma, beta [4C]`` in the reference order, ``lnc wt^T`` in fp32,
    rounded once (``merge_ln_reference``)."""
    cdt, f = x.dtype, _acc(x.dtype)
    ln, _, _ = layer_norm_parts(merge_rows(x, H, W), gamma, beta)
    y = ln.to(cdt).to(f) @ wt.to(f).t()
    return y.to(cdt).reshape(x.shape[0], (H // 2) * (W // 2), -1)


def merge_ln_bwd_plain(x, gamma, beta, wt, H: int, W: int, gy):
    """``(dx, dgamma, dbeta, dwt)`` of :func:`merge_ln_plain`
    (``_merge_bwd_kernel`` with ``train_w``): ``gp = gy`` rounded,
    ``dln = gp wt``, ``dwt = gp^T lnc``; dx [L, H*W, C] in x's dtype."""
    cdt, f = x.dtype, _acc(x.dtype)
    ln, xhat, inv = layer_norm_parts(merge_rows(x, H, W), gamma, beta)
    gp = gy.reshape(-1, gy.shape[-1]).to(cdt).to(f)
    dln = gp @ wt.to(f)
    dwt = gp.t() @ ln.to(cdt).to(f)
    dx, dg, db = layer_norm_bwd(dln, xhat, inv, gamma)
    return (unmerge_rows(dx, x.shape[0], H, W).to(x.dtype), dg, db, dwt)


def merge_ln_bwd_rows_plain(x, gamma, beta, wt, H: int, W: int, gy):
    """What kernel 3b's row kernel stores, with the cast points of
    ``_merge_bwd_kernel``: ``(dx, dgamma, dbeta, lnd)``, ``dln = bf16(gy)
    wt`` and its LayerNorm backward on the merged rows; dx [L, H*W, C] and
    the rows ``lnd = bf16(ln)`` [M, 4C] in x's dtype, dgamma and dbeta in
    the accumulation dtype."""
    cdt, f = x.dtype, _acc(x.dtype)
    ln, xhat, inv = layer_norm_parts(merge_rows(x, H, W), gamma, beta)
    gp = gy.reshape(-1, gy.shape[-1]).to(cdt).to(f)
    dx, dg, db = layer_norm_bwd(gp @ wt.to(f), xhat, inv, gamma)
    return (unmerge_rows(dx, x.shape[0], H, W).to(cdt), dg, db, ln.to(cdt))


def merge_ln_bwd_weights_plain(lnd, gy):
    """``dwt = bf16(gy)^T lnd`` [O, 4C] from the row kernel's rows and gy,
    as the weight product computes it, in the accumulation dtype."""
    f = _acc(lnd.dtype)
    gp = gy.reshape(-1, gy.shape[-1]).to(lnd.dtype).to(f)
    return gp.t() @ lnd.to(f)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def require_cuda(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")


def _check(name, x, tensors, shapes):
    require_cuda(name, x)
    for (label, t), shape in zip(tensors, shapes):
        want = torch.int32 if label == "seed" else torch.bfloat16
        if t.dtype != want or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} kernel: {label} must be {want} "
                             f"{tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} kernel: {label} must be contiguous "
                             f"and on {x.device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stripes_for(sms: int, rows: int, n: int, k: int, per_sm: int = 8) -> int:
    """Row stripes of a weight-gradient product ``[n, k]`` summed over
    ``rows`` on a card of ``sms`` SMs: about ``per_sm`` blocks of 64 x 64
    outputs per SM, and the fp32 partials at most 64 MB."""
    tiles = -(-n // 64) * -(-k // 64)
    cap = max(1, (64 << 20) // (4 * n * k))
    return max(1, min(-(-rows // 64), per_sm * sms // tiles, cap))


def wgrad_stripes(device, rows: int, n: int, k: int) -> int:
    """:func:`stripes_for` on the card of ``device``."""
    return stripes_for(_sms(device), rows, n, k)


def _kernel2_shapes(x, wt, at, bt):
    require_cuda("LN+LoRA", x)
    M, K = x.shape
    O, r = wt.shape[0], at.shape[0]
    if K % 16 or O % 8 or r % 16 or r > 64:
        raise ValueError(f"LN+LoRA kernel: needs K % 16 == 0 ({K}), O % 8 "
                         f"== 0 ({O}) and r a multiple of 16 up to 64 ({r})")
    return M, K, O, r


def _kernel2_args(name, x, gamma, beta, wt, bias, at, bt, seed, cots=()):
    """Checks of a kernel-2 launch (either mode, forward or backward); the
    operands' pointers."""
    M, K, O, r = _kernel2_shapes(x, wt, at, bt)
    _check(name, x,
           [("x", x), ("gamma", gamma), ("beta", beta), ("wt", wt),
            ("bias", bias), ("at", at), ("bt", bt), ("seed", seed)]
           + [(n, c) for n, c in cots if c is not None],
           [(M, K), (K,), (K,), (O, K), (O,), (r, K), (O, r), (2,)]
           + [(M, O) for _, c in cots if c is not None])
    return [t.data_ptr() for t in (x, gamma, beta, wt, bias, at, bt, seed)]


def ln_lora_fwd_kernel(x, gamma, beta, wt, bias, at, bt, seed, scale: float,
                       drop: float):
    """The CUDA route of :func:`ln_lora_fwd`: the qkv mode of
    ``csrc/ln_lora_tail_fwd.cu`` at the launch of :func:`qkv_fwd_plan`;
    raises for anything it does not take (a CPU tensor included)."""
    ptrs = _kernel2_args("LN+LoRA forward", x, gamma, beta, wt, bias, at,
                         bt, seed)
    M, C = x.shape
    O, r = wt.shape[0], at.shape[0]
    plan = qkv_fwd_plan(M, C, O, r, _sms(x.device))
    y = torch.empty((M, O), dtype=x.dtype, device=x.device)
    use_drop = int(drop > 0.0 and scale != 0.0)
    err = _build.library().mtlora_ln_lora_qkv_fwd(
        *ptrs, y.data_ptr(), M, C, O, r, plan.bm, plan.splits, plan.per_sm,
        plan.blocks, plan.stages, plan.group, plan.smem, float(scale),
        dropout.threshold(drop) if use_drop else 0, use_drop,
        dropout.inv_keep(drop) if use_drop else 1.0, _stream(x))
    _build.check(err, "mtlora_ln_lora_qkv_fwd")
    ln_lora_fwd.launches += 1
    return y


def ln_lora_fwd(x, gamma, beta, wt, bias, at, bt, seed, scale: float,
                drop: float):
    """Kernel 2 forward, no autograd: the plain version for CPU tensors,
    :func:`ln_lora_fwd_kernel` for CUDA tensors (all bf16 but the int32
    seed)."""
    if x.device.type == "cpu":
        return ln_lora_plain(x, gamma, beta, wt, bias, at, bt, seed, scale,
                             drop)
    return ln_lora_fwd_kernel(x, gamma, beta, wt, bias, at, bt, seed, scale,
                              drop)


ROW_TILE = 16     # rows of one warp of the backward row kernels


# the constants of csrc/ln_lora_qkv_bwd.cu that its plan sizes shared
# memory by (the kernel traps if the plan's bytes do not hold its layout)
QKV_CHUNK = 64          # hidden chunk and slot width (kS)
QKV_WARPS = 8           # warps of a row block (kWarps)
QKV_TILE = QKV_CHUNK + 8     # row stride of the 64-wide tiles (kLdS)
QKV_GROUP = 4           # slots a ring group (at most kGroupMax)
QKV_MAX_STAGES = 12     # slots in the TMA ring, at most
SMEM_LIMIT = 232_448    # shared memory one block can take on the H100
SM_SMEM = 233_472       # shared memory of an SM, 1 KB of it reserved a block


class QkvBwdPlan(NamedTuple):
    """Launch plan of kernel 2b at the qkv sites (y-only): rows per block,
    hidden chunk width, the TMA ring's slots and slots a group, the blocks
    of a cluster that share a row block's hidden chunks, blocks an SM,
    dynamic shared-memory bytes of the row kernel, its row blocks, the
    bytes of weight slots they stream from L2, the row stripes of the
    weight-gradient products dA [r, C] and dB [O, r], and the scratch the
    wrapper allocates: name -> (shape, dtype)."""

    bm: int
    chunk: int
    stages: int
    group: int
    split: int
    per_sm: int
    smem: int
    blocks: int
    slice_bytes: int
    sa: int
    sb: int
    scratch: dict


def qkv_bwd_plan(M: int, C: int, O: int, r: int, sms: int) -> QkvBwdPlan:
    """Kernel 2b's plan at a qkv site, x [M, C], O = 3C hidden columns (any
    O % 16 == 0), rank r (a multiple of 16 up to 64, zero-filled to one
    64-wide slot) on a card of ``sms`` SMs. Rows a block: 64 up to C =
    192, 32 above. Up to C = 384 two blocks share an SM, each with its
    fp32 dln (rows x C) at 48 registers a thread (faster on the H100 than
    one block of twice the rows at C = 192 and 384); above, one block an
    SM, dln at 96 registers (128 at C = 1024, where 32 rows is the least).
    The last block masks the rows past M. The 32-row blocks alone on an
    SM, few (196 at C = 768, 1.5 waves of 132 SMs), split their hidden
    chunks between the two blocks of a cluster where the chunks pair up.
    The ring takes what
    shared memory leaves, in groups of 4 slots (2 where fewer than 8 fit),
    at most 12. Scratch: bf16(drop0(ln)) ``lnd`` [M, C] and the rank rows
    ``mbuf`` (m, dm) [2, M, r] in bf16; the per-block dgamma/dbeta
    partials ``gb``, the weight-gradient stripes ``part`` (dA's, then
    dB's) and, with a split, the partials ``xfer`` in fp32."""
    if (C % 32 or not QKV_CHUNK < C <= 1024 or O % 16 or not O
            or r % 16 or not 16 <= r <= 64):
        raise ValueError(f"LN+LoRA backward kernel: needs C % 32 == 0 and "
                         f"64 < C <= 1024 ({C}), O % 16 == 0 ({O}) and r a "
                         f"multiple of 16 up to 64 ({r})")
    ncs, nch = -(-C // QKV_CHUNK), -(-O // QKV_CHUNK)
    bm = 64 if C <= 192 else 32
    wn = QKV_WARPS // (bm // ROW_TILE)
    # the slices of C of the kernel's instance (the C entry's choice), and
    # two blocks an SM where its launch bounds ask for them
    inst = {32: (6, 12, 16), 64: (2, 3)}[bm]
    per_sm = 2 if bm * min(n for n in inst if n >= ncs) <= 192 else 1
    split = 2 if bm == 32 and per_sm == 1 and nch % 2 == 0 else 1
    slot = 2 * QKV_CHUNK ** 2
    # up to 1023 bytes to the ring's 1024-byte alignment; the
    # bf16(drop0(ln)) tile, the m / dm tile, the rows of x, gamma and beta;
    # mu, inv and the LayerNorm row sums; stream 0's mask bytes (the ring
    # and its mbarriers below)
    fixed = (1024 + 2 * (2 * bm * (C + 8) + bm * QKV_TILE + 2 * C)
             + 4 * (2 * bm + 2 * wn * bm) + bm * C)
    limit = min(SMEM_LIMIT, SM_SMEM // per_sm - 1024)

    def ring_bytes(stages, group):   # the slots and a mbarrier a group
        return stages * slot + 8 * (stages // group)

    group = QKV_GROUP if fixed + ring_bytes(8, QKV_GROUP) <= limit else 2
    stages = QKV_MAX_STAGES // group * group
    while stages >= 2 * group and fixed + ring_bytes(stages, group) > limit:
        stages -= group
    if stages < 2 * group:
        raise ValueError(f"LN+LoRA backward kernel: {fixed} bytes of shared "
                         f"memory at C = {C} leave no ring within {limit}")
    smem = fixed + ring_bytes(stages, group)
    # the dgamma/dbeta partials of the block's 16-row tiles in the ring
    assert (bm // ROW_TILE) * 2 * C * 4 <= stages * slot
    blocks = -(-M // bm)
    # per row block: A (m, in each block of a split), per hidden chunk B
    # and W, then A (dl); gy's boxes are not weights
    slices = (split + 1) * ncs + nch * (ncs + 1)
    sa = stripes_for(sms, M, r, C)
    sb = stripes_for(sms, M, O, r)
    bf16, f32 = torch.bfloat16, torch.float32
    scratch = {
        "lnd": ((M, C), bf16),
        "mbuf": ((2, M, r), bf16),
        "gb": ((blocks, 2, C), f32),
        "part": ((max(sa * r * C, sb * O * r),), f32),
    }
    if split == 2:
        # per row block, thread and n-tile of its dln slices and dm
        nt = QKV_CHUNK // 8 // wn
        scratch["xfer"] = ((blocks * (ncs + 1) * nt * 4 * 32 * QKV_WARPS,),
                           f32)
    return QkvBwdPlan(bm, QKV_CHUNK, stages, group, split, per_sm, smem,
                      blocks, blocks * slices * slot, sa, sb, scratch)


def qkv_bwd_scratch(plan: QkvBwdPlan, device) -> dict:
    """The scratch tensors of ``plan``, as :func:`ln_lora_bwd_kernel`
    allocates them."""
    return {name: torch.empty(shape, dtype=dt, device=device)
            for name, (shape, dt) in plan.scratch.items()}


def ln_lora_bwd_kernel(x, gamma, beta, wt, bias, at, bt, seed, scale: float,
                       drop: float, gy, scratch=None):
    """The CUDA route of :func:`ln_lora_bwd`: the fused row kernel in
    y-only mode (dx, the rows lnd, m, dm, gamma/beta partials), then the
    weight-gradient kernels of dA and dB (over gy itself) and the
    fixed-order reductions, all on the weights' module layouts; raises for
    anything it does not take (a CPU tensor included). ``scratch``: the
    tensors of :func:`qkv_bwd_scratch` to use (the row kernel leaves its
    rows there), or None to allocate them."""
    M, K, O, r = _kernel2_shapes(x, wt, at, bt)
    _check("LN+LoRA backward", x,
           [("x", x), ("gamma", gamma), ("beta", beta), ("wt", wt),
            ("at", at), ("bt", bt), ("seed", seed), ("gy", gy)],
           [(M, K), (K,), (K,), (O, K), (r, K), (O, r), (2,), (M, O)])
    plan = qkv_bwd_plan(M, K, O, r, _sms(x.device))
    sc = qkv_bwd_scratch(plan, x.device) if scratch is None else scratch
    if {k: (tuple(v.shape), v.dtype) for k, v in sc.items()} != plan.scratch:
        raise ValueError("LN+LoRA backward kernel: scratch does not match "
                         "the plan")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dgb = torch.empty((2, K), **f32)
    dat = torch.empty((r, K), **f32)
    dbt = torch.empty((O, r), **f32)
    use_drop = int(drop > 0.0 and scale != 0.0)
    err = _build.library().mtlora_ln_lora_qkv_bwd(
        *(t.data_ptr() for t in (x, gamma, beta, wt, at, bt, seed, gy, dx)),
        *(sc[k].data_ptr() for k in ("lnd", "mbuf", "gb", "part")),
        sc["xfer"].data_ptr() if "xfer" in sc else None, dgb.data_ptr(),
        dat.data_ptr(), dbt.data_ptr(), M, K, O, r, plan.bm, plan.split,
        plan.stages, plan.group, plan.smem, plan.sa, plan.sb, float(scale),
        dropout.threshold(drop) if use_drop else 0, use_drop,
        dropout.inv_keep(drop) if use_drop else 1.0, _stream(x))
    _build.check(err, "mtlora_ln_lora_qkv_bwd")
    ln_lora_bwd.launches += 1
    return dx, dgb[0], dgb[1], dat, dbt


def ln_lora_bwd(x, gamma, beta, wt, bias, at, bt, seed, scale: float,
                drop: float, gy):
    """``(dx, dgamma, dbeta, dat, dbt)`` of :func:`ln_lora_bwd_plain`: the
    plain version for CPU tensors, :func:`ln_lora_bwd_kernel` for CUDA
    tensors."""
    if x.device.type == "cpu":
        return ln_lora_bwd_plain(x, gamma, beta, wt, bias, at, bt, seed,
                                 scale, drop, gy)
    return ln_lora_bwd_kernel(x, gamma, beta, wt, bias, at, bt, seed, scale,
                              drop, gy)


# the constants of csrc/ln_lora_tail_fwd.cu that its plans size shared
# memory by (the kernel traps if the plan's bytes do not hold its layout)
TAIL_FWD_CHUNK = 64     # output chunk and slot width (kS)
TAIL_FWD_WARPS = 8      # warps of a row block (kWarps)
TAIL_FWD_TILE = TAIL_FWD_CHUNK + 8   # row stride of the staging tiles (kLdS)
TAIL_FWD_GROUP = 4      # slots a ring group (at most kGroupMax)
TAIL_FWD_MAX_STAGES = 16     # slots in the TMA ring, at most
TAIL_FWD_WIDE = 384     # C above which two warps share 16 rows (kWide)
TAIL_FWD_MAX_C = 1024   # the widest C the kernel takes
TAIL_FWD_ITEM_COST = 1  # an item's rows, statistics and m, in super-chunks


class TailFwdPlan(NamedTuple):
    """Launch plan of kernel 2's forward (either mode of
    ``csrc/ln_lora_tail_fwd.cu``): rows per block, warps that share 16 rows
    (each on its own 64-column chunk), the items of a row block that split
    its chunks, the items (row blocks x splits), blocks an SM, the TMA
    ring's slots and slots a group, dynamic shared-memory bytes, blocks
    (each taking items in turn), and the bytes of weight slots they stream
    from L2."""

    bm: int
    wn: int
    splits: int
    items: int
    per_sm: int
    stages: int
    group: int
    smem: int
    blocks: int
    slice_bytes: int


def _fwd_plan(M: int, C: int, O: int, r: int, sms: int, tail: bool,
              name: str) -> TailFwdPlan:
    if (C % 16 or not 16 <= C <= TAIL_FWD_MAX_C or O % 8 or not O
            or r % 16 or not 16 <= r <= 64):
        raise ValueError(f"{name}: needs C % 16 == 0 and 16 <= C <= "
                         f"{TAIL_FWD_MAX_C} ({C}), O % 8 == 0 ({O}) and r a "
                         f"multiple of 16 up to 64 ({r})")
    wn = 1 if C <= TAIL_FWD_WIDE else 2
    bm = ROW_TILE * TAIL_FWD_WARPS // wn
    ncs = -(-C // TAIL_FWD_CHUNK)
    nsc = -(-(-(-O // TAIL_FWD_CHUNK)) // wn)
    slot = 2 * TAIL_FWD_CHUNK ** 2

    def fixed_bytes(per_sm):
        # up to 1023 bytes to the ring's 1024-byte alignment; the x /
        # bf16(ln) tile, gamma and beta, the staging tiles a warp (bf16:
        # the kernel's NBUF); the ring, its mbarriers and counts below
        nbuf = 3 - per_sm if tail else wn
        return 1024 + 2 * (bm * (C + 8) + 2 * C + TAIL_FWD_WARPS
                           * nbuf * ROW_TILE * TAIL_FWD_TILE)

    def ring_bytes(stages, group):   # the slots; a mbarrier, a count a group
        return stages * slot + 12 * (stages // group)

    two = wn == 1 and fixed_bytes(2) + ring_bytes(4, 2) <= SM_SMEM // 2 - 1024
    per_sm = 2 if two else 1
    fixed = fixed_bytes(per_sm)
    limit = SM_SMEM // 2 - 1024 if two else SMEM_LIMIT
    group = (TAIL_FWD_GROUP
             if fixed + ring_bytes(2 * TAIL_FWD_GROUP, TAIL_FWD_GROUP)
             <= limit else 2)
    stages = TAIL_FWD_MAX_STAGES // group * group
    while stages >= 2 * group and fixed + ring_bytes(stages, group) > limit:
        stages -= group
    if stages < 2 * group:
        raise ValueError(f"{name}: {fixed} bytes of shared memory at C = "
                         f"{C} leave no ring within {limit}")
    rows = -(-M // bm)
    splits = min((-(-rows * s // (per_sm * sms))
                  * (nsc // s + TAIL_FWD_ITEM_COST), s)
                 for s in range(1, nsc + 1) if nsc % s == 0)[1]
    items = rows * splits
    smem = fixed + ring_bytes(stages, group)
    # per item: A (m), then per super-chunk W's slices and B of each chunk
    slices = ncs + nsc // splits * wn * (ncs + 1)
    return TailFwdPlan(bm, wn, splits, items, per_sm, stages, group, smem,
                       min(items, per_sm * sms), items * slices * slot)


def tail_fwd_plan(M: int, C: int, O: int, r: int, sms: int) -> TailFwdPlan:
    """Kernel 2's tail-mode plan for x [M, C] -> [M, O], rank r (a multiple
    of 16 up to 64, zero-filled to one 64-wide slot) on a card of ``sms``
    SMs. A block of 8 warps owns 128 rows up to C = 384 (a warp 16 rows
    and one 64-column chunk at a time); above, where that bf16(ln) tile
    would take most of the shared memory, 64 rows, two warps on the same
    16 rows taking two chunks side by side; the last row block masks the
    rows past M. An item is a row block and one split of its super-chunks
    (of ``wn`` chunks): where the row blocks are few they split evenly,
    the split, among those that divide them, that takes the fewest rounds
    of items over the SMs times super-chunks an item (plus
    ``TAIL_FWD_ITEM_COST`` for its rows, statistics and m). The blocks
    take the items in turn: two an SM where, with one staging tile a
    warp, a ring of 4 slots fits twice in an SM (WN = 1, C up to 192), else
    one, with two staging tiles a warp. The ring takes what shared memory
    leaves, in groups of 4 slots (2 where fewer than 8 fit), at most 16."""
    return _fwd_plan(M, C, O, r, sms, True, "LN+LoRA tail forward kernel")


def qkv_fwd_plan(M: int, C: int, O: int, r: int, sms: int) -> TailFwdPlan:
    """Kernel 2's plan at a qkv site (y only), x [M, C] -> [M, O]: the
    tail mode's rows, warps, splits and blocks an SM, with one staging tile
    a warp (two where two warps share 16 rows: m's shares), so that one
    block an SM (C above 192) has room for a deeper ring. Refuses r = 0
    (``ln_fused`` does too) and C above 1024 (the widest YAML's)."""
    return _fwd_plan(M, C, O, r, sms, False, "LN+LoRA qkv forward kernel")


def ln_lora_tail_fwd_kernel(x, gamma, beta, wt, bias, at, bt, seed,
                            scale: float, drop: float, act: bool = True,
                            out_drop: bool = False):
    """The CUDA route of :func:`ln_lora_tail_fwd` at the launch of
    :func:`tail_fwd_plan`; raises for anything it does not take (a CPU
    tensor included)."""
    ptrs = _kernel2_args("LN+LoRA tail forward", x, gamma, beta, wt, bias,
                         at, bt, seed)
    M, C = x.shape
    O, r = wt.shape[0], at.shape[0]
    plan = tail_fwd_plan(M, C, O, r, _sms(x.device))
    y = torch.empty((M, O), dtype=x.dtype, device=x.device)
    p = torch.empty_like(y)
    d = torch.empty_like(y) if out_drop else None
    use_drop = int(drop > 0.0 or out_drop)
    err = _build.library().mtlora_ln_lora_tail_fwd(
        *ptrs, y.data_ptr(), p.data_ptr(),
        None if d is None else d.data_ptr(), M, C, O, r, int(act), plan.bm,
        plan.splits, plan.per_sm, plan.blocks, plan.stages, plan.group,
        plan.smem, float(scale),
        dropout.threshold(drop) if use_drop else 0, use_drop,
        dropout.inv_keep(drop) if use_drop else 1.0, _stream(x))
    _build.check(err, "mtlora_ln_lora_tail_fwd")
    ln_lora_tail_fwd.launches += 1
    return y, p, d


def ln_lora_tail_fwd(x, gamma, beta, wt, bias, at, bt, seed, scale: float,
                     drop: float, act: bool = True, out_drop: bool = False):
    """Kernel 2's tail mode forward, no autograd: ``(y, p, d)`` (d None
    unless ``out_drop``), plain for CPU tensors,
    :func:`ln_lora_tail_fwd_kernel` for CUDA tensors."""
    if x.device.type == "cpu":
        return ln_lora_tail_plain(x, gamma, beta, wt, bias, at, bt, seed,
                                  scale, drop, act, out_drop)
    return ln_lora_tail_fwd_kernel(x, gamma, beta, wt, bias, at, bt, seed,
                                   scale, drop, act, out_drop)


# the constants of csrc/ln_lora_tail_bwd.cu that its plan sizes shared
# memory by (the kernel traps if the plan's bytes do not hold its layout)
TAIL_CHUNK = 64         # hidden chunk and weight-slice width (kS)
TAIL_STAGES = 4         # slices in the cp.async ring (kStages)
TAIL_WARPS = 8          # warps of a row block (kWarps)
TAIL_TILE = TAIL_CHUNK + 8   # row stride of the 64-wide tiles (kLdS)
TAIL_KEEP_SLICES = 12   # W slices a block keeps per chunk, at most (kKeepW)
TAIL_RANKS = (16, 32, 48, 64)   # zero-filled to one 64-wide slice (kRank)


class TailBwdPlan(NamedTuple):
    """Launch plan of kernel 2b's tail mode: rows per block, hidden chunk
    width, ring depth, the weight slices a block keeps per chunk (W's
    and B's), the blocks of a cluster that share a row block's hidden
    chunks, dynamic shared-memory bytes of the row kernel, its row blocks,
    the bytes of weight slices they stream from L2, the row stripes of
    the weight-gradient products dA [r, C] and dB [O, r], and the scratch
    the wrapper allocates: name -> (shape, dtype)."""

    bm: int
    chunk: int
    stages: int
    kept: int
    split: int
    smem: int
    blocks: int
    slice_bytes: int
    sa: int
    sb: int
    scratch: dict


def _tail_dims(C: int, O: int, r: int):
    if (C % 32 or not TAIL_CHUNK < C <= 1024 or O % TAIL_CHUNK
            or r not in TAIL_RANKS):
        raise ValueError(f"LN+LoRA tail backward kernel: needs C % 32 == 0 "
                         f"and 64 < C <= 1024 ({C}), O % 64 == 0 ({O}) and "
                         f"r in {TAIL_RANKS} ({r})")


def tail_bwd_plan(M: int, C: int, O: int, r: int, sms: int) -> TailBwdPlan:
    """The tail backward's plan for x [M, C], O hidden columns, rank r (16,
    32, 48 or 64, zero-filled to one 64-wide slice) on a card of ``sms``
    SMs: a row block of 64 rows, or 32 where C > 384 so that its fp32 dln
    (rows x C) stays at 96 registers a thread (128 at C = 1024), or 128
    at C = 192 (96 registers too, a warp's 64 columns whole slices; faster
    there on the H100, slower at C = 96); the last block masks the rows
    past M. Per chunk it keeps W's ceil(C / 64) slices and B's one; above
    C = 768 W's slices do not fit beside the bf16(ln) tile, and stream a
    second time for dln (B's one still kept). The
    32-row blocks, few (196 at stage 3, 1.5 waves of 132 SMs), split their
    hidden chunks between the two blocks of a cluster, the second handing
    its dln and dm partials to the first. Scratch: bf16(drop0(ln)) ``lnd``
    [M, C], the rank rows ``mbuf`` (m, dm) [2, M, r] and ``du`` [M, O] in
    bf16; the per-block dgamma/dbeta partials ``gb``, the weight-gradient
    stripes ``part`` (dA's, then dB's) and, with a split, the partials
    ``xfer`` in fp32."""
    _tail_dims(C, O, r)
    ncs = -(-C // TAIL_CHUNK)
    bm = 128 if C == 192 else 64 if ncs <= 6 else 32
    wn = max(1, TAIL_WARPS // (bm // ROW_TILE))
    keep_w = ncs <= TAIL_KEEP_SLICES
    kept = (ncs if keep_w else 0) + 1
    split = 2 if bm == 32 and O // TAIL_CHUNK % 2 == 0 else 1
    # the ring; the bf16(ln) tile; the m / dm tile; the kept slices, du and
    # gpt tiles, a span that holds the block's rows of x before and after
    # the chunks; mu, inv and the LayerNorm row sums; stream 0's mask bytes
    chunk_span = max(kept * TAIL_CHUNK ** 2 + 2 * bm * TAIL_TILE,
                     bm * (C + 8))
    smem = (2 * (TAIL_STAGES * TAIL_CHUNK ** 2 + bm * (C + 8)
                 + bm * TAIL_TILE + chunk_span)
            + 4 * (2 * bm + 2 * wn * bm) + bm * C)
    if smem > SMEM_LIMIT:
        raise ValueError(f"LN+LoRA tail backward kernel: {smem} bytes of "
                         f"shared memory at C = {C} exceed {SMEM_LIMIT}")
    blocks = -(-M // bm)
    # per row block: A (m, in each block of a split), per hidden chunk B
    # and W (twice where it is not kept), then A (dl)
    slices = (split + 1) * ncs + O // TAIL_CHUNK * (
        ncs + 1 if keep_w else 2 * ncs + 1)
    sa = stripes_for(sms, M, r, C)
    sb = stripes_for(sms, M, O, r)
    bf16, f32 = torch.bfloat16, torch.float32
    scratch = {
        "lnd": ((M, C), bf16),
        "mbuf": ((2, M, r), bf16),
        "du": ((M, O), bf16),
        "gb": ((blocks, 2, C), f32),
        "part": ((max(sa * r * C, sb * O * r),), f32),
    }
    if split == 2:
        # per row block, thread and n-tile of its dln slices and dm
        nt = TAIL_CHUNK // 8 // wn
        scratch["xfer"] = ((blocks * (ncs + 1) * nt * 4 * 32 * TAIL_WARPS,),
                           f32)
    return TailBwdPlan(bm, TAIL_CHUNK, TAIL_STAGES, kept, split, smem,
                       blocks, blocks * slices * 2 * TAIL_CHUNK ** 2, sa, sb,
                       scratch)


def tail_bwd_scratch(plan: TailBwdPlan, device) -> dict:
    """The scratch tensors of ``plan``, as :func:`ln_lora_tail_bwd`
    allocates them."""
    return {name: torch.empty(shape, dtype=dt, device=device)
            for name, (shape, dt) in plan.scratch.items()}


def ln_lora_tail_bwd_kernel(x, gamma, beta, wt, bias, at, bt, seed,
                            scale: float, drop: float, gy, gp=None, gd=None,
                            act: bool = True, scratch=None):
    """The CUDA route of :func:`ln_lora_tail_bwd`: the fused row kernel
    (dx, the rows lnd, m, dm, du, gamma/beta partials), then the
    weight-gradient kernels of dA and dB and the fixed-order reductions,
    all on the weights' module layouts; raises for anything it does not
    take (a CPU tensor included). ``scratch``: the tensors of
    :func:`tail_bwd_scratch` to use (the row kernel leaves its rows there),
    or None to allocate them."""
    ptrs = _kernel2_args("LN+LoRA tail backward", x, gamma, beta, wt, bias,
                         at, bt, seed, [("gy", gy), ("gp", gp), ("gd", gd)])
    M, C = x.shape
    O, r = wt.shape[0], at.shape[0]
    plan = tail_bwd_plan(M, C, O, r, _sms(x.device))
    sc = tail_bwd_scratch(plan, x.device) if scratch is None else scratch
    if {k: (tuple(v.shape), v.dtype) for k, v in sc.items()} != plan.scratch:
        raise ValueError("LN+LoRA tail backward kernel: scratch does not "
                         "match the plan")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dgb = torch.empty((2, C), **f32)
    dat = torch.empty((r, C), **f32)
    dbt = torch.empty((O, r), **f32)
    use_drop = int(drop > 0.0)
    err = _build.library().mtlora_ln_lora_tail_bwd(
        *ptrs, gy.data_ptr(), None if gp is None else gp.data_ptr(),
        None if gd is None else gd.data_ptr(), dx.data_ptr(),
        *(sc[k].data_ptr() for k in ("lnd", "mbuf", "du", "gb", "part")),
        sc["xfer"].data_ptr() if "xfer" in sc else None, dgb.data_ptr(),
        dat.data_ptr(), dbt.data_ptr(), M, C, O, r, int(act), plan.bm,
        plan.split, plan.smem, plan.sa, plan.sb, float(scale),
        dropout.threshold(drop) if use_drop else 0, use_drop,
        dropout.inv_keep(drop) if use_drop else 1.0, _stream(x))
    _build.check(err, "mtlora_ln_lora_tail_bwd")
    ln_lora_tail_bwd.launches += 1
    return dx, dgb[0], dgb[1], dat, dbt


def ln_lora_tail_bwd(x, gamma, beta, wt, bias, at, bt, seed, scale: float,
                     drop: float, gy, gp=None, gd=None, act: bool = True):
    """``(dx, dgamma, dbeta, dat, dbt)`` of :func:`ln_lora_tail_bwd_plain`:
    plain for CPU tensors, :func:`ln_lora_tail_bwd_kernel` for CUDA
    tensors."""
    if x.device.type == "cpu":
        return ln_lora_tail_bwd_plain(x, gamma, beta, wt, bias, at, bt, seed,
                                      scale, drop, gy, gp, gd, act)
    return ln_lora_tail_bwd_kernel(x, gamma, beta, wt, bias, at, bt, seed,
                                   scale, drop, gy, gp, gd, act)


def _merge_shapes(x, wt, H, W):
    """(M, K, O) of a merge of x [L, H*W, C] by ``wt [O, 4C]``; the shapes
    of the 2x2 gather, then the device (the plans refuse what their kernels
    do not take)."""
    L, HW, C = x.shape
    O = wt.shape[0]
    M = L * (H // 2) * (W // 2)
    if HW != H * W or H % 2 or W % 2 or M < 1:
        raise ValueError(f"patch merge kernel: needs x [L, H*W, C] with "
                         f"even H ({H}), W ({W}) and a merged row ({M})")
    require_cuda("patch merge", x)
    return M, 4 * C, O


# the constants of csrc/merge_ln_fwd.cu that its plan sizes shared memory by
# (the kernel traps if the plan's bytes do not hold its layout)
MERGE_FWD_CHUNK = 64     # output chunk, slot and slice of K: 64 wide (kS)
MERGE_FWD_WARPS = 8      # consumer warps of a block (kWarps)
MERGE_FWD_GROUP = 4      # slots a group of the refill ring (kGroupMax)
MERGE_FWD_MAX_STAGES = 16   # slots in the TMA ring, at most
MERGE_FWD_MIN_STAGES = 4    # the fewest slots a plan takes rows for
# rows a block of the kernel's instances, the most first, and the warps of
# a row group (32 rows; 16 at 16 rows a block)
MERGE_FWD_ROWS = {128: 2, 64: 4, 32: 8, 16: 8}
MERGE_FWD_MAX_K = 4096   # the widest merged row (kMaxK)
MERGE_FWD_ITEM_COST = 2  # an item's rows, statistics and bf16(ln), in chunks


class MergeFwdPlan(NamedTuple):
    """Launch plan of kernel 3 (``csrc/merge_ln_fwd.cu``; also of its task
    mode, kernel 6: ``ops/task_merge.py:task_merge_fwd_plan``): rows per
    block, the warps of a row group (each taking 64 / wn columns of each
    chunk), the items of a row block that split its 64-column output
    chunks, the items (row blocks x splits), blocks an SM, the TMA ring's
    slots and slots a group, dynamic shared-memory bytes, the bytes of W's
    slots the blocks stream from L2, and the blocks (each taking items in
    turn)."""

    bm: int
    wn: int
    splits: int
    items: int
    per_sm: int
    stages: int
    group: int
    smem: int
    slice_bytes: int
    blocks: int


def merge_fwd_plan(M: int, K: int, O: int, Wh: int, sms: int
                   ) -> MergeFwdPlan:
    """Kernel 3's plan for M merged rows of K = 4C columns (x's rows
    gathered 2x2, Wh merged rows a row of the merged grid) -> O on a card
    of ``sms`` SMs. A block keeps its rows' bf16(ln) [bm][K] (K rounded up
    to 64) in shared memory and streams W's 64 x 64 slots through a TMA
    ring beside it: the most rows of ``MERGE_FWD_ROWS`` that leave the ring
    ``MERGE_FWD_MIN_STAGES`` slots (each W slot then serves them all); the
    ring takes what is left, in groups of 4 slots (2 where fewer than 8
    fit), at most 16. One block an SM (a ninth warp issues the ring). An
    item is a row block and one split of its chunks: where the row blocks
    are few they split evenly, the split, among those that divide the
    chunks, that takes the fewest rounds of items over the SMs times chunks
    an item (plus ``MERGE_FWD_ITEM_COST`` for its rows). The last row block
    masks the rows past M."""
    if (K % 32 or not 32 <= K <= MERGE_FWD_MAX_K or O % 16 or O < 16
            or Wh < 1 or M < 1 or M % Wh):
        raise ValueError(f"patch merge forward kernel: needs C % 8 == 0 "
                         f"and K = 4C <= {MERGE_FWD_MAX_K} ({K}), O % 16 == "
                         f"0 ({O}) and whole rows of Wh = {Wh} merged "
                         f"tokens ({M} rows)")
    slot = 2 * MERGE_FWD_CHUNK ** 2
    kp = -(-K // MERGE_FWD_CHUNK) * MERGE_FWD_CHUNK

    def ring_bytes(stages):   # the slots; two mbarriers a slot
        return stages * (slot + 16)

    for bm, wn in MERGE_FWD_ROWS.items():
        # up to 1023 bytes to the ring's 1024-byte alignment; the tile
        fixed = 1024 + 2 * bm * kp
        group = (MERGE_FWD_GROUP
                 if fixed + ring_bytes(2 * MERGE_FWD_GROUP) <= SMEM_LIMIT
                 else 2)
        stages = MERGE_FWD_MAX_STAGES // group * group
        while (stages >= MERGE_FWD_MIN_STAGES
               and fixed + ring_bytes(stages) > SMEM_LIMIT):
            stages -= group
        if stages >= max(MERGE_FWD_MIN_STAGES, 2 * group):
            break
    else:
        raise ValueError(f"patch merge forward kernel: no plan for K = {K}")
    return merge_fwd_items(MergeFwdPlan(bm, wn, 0, 0, 1, stages, group,
                                        fixed + ring_bytes(stages), 0, 0),
                           -(-M // bm), K, O, sms)


def merge_fwd_items(layout: MergeFwdPlan, rows: int, K: int, O: int,
                    sms: int) -> MergeFwdPlan:
    """``layout`` (rows a block, the ring, shared memory) with its items
    for ``rows`` row blocks: the split of a row block's chunks that takes
    the fewest rounds of items over the SMs times chunks an item (plus
    ``MERGE_FWD_ITEM_COST``), the bytes of W's slots (each item streams its
    chunks' slices of K once) and the persistent blocks."""
    nch = -(-O // MERGE_FWD_CHUNK)
    ncs = -(-K // MERGE_FWD_CHUNK)
    splits = min((-(-rows * s // sms) * (nch // s + MERGE_FWD_ITEM_COST), s)
                 for s in range(1, nch + 1) if nch % s == 0)[1]
    return layout._replace(
        splits=splits, items=rows * splits,
        slice_bytes=rows * nch * ncs * 2 * MERGE_FWD_CHUNK ** 2,
        blocks=min(rows * splits, sms))


def merge_ln_fwd_kernel(x, gamma, beta, wt, H: int, W: int):
    """The CUDA route of :func:`merge_ln_fwd` at the launch of
    :func:`merge_fwd_plan`, W read in its module layout; raises for
    anything it does not take (a CPU tensor included)."""
    M, K, O = _merge_shapes(x, wt, H, W)
    _check("patch merge forward", x,
           [("x", x), ("gamma", gamma), ("beta", beta), ("wt", wt)],
           [x.shape, (K,), (K,), (O, K)])
    plan = merge_fwd_plan(M, K, O, W // 2, _sms(x.device))
    y = torch.empty((x.shape[0], M // x.shape[0], O), dtype=x.dtype,
                    device=x.device)
    err = _build.library().mtlora_merge_ln_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wt.data_ptr(),
        y.data_ptr(), M, K // 4, O, W // 2, plan.bm, plan.splits,
        plan.blocks, plan.stages, plan.group, plan.smem, _stream(x))
    _build.check(err, "mtlora_merge_ln_fwd")
    merge_ln_fwd.launches += 1
    return y


def merge_ln_fwd(x, gamma, beta, wt, H: int, W: int):
    """Kernel 3 forward, no autograd: plain for CPU tensors,
    :func:`merge_ln_fwd_kernel` for CUDA tensors."""
    if x.device.type == "cpu":
        return merge_ln_plain(x, gamma, beta, wt, H, W)
    return merge_ln_fwd_kernel(x, gamma, beta, wt, H, W)


# the constants of csrc/merge_ln_bwd.cu that its plan sizes shared memory
# by (the kernel traps if the plan's bytes do not hold its layout)
MERGE_CHUNK = 64        # hidden chunk and slot width (kS)
MERGE_WARPS = 8         # warps of a row block (kWarps)
MERGE_GROUP = 4         # slots a ring group (at most kGroupMax)
MERGE_MAX_STAGES = 16   # slots in the TMA ring, at most
MERGE_SPLITS = (1, 2, 4, 8)   # blocks of a cluster that split K (kSplitMax)
# rows a block -> the slices of 64 columns of K of its kernel's instances
MERGE_INSTANCES = {64: (3,), 32: (6, 8)}
MERGE_MAX_K = 4096      # the widest merged row the instances take


class MergeBwdPlan(NamedTuple):
    """Launch plan of kernel 3b: rows per block, the blocks of a cluster
    that split the merged rows' K columns, the columns a block takes,
    blocks an SM, the TMA ring's slots and slots a group, dynamic
    shared-memory bytes of the row kernel, its row blocks and blocks (row
    blocks x split), the bytes of W's slots they stream from L2, the row
    stripes of the weight product dW [O, K], and the scratch the wrapper
    allocates: name -> (shape, dtype)."""

    bm: int
    split: int
    ks: int
    per_sm: int
    stages: int
    group: int
    smem: int
    blocks: int
    ctas: int
    slice_bytes: int
    sw: int
    scratch: dict


def merge_bwd_plan(M: int, K: int, O: int, Wh: int, sms: int
                   ) -> MergeBwdPlan:
    """Kernel 3b's plan for M merged rows of K = 4C columns (x's rows
    gathered 2x2, Wh merged rows a row of the merged grid) -> O on a card
    of ``sms`` SMs. A block of 8 warps owns 64 rows, or 32, and the blocks
    of a cluster of 1, 2, 4 or 8 split K, so that a block's dln (rows x
    its columns, fp32) stays at 48 registers a thread and two blocks share
    an SM: the first of 64 then 32 rows and the fewest blocks a cluster
    that do so (32 rows at 64 registers, one block an SM, where none
    does: K = 4096). The columns of a warp's share of a slot (32 or 16)
    divide a block's columns. The last row block masks the rows past M.
    The ring takes what shared memory leaves, in groups of 4 slots (2
    where fewer than 8 fit), at most 16. Scratch: the bf16(ln) rows
    ``lnd`` [M, K] (bf16), the per-row-block dgamma/dbeta partials ``gb``
    and the weight-gradient stripes ``part`` (fp32)."""
    if (K % 32 or not 32 <= K <= MERGE_MAX_K or O % 16 or O < 16
            or Wh < 1 or M < 1 or M % Wh):
        raise ValueError(f"patch merge backward kernel: needs C % 8 == 0 "
                         f"and K = 4C <= {MERGE_MAX_K} ({K}), O % 16 == 0 "
                         f"({O}) and whole rows of Wh = {Wh} merged "
                         f"tokens ({M} rows)")
    slot = 2 * MERGE_CHUNK ** 2

    def ring_bytes(stages, group):   # the slots; a mbarrier, a count a group
        return stages * slot + 12 * (stages // group)

    for least in (2, 1):
        for bm in (64, 32):
            wn = MERGE_WARPS // (bm // ROW_TILE)
            for split in MERGE_SPLITS:
                ks = K // split
                if K % split or ks % (MERGE_CHUNK // wn):
                    continue
                ncs = -(-ks // MERGE_CHUNK)
                inst = [n for n in MERGE_INSTANCES[bm] if n >= ncs]
                per_sm = 2 if inst and bm * inst[0] <= 192 else 1
                if not inst or per_sm < least:
                    continue
                # up to 1023 bytes to the ring's 1024-byte alignment; the
                # rows of x, gamma and beta (bf16); mu, inv, the means,
                # the row sums and the exchanged pairs (fp32); the ring,
                # its mbarriers and counts
                fixed = (1024 + 2 * (bm * (ks + 8) + 2 * ks)
                         + 4 * bm * (8 + 2 * wn))
                limit = min(SMEM_LIMIT, SM_SMEM // per_sm - 1024)
                group = (MERGE_GROUP if fixed + ring_bytes(
                    2 * MERGE_GROUP, MERGE_GROUP) <= limit else 2)
                stages = MERGE_MAX_STAGES // group * group
                while (stages >= 2 * group
                       and fixed + ring_bytes(stages, group) > limit):
                    stages -= group
                # the dgamma/dbeta partials of the 16-row tiles in the ring
                if (stages < 2 * group
                        or (bm // ROW_TILE) * 2 * ks * 4 > stages * slot):
                    continue
                blocks = -(-M // bm)
                nch = -(-O // MERGE_CHUNK)
                sw = stripes_for(sms, M, O, K)
                bf16, f32 = torch.bfloat16, torch.float32
                scratch = {
                    "lnd": ((M, K), bf16),
                    "gb": ((blocks, 2, K), f32),
                    "part": ((sw * O * K,), f32),
                }
                return MergeBwdPlan(
                    bm, split, ks, per_sm, stages, group,
                    fixed + ring_bytes(stages, group), blocks,
                    blocks * split, blocks * split * nch * ncs * slot, sw,
                    scratch)
    raise ValueError(f"patch merge backward kernel: no plan for K = {K}")


def merge_bwd_scratch(plan: MergeBwdPlan, device) -> dict:
    """The scratch tensors of ``plan``, as :func:`merge_ln_bwd_kernel`
    allocates them."""
    return {name: torch.empty(shape, dtype=dt, device=device)
            for name, (shape, dt) in plan.scratch.items()}


def merge_ln_bwd_kernel(x, gamma, beta, wt, H: int, W: int, gy,
                        scratch=None):
    """The CUDA route of :func:`merge_ln_bwd`: the row kernel (dx, the rows
    lnd, gamma/beta partials), then the weight product dW and the
    fixed-order reductions, W read in its module layout; raises for
    anything it does not take (a CPU tensor included). ``scratch``: the
    tensors of :func:`merge_bwd_scratch` to use (the row kernel leaves its
    rows there), or None to allocate them."""
    M, K, O = _merge_shapes(x, wt, H, W)
    _check("patch merge backward", x,
           [("x", x), ("gamma", gamma), ("beta", beta), ("wt", wt),
            ("gy", gy)],
           [x.shape, (K,), (K,), (O, K), (x.shape[0], M // x.shape[0], O)])
    plan = merge_bwd_plan(M, K, O, W // 2, _sms(x.device))
    sc = merge_bwd_scratch(plan, x.device) if scratch is None else scratch
    if {k: (tuple(v.shape), v.dtype) for k, v in sc.items()} != plan.scratch:
        raise ValueError("patch merge backward kernel: scratch does not "
                         "match the plan")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dgb = torch.empty((2, K), **f32)
    dwt = torch.empty((O, K), **f32)
    err = _build.library().mtlora_merge_ln_bwd(
        *(t.data_ptr() for t in (x, gamma, beta, wt, gy, dx)),
        *(sc[k].data_ptr() for k in ("lnd", "gb", "part")), dgb.data_ptr(),
        dwt.data_ptr(), M, K // 4, O, W // 2, plan.bm, plan.split,
        plan.stages, plan.group, plan.smem, plan.sw, _stream(x))
    _build.check(err, "mtlora_merge_ln_bwd")
    merge_ln_bwd.launches += 1
    return dx, dgb[0], dgb[1], dwt


def merge_ln_bwd(x, gamma, beta, wt, H: int, W: int, gy):
    """``(dx, dgamma, dbeta, dwt)`` of :func:`merge_ln_bwd_plain`: plain
    for CPU tensors, :func:`merge_ln_bwd_kernel` for CUDA tensors."""
    if x.device.type == "cpu":
        return merge_ln_bwd_plain(x, gamma, beta, wt, H, W, gy)
    return merge_ln_bwd_kernel(x, gamma, beta, wt, H, W, gy)


ln_lora_fwd.launches = 0
ln_lora_bwd.launches = 0
ln_lora_tail_fwd.launches = 0
ln_lora_tail_bwd.launches = 0
merge_ln_fwd.launches = 0
merge_ln_bwd.launches = 0


class LNLoRAFn(torch.autograd.Function):
    """``custom_vjp`` of ``fused_ln_lora_linear`` in y-only mode: gradients
    for x, gamma, beta and the shared adapters; the frozen weight and bias
    take none."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wt, bias, at, bt, seed, scale, drop):
        ctx.save_for_backward(x, gamma, beta, wt, bias, at, bt, seed)
        ctx.scale, ctx.drop = scale, drop
        return ln_lora_fwd(x, gamma, beta, wt, bias, at, bt, seed, scale,
                           drop)

    @staticmethod
    def backward(ctx, gy):
        x, gamma, beta, wt, bias, at, bt, seed = ctx.saved_tensors
        dx, dg, db, dat, dbt = ln_lora_bwd(x, gamma, beta, wt, bias, at, bt,
                                           seed, ctx.scale, ctx.drop,
                                           gy.contiguous())
        return dx, dg, db, None, None, dat, dbt, None, None, None


class LNLoRATailFn(torch.autograd.Function):
    """``custom_vjp`` of ``fused_ln_lora_linear`` in the tail mode:
    outputs ``(y, p[, d])``; gradients for x, gamma, beta and the shared
    adapters from the cotangents of all three (those of unused outputs
    are None)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wt, bias, at, bt, seed, scale, drop,
                act, out_drop):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, gamma, beta, wt, bias, at, bt, seed)
        ctx.consts = (scale, drop, act)
        y, p, d = ln_lora_tail_fwd(x, gamma, beta, wt, bias, at, bt, seed,
                                   scale, drop, act, out_drop)
        return (y, p, d) if out_drop else (y, p)

    @staticmethod
    def backward(ctx, gy, gp, gd=None):
        x, gamma, beta, wt, bias, at, bt, seed = ctx.saved_tensors
        scale, drop, act = ctx.consts
        if gy is None:
            gy = torch.zeros(x.shape[0], wt.shape[0], dtype=x.dtype,
                             device=x.device)
        dx, dg, db, dat, dbt = ln_lora_tail_bwd(
            x, gamma, beta, wt, bias, at, bt, seed, scale, drop,
            gy.contiguous(), None if gp is None else gp.contiguous(),
            None if gd is None else gd.contiguous(), act)
        return (dx, dg, db, None, None, dat, dbt, None, None, None, None,
                None)


class MergeLNFn(torch.autograd.Function):
    """``custom_vjp`` of ``fused_merge_ln_linear`` with ``train_w``: the
    reduction weight trains (``TRAIN.FREEZE_DOWNSAMPLE_REDUCTION False``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wt, H, W):
        ctx.save_for_backward(x, gamma, beta, wt)
        ctx.hw = (H, W)
        return merge_ln_fwd(x, gamma, beta, wt, H, W)

    @staticmethod
    def backward(ctx, gy):
        x, gamma, beta, wt = ctx.saved_tensors
        dx, dg, db, dwt = merge_ln_bwd(x, gamma, beta, wt, *ctx.hw,
                                       gy.contiguous())
        return dx, dg, db, dwt, None, None


def fused_ln_lora_linear(x, gamma, beta, wt, bias, at, bt, seed,
                         scale: float, drop: float, out_p: bool = False,
                         out_act: bool = False, out_drop: bool = False,
                         train_w: bool = False):
    """Kernel 2: ``LN(x) wt^T + bias + scale (drop(LN x) at^T) bt^T`` on
    x [M, K], differentiable in x, gamma, beta, at and bt. ``seed``: int32
    [2] (read only when ``drop > 0`` or ``out_drop``). ``out_act`` applies
    GELU to y; ``out_p`` also returns the frozen pre-activation p;
    ``out_drop`` also returns ``dropout(y)`` at rate ``drop`` on hash stream
    1. Returns y, or ``(y[, p][, d])`` as ``fused_ln_lora_linear`` does.
    ``train_w`` raises: kernel 3 trains the reduction."""
    if train_w:
        raise NotImplementedError(TRAIN_W)
    if not (out_p or out_act or out_drop):
        return LNLoRAFn.apply(x, gamma, beta, wt, bias, at, bt, seed,
                              float(scale), float(drop))
    outs = LNLoRATailFn.apply(x, gamma, beta, wt, bias, at, bt, seed,
                              float(scale), float(drop), bool(out_act),
                              bool(out_drop))
    y, p = outs[0], outs[1]
    res = (y,) + ((p,) if out_p else ()) + ((outs[2],) if out_drop else ())
    return res if len(res) > 1 else y


def fused_merge_ln_linear(x, gamma, beta, wt, H: int, W: int):
    """Kernel 3: x [L, H*W, C] -> [L, H/2*W/2, O], differentiable in x,
    gamma, beta and the reduction weight ``wt [O, 4C]``."""
    return MergeLNFn.apply(x, gamma, beta, wt, H, W)
