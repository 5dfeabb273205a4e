"""Fused covariance-tile matvec for the GPU: Pallas on the Triton route.

Computes (K(X, X) + diag_add I) v for the matrix-free tier (CG solves,
batched Lanczos / SLQ) without writing K anywhere. The grid runs over row
blocks only. Each program owns BM output rows, loops over the columns in
BN-wide tiles, builds each (BM, BN) covariance tile in registers and
contracts it at once with the matching (BN, r) slice of v; the (BM, r)
accumulator stays in registers for the whole loop. Bytes moved per call
are O(n (d + r)); the O(n^2) tile entries cost only arithmetic.

Layout:
- X is scaled by 1/lengthscale, augmented so that one dot gives the RBF
  exponent or the linear kernel (prepare()), and zero-padded to DP
  features, the next power of two >= 16 (Triton's dot wants every operand
  dimension >= 16). The column operand is stored transposed, (DP, n), so
  a column tile is DP contiguous rows of BN floats.
- v is zero-padded to RP columns (the next power of two >= 16, at most
  32; wider v is cut into 32-column blocks, a vmapped grid axis, so the
  accumulator stays within the register budget) and to the padded row
  count. Padded columns of K then meet zero rows of v and add exactly 0;
  padded output rows are cropped. That zero padding is the padding mask:
  nothing inside the loop needs one.
- The noise + jitter diagonal is added outside the kernel as
  ``diag_add * v``, one O(n r) elementwise op that XLA fuses.
- sf2 and the family's extra scalar (rq alpha, linear bias) ride in a
  small (2,) array that every program loads itself.

Precision: both ``pl.dot`` calls use ``DotAlgorithmPreset.TF32_TF32_F32_X3``,
which the installed Triton lowering maps to ``InputPrecision.TF32x3``:
each fp32 operand is split into a TF32 high part and a TF32 residual and
three tensor-core products accumulate in fp32, for an error near fp32's
(``Precision.HIGHEST`` maps to ``InputPrecision.IEEE``, fp32 FMA without
tensor cores; on an H100 it was the slower of the two at the same error
bound, PERF.md). The interpreter runs the products in IEEE fp32.

Interpret mode runs only when the caller passes ``interpret=True`` (the
CPU tests do). Without it, a backend other than the GPU raises.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from cugp_tpu.ops.kernels import (extra_scalar, kernel_fn,
                                  periodic_rbf_view,
                                  require_base_kind as _require_base_kind)

MAX_D = 32          # widest (post-embedding) feature dim the kernel takes
_BM = 128           # output rows per program
_BN = 64            # columns per inner-loop tile
_NUM_WARPS = 4
_NUM_STAGES = 3
_MAX_RP = 32        # widest RHS block one call carries (register budget)
_DOT = jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3
_LOG2E = 1.4426950408889634


def _pow2_at_least(x, lo=16):
    p = lo
    while p < x:
        p *= 2
    return p


def _round_up(a, b):
    return -(-a // b) * b


def tile(xa, xbt, s1, kind, sf2, extra, precision=_DOT):
    """One (BM, BN) covariance tile from the row block xa (BM, DP) and the
    transposed column block xbt (DP, BN) that prepare() laid out."""
    t = pl.dot(xa, xbt, precision=precision)
    if kind == "rbf":
        return jnp.exp2(t)
    if kind == "linear":
        return t
    # the other families keep the plain expansion, rounded like the XLA
    # builder's: near d2 = 0 the sqrt of the Matern kernels turns any
    # other rounding of the cancellation into ~1e-4 of k
    s2 = jnp.sum(xbt * xbt, axis=0, keepdims=True)
    d2 = jnp.maximum(s1 + s2 - 2.0 * t, 0.0)
    return sf2 * kernel_fn(d2, kind, extra)


def _matvec_kernel(scal_ref, xa_ref, xbt_ref, v_ref, o_ref, *, kind, bn,
                   n_col_blocks, precision):
    sf2 = scal_ref[0]
    extra = scal_ref[1]
    xa = xa_ref[...]
    s1 = jnp.sum(xa * xa, axis=1, keepdims=True)

    def body(j, acc):
        cols = pl.ds(pl.multiple_of(j * bn, bn), bn)
        k = tile(xa, xbt_ref[:, cols], s1, kind, sf2, extra, precision)
        return acc + pl.dot(k, v_ref[cols, :], precision=precision)

    acc = jax.lax.fori_loop(0, n_col_blocks, body,
                            jnp.zeros(o_ref.shape, jnp.float32))
    o_ref[...] = acc


@functools.partial(jax.jit, static_argnames=(
    "kind", "interpret", "bm", "bn", "num_warps", "num_stages"))
def _matvec_call(xa, xbt, vp, *, scalars, kind, interpret, bm=_BM, bn=_BN,
                 num_warps=_NUM_WARPS, num_stages=_NUM_STAGES):
    npad, dp = xa.shape
    rp = vp.shape[1]
    # the CPU has no TF32: the interpreter runs the products in IEEE fp32
    kern = functools.partial(
        _matvec_kernel, kind=kind, bn=bn, n_col_blocks=npad // bn,
        precision=jax.lax.Precision.HIGHEST if interpret else _DOT)
    return pl.pallas_call(
        kern,
        grid=(npad // bm,),
        in_specs=[
            pl.BlockSpec(scalars.shape, lambda i: (0,)),
            pl.BlockSpec((bm, dp), lambda i: (i, 0)),
            pl.BlockSpec((dp, npad), lambda i: (0, 0)),
            pl.BlockSpec((npad, rp), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((bm, rp), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((npad, rp), jnp.float32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=num_stages),
        interpret=interpret,
        name="cov_tile_matvec",
    )(scalars, xa, xbt, vp)


def prepare(params, X, kind, rows_to):
    """The kernel's operands for X: (kind', xa (npad, DP), xbt (DP, npad),
    scalars (2,)), with xa[i] . xbt[:, j] = t_ij as tile() expects.

    rbf:      xa = log2(e) [x, log sf2 - |x|^2/2, 1], xb = [x, 1, -|x|^2/2]
              so t = log2(e) (log sf2 - |xi - xj|^2 / 2), k = exp2(t);
    linear:   xa = [sf2 x, bias], xb = [x, 1], k = t;
    others:   xa = xb = x, t = xi . xj (tile() expands the distance).
    x is X scaled by 1/lengthscale; periodic becomes rbf on its cos/sin
    embedding. DP is the next power of two >= 16 above the augmented
    width; padded rows are zero.
    """
    if kind == "periodic":
        params, X = periodic_rbf_view(params, X)
        kind = "rbf"
    n, d = X.shape
    if d > MAX_D:
        raise ValueError(f"fused matvec supports d<={MAX_D}, got {d}"
                         " (periodic doubles d via the cos/sin embedding)")
    ell = jnp.exp(params["log_lengthscale"]).astype(jnp.float32)
    x = (X / ell).astype(jnp.float32)
    sf2 = jnp.exp(params["log_signal_var"]).astype(jnp.float32)
    extra = extra_scalar(params, kind)
    sq = jnp.sum(x * x, axis=1, keepdims=True)
    one = jnp.ones_like(sq)
    if kind == "rbf":
        xa = _LOG2E * jnp.concatenate([x, jnp.log(sf2) - 0.5 * sq, one], 1)
        xb = jnp.concatenate([x, one, -0.5 * sq], 1)
    elif kind == "linear":
        xa = jnp.concatenate([sf2 * x, extra * one], 1)
        xb = jnp.concatenate([x, one], 1)
    else:
        xa = xb = x
    npad = _round_up(max(n, 1), rows_to)
    width = xa.shape[1]
    pad = ((0, npad - n), (0, _pow2_at_least(width) - width))
    return kind, jnp.pad(xa, pad), jnp.pad(xb, pad).T, jnp.stack([sf2, extra])


def train_cov_matvec(params, X, v, kind="rbf", jitter=1e-6,
                     interpret=False):
    """(K(X, X) + (noise + jitter * sf2) I) @ v, K built tile by tile.

    v: (n,) or (n, r). Base kernel families with d <= MAX_D only
    (composites take the blocked XLA matvec). interpret=True runs the
    kernel in the Pallas interpreter; otherwise the default backend must
    be the GPU.
    """
    _require_base_kind(kind, "train_cov_matvec")
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the fused matvec kernel compiles for the GPU only; backend is "
            f"{jax.default_backend()!r} (use method='xla', or "
            "interpret=True to run it in the Pallas interpreter)")
    n = X.shape[0]
    kind2, xa, xbt, scalars = prepare(params, X, kind, max(_BM, _BN))
    vec = v.ndim == 1
    v2 = v[:, None] if vec else v
    r = v2.shape[1]
    rp = min(_pow2_at_least(r), _MAX_RP)
    nblk = -(-r // rp)
    vp = jnp.pad(v2.astype(jnp.float32),
                 ((0, xa.shape[0] - n), (0, nblk * rp - r)))
    call = functools.partial(_matvec_call, xa, xbt, scalars=scalars,
                             kind=kind2, interpret=interpret)
    if nblk == 1:
        out = call(vp)
    else:
        blocks = vp.reshape(-1, nblk, rp).transpose(1, 0, 2)
        out = jax.vmap(call)(blocks).transpose(1, 0, 2).reshape(-1, nblk * rp)
    out = out[:n, :r]
    sn2 = jnp.exp(params["log_noise_var"]).astype(jnp.float32)
    sf2 = jnp.exp(params["log_signal_var"]).astype(jnp.float32)
    out = out + (sn2 + jitter * sf2) * v2
    return out[:, 0] if vec else out
