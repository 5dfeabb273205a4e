"""Ring-ppermute covariance build — the SP/ring tier of C1/C10.

Sequence-parallel covariance construction (SURVEY.md section 2.1, "ring
pattern"): the N training points are the "sequence"; X is row-sharded over
the mesh axis and shards rotate around the ring with ``ppermute``, so
each chip fills its row-block of K one column-block per step without ever
holding the full X — the ring-attention analog for the O(N^2) pairwise
kernel computation. No N x N intermediate and no all-gather of X.

Composite kinds ('a*b+c' kernel algebra) are first-class: every additive
term / product factor gets its own scaled view of X (kernels.factor_view),
ALL views rotate around the ring together, and each ring step combines the
per-factor tile evaluations elementwise (sum over terms of amplitude times
product over factors) before the block lands — the same per-tile recipe
the Pallas builder uses, so the SP tier serves e.g. quasi-periodic kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from cugp_tpu.ops import kernels as kernel_ops


def _ring_body(x_views, scal, *, bases, term_sizes, axis):
    """shard_map body: build my (n_loc, N) row-block of K.

    x_views: tuple of per-factor scaled local row-blocks (all (n_loc, d_f));
    bases: flat tuple of post-factor_view base kinds, one per view;
    term_sizes: factors per additive term (len = number of terms);
    scal: [amp_0..amp_{T-1}, diag_add, extra_0..extra_{F-1}].
    """
    me = jax.lax.axis_index(axis)
    R = jax.lax.axis_size(axis)
    n_loc = x_views[0].shape[0]
    n = n_loc * R
    T = len(term_sizes)
    amps = [scal[t] for t in range(T)]
    diag_add = scal[T]
    extras = [scal[T + 1 + f] for f in range(len(bases))]

    perm = [(i, (i + 1) % R) for i in range(R)]
    row_off = me * n_loc
    rows_idx = row_off + jnp.arange(n_loc)[:, None]

    def block(rot_views):
        """Composite tile: sum over terms of amp * prod of factor tiles."""
        blk = None
        f = 0
        for t, nf in enumerate(term_sizes):
            term = None
            for _ in range(nf):
                kf = kernel_ops.tile_eval(x_views[f], rot_views[f],
                                          bases[f], extras[f])
                term = kf if term is None else term * kf
                f += 1
            term = amps[t] * term
            blk = term if blk is None else blk + term
        return blk

    def step(s, carry):
        k_loc, rot_views = carry
        src = (me - s) % R  # origin shard of what we currently hold
        blk = block(rot_views)
        col_off = src * n_loc
        cols_idx = col_off + jnp.arange(n_loc)[None, :]
        blk = blk + jnp.where(rows_idx == cols_idx, diag_add, 0.0)
        k_loc = jax.lax.dynamic_update_slice(k_loc, blk, (0, col_off))
        rot_views = tuple(jax.lax.ppermute(xv, axis, perm)
                          for xv in rot_views)
        return (k_loc, rot_views)

    k_loc = jnp.zeros((n_loc, n), jnp.float32)
    # mark the carry as device-varying over the ring axis up front: the
    # first ppermute/axis_index use makes the outputs varying, and scan
    # carries must have matching varying-axis types on both sides
    axes = axis if isinstance(axis, tuple) else (axis,)
    k_loc = jax.lax.pcast(k_loc, axes, to="varying")
    k_loc, _ = jax.lax.fori_loop(0, R, step, (k_loc, x_views))
    return k_loc


def ring_train_covariance(params, X, mesh, kind="rbf", jitter=1e-6,
                          axis="r"):
    """K(X,X) + noise diag, built by ring rotation; K returned row-sharded.

    X: (n, d) with n divisible by the size of mesh axis `axis` (a name or
    a tuple of names — e.g. ("r", "c") rings over all chips row-major).
    kind may be any base family or a '+'/'*' composite of them.
    """
    kernel_ops.validate_kind(kind)
    sn2 = jnp.exp(params["log_noise_var"]).astype(jnp.float32)
    sf2 = kernel_ops.signal_scale(params).astype(jnp.float32)

    views, bases, extras, amps, term_sizes = [], [], [], [], []
    for amp, factors in kernel_ops.flatten_terms(params, kind):
        amps.append(jnp.asarray(amp, jnp.float32))
        term_sizes.append(len(factors))
        for base, fp in factors:
            xs, b2, extra = kernel_ops.factor_view(fp, X, base)
            views.append(xs)
            bases.append(b2)
            extras.append(jnp.asarray(extra, jnp.float32))

    # scalars enter the body via one stacked operand: shard_map requires
    # explicit specs, so fold amplitudes/diag/extras into a tiny array
    scal = jnp.stack(amps + [sn2 + jitter * sf2] + extras)
    nv = len(views)

    def body(x_views, scal):
        return _ring_body(x_views, scal, bases=tuple(bases),
                          term_sizes=tuple(term_sizes), axis=axis)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(tuple(P(axis, None) for _ in range(nv)), P()),
        out_specs=P(axis, None),
    )
    return fn(tuple(views), scal)
