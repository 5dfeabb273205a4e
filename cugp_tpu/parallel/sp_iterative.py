"""Distributed MATRIX-FREE inference — ring matvec + sharded CG (round-4
beyond-parity surface; the SP/ring analog of the iterative tier).

The single-chip matrix-free tier (inference/iterative) lifted exact-GP
inference to n=131k on one chip; this module shards the SAME schedule
over a mesh axis: X, y, and every CG vector are row-sharded, the kernel
matvec rotates shards around the ring with ``ppermute`` (each step
builds one (n_loc, n_loc) tile and contracts it immediately — K never
exists as a whole), and CG's
scalar reductions ride ``psum``. Per-chip memory is O(n_loc * (d + r)),
so capacity scales linearly with the ring size on top of the
single-chip 131k envelope.

Composite kernels are first-class via the same flatten_terms/factor_view
tile algebra the ring covariance builder uses (parallel/ring.py).

Everything here runs inside ONE shard_map program per solve; tested on
the 8-virtual-device CPU mesh against the single-device iterative tier
(tests/dist/test_sp_iterative.py) and exercised by dryrun_multichip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from cugp_tpu.ops import kernels as kernel_ops


def _views_scal(params, X, kind, jitter):
    """Per-factor scaled views + packed scalars (ring.py's recipe)."""
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
    scal = jnp.stack(amps + [sn2 + jitter * sf2] + extras)
    return tuple(views), tuple(bases), tuple(term_sizes), scal


def _tile(x_views, rot_views, scal, bases, term_sizes):
    """Composite kernel tile between local rows and rotated cols."""
    T = len(term_sizes)
    blk = None
    f = 0
    for t, nf in enumerate(term_sizes):
        term = None
        for _ in range(nf):
            kf = kernel_ops.tile_eval(x_views[f], rot_views[f], bases[f],
                                      scal[T + 1 + f])
            term = kf if term is None else term * kf
            f += 1
        term = scal[t] * term
        blk = term if blk is None else blk + term
    return blk


def _make_ring_matvec(x_views, scal, bases, term_sizes, axis):
    """v_loc (n_loc, r) -> ((K + diag I) v)_loc inside a shard_map body."""
    R = jax.lax.axis_size(axis)
    T = len(term_sizes)
    diag_add = scal[T]
    perm = [(i, (i + 1) % R) for i in range(R)]

    def matvec(v_loc):
        # zeros_like(v_loc) inherits v_loc's device-varying type, so no
        # pcast is needed (unlike ring.py's invariant-fresh carry)
        u0 = jnp.zeros_like(v_loc)

        def step(s, carry):
            u, rot_views, v_rot = carry
            blk = _tile(x_views, rot_views, scal, bases, term_sizes)
            u = u + jnp.matmul(blk, v_rot,
                               precision=jax.lax.Precision.HIGHEST)
            rot_views = tuple(jax.lax.ppermute(xv, axis, perm)
                              for xv in rot_views)
            v_rot = jax.lax.ppermute(v_rot, axis, perm)
            return (u, rot_views, v_rot)

        u, _, _ = jax.lax.fori_loop(0, R, step, (u0, x_views, v_loc))
        return u + diag_add * v_loc

    return matvec


def _pdot(a, b, axis):
    """Global per-column dot product of row-sharded (n_loc, r) arrays."""
    return jax.lax.psum(jnp.sum(a * b, axis=0), axis)


def _woodbury_apply_sharded(Lk_loc, Lg, s2, axis):
    """Row-sharded pivoted-Cholesky preconditioner apply (round-4 VERDICT
    next #3): P^-1 r = (r - Lk (s2 I + Lk^T Lk)^-1 Lk^T r) / s2 with Lk
    ROW-sharded like every CG vector — Lk^T r is one psum of local
    (k, rhs) partial products, the k x k triangular solves are replicated
    (k ~ 128, trivially small), and the final Lk @ t is local. One psum
    per apply; the factors themselves come from
    inference.iterative.precond_factors[_host] on the full X."""
    from cugp_tpu.ops import trsm as trsm_ops

    def apply_p(r_loc):
        t = jax.lax.psum(
            jnp.matmul(Lk_loc.mT, r_loc,
                       precision=jax.lax.Precision.HIGHEST), axis)
        t = trsm_ops.cho_solve(Lg, t)
        return (r_loc - jnp.matmul(
            Lk_loc, t, precision=jax.lax.Precision.HIGHEST)) / s2

    return apply_p


def _cg_sharded(matvec, b_loc, axis, tol, max_iters, apply_m=None):
    """(Preconditioned) CG with psum-reduced scalars; b_loc (n_loc, r)
    row-sharded; apply_m an optional r_loc -> M^-1 r_loc (e.g. the
    sharded Woodbury apply)."""
    if apply_m is None:
        def apply_m(r):
            return r
    bnorm = jnp.maximum(jnp.sqrt(_pdot(b_loc, b_loc, axis)), 1e-30)
    x = jnp.zeros_like(b_loc)
    r = b_loc
    z = apply_m(r)
    p = z
    rs = _pdot(r, z, axis)

    def cond(c):
        x, r, p, rs, it = c
        rel = jnp.sqrt(_pdot(r, r, axis)) / bnorm
        return (it < max_iters) & jnp.any(rel > tol)

    def body(c):
        x, r, p, rs, it = c
        ap = matvec(p)
        denom = _pdot(p, ap, axis)
        alpha = rs / jnp.where(denom == 0, 1.0, denom)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        z = apply_m(r)
        rs_new = _pdot(r, z, axis)
        beta = rs_new / jnp.where(rs == 0, 1.0, rs)
        p = z + beta[None, :] * p
        return (x, r, p, rs_new, it + 1)

    x, r, p, rs, it = jax.lax.while_loop(
        cond, body, (x, r, p, rs, jnp.asarray(0, jnp.int32)))
    return x, it


def ring_matvec(params, X, v, mesh, kind="rbf", jitter=1e-6, axis="r"):
    """(K(X,X) + (noise + jitter sf2) I) v over a row-sharded ring.

    X (n, d), v (n,) or (n, r); n divisible by the axis size. Returns the
    product row-sharded the same way (fetch gathers it).
    """
    kernel_ops.validate_kind(kind)
    vec = v.ndim == 1
    v2 = (v[:, None] if vec else v).astype(jnp.float32)
    views, bases, term_sizes, scal = _views_scal(params, X, kind, jitter)

    def body(x_views, v_loc, scal):
        mv = _make_ring_matvec(x_views, scal, bases, term_sizes, axis)
        return mv(v_loc)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(tuple(P(axis, None) for _ in views), P(axis, None), P()),
        out_specs=P(axis, None))
    out = fn(views, v2, scal)
    return out[:, 0] if vec else out


def cg_solve_sharded(params, X, b, mesh, kind="rbf", jitter=1e-6,
                     axis="r", tol=1e-6, max_iters=500, precond=None):
    """Distributed CG solve of (K + noise I) x = b; K never formed.

    ONE shard_map program: ring matvecs + psum scalar reductions.
    precond: optional (Lk, Lg, s2) pivoted-Cholesky factors
    (inference.iterative.precond_factors[_host]) — Lk is row-sharded
    along the ring, the apply costs one psum per CG iteration
    (_woodbury_apply_sharded). Returns (x row-sharded, iterations)."""
    kernel_ops.validate_kind(kind)
    vec = b.ndim == 1
    b2 = (b[:, None] if vec else b).astype(jnp.float32)
    views, bases, term_sizes, scal = _views_scal(params, X, kind, jitter)
    if precond is None:
        def body(x_views, b_loc, scal):
            mv = _make_ring_matvec(x_views, scal, bases, term_sizes, axis)
            return _cg_sharded(mv, b_loc, axis, tol, max_iters)

        fn = shard_map(
            body, mesh=mesh,
            in_specs=(tuple(P(axis, None) for _ in views), P(axis, None),
                      P()),
            out_specs=(P(axis, None), P()))
        x, it = fn(views, b2, scal)
    else:
        Lk, Lg, s2 = precond

        def body_pre(x_views, b_loc, Lk_loc, Lg, s2, scal):
            mv = _make_ring_matvec(x_views, scal, bases, term_sizes, axis)
            am = _woodbury_apply_sharded(Lk_loc, Lg, s2, axis)
            return _cg_sharded(mv, b_loc, axis, tol, max_iters,
                               apply_m=am)

        fn = shard_map(
            body_pre, mesh=mesh,
            in_specs=(tuple(P(axis, None) for _ in views), P(axis, None),
                      P(axis, None), P(), P(), P()),
            out_specs=(P(axis, None), P()))
        x, it = fn(views, b2, Lk, Lg, s2, scal)
    return (x[:, 0] if vec else x), it


def posterior_iterative_sharded(params, X, y, Xs, mesh, kind="rbf",
                                jitter=1e-6, axis="r", tol=1e-6,
                                max_iters=500, include_noise=False,
                                precond=None):
    """Matrix-free posterior mean + diag variance over the ring.

    X/y row-sharded; Xs (m, d) replicated (test points are small).
    mean = psum_j K(Xs, X_j) alpha_j with alpha from distributed CG;
    variance via the batched distributed solve on the cross-covariance
    columns. One shard_map program; K never formed anywhere.
    precond: optional (Lk, Lg, s2) factors — row-sharded Woodbury apply
    inside both solves (round-4 VERDICT next #3).
    """
    kernel_ops.validate_kind(kind)
    y2 = y[:, None].astype(jnp.float32)
    views, bases, term_sizes, scal = _views_scal(params, X, kind, jitter)
    # views of the TEST inputs in each factor's evaluation space share
    # the factor scaling, so cross tiles reuse _tile with rot=Xs-views
    sviews = []
    for _amp, factors in kernel_ops.flatten_terms(params, kind):
        for base, fp in factors:
            xss, _b2, _e = kernel_ops.factor_view(fp, Xs, base)
            sviews.append(xss)
    sviews = tuple(sviews)
    kss = kernel_ops.kernel_diag(params, Xs, kind)
    sn2 = jnp.exp(params["log_noise_var"])
    if precond is None:
        pre_args = (jnp.zeros((X.shape[0], 0), jnp.float32),
                    jnp.zeros((0, 0), jnp.float32), jnp.float32(1.0))
    else:
        pre_args = precond
    use_pre = precond is not None

    def body(x_views, s_views, y_loc, Lk_loc, Lg, s2, scal):
        mv = _make_ring_matvec(x_views, scal, bases, term_sizes, axis)
        am = (_woodbury_apply_sharded(Lk_loc, Lg, s2, axis) if use_pre
              else None)
        alpha, _ = _cg_sharded(mv, y_loc, axis, tol, max_iters, apply_m=am)
        ks_loc = _tile(x_views, s_views, scal, bases, term_sizes)  # (nl, m)
        mu = jax.lax.psum(
            jnp.matmul(ks_loc.mT, alpha,
                       precision=jax.lax.Precision.HIGHEST)[:, 0], axis)
        w, _ = _cg_sharded(mv, ks_loc, axis, tol, max_iters, apply_m=am)
        qvar = jax.lax.psum(jnp.sum(ks_loc * w, axis=0), axis)
        return mu, qvar

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(tuple(P(axis, None) for _ in views),
                  tuple(P() for _ in sviews), P(axis, None),
                  P(axis, None), P(), P(), P()),
        out_specs=(P(), P()))
    mu, qvar = fn(views, sviews, y2, *pre_args, scal)
    var = kss - qvar
    if include_noise:
        var = var + sn2
    return mu, jnp.maximum(var, 0.0)


def _lml_parts_sharded(params, X, y, z, mesh, kind="rbf", jitter=1e-6,
                       axis="r", tol=1e-5, max_iters=500, num_steps=32,
                       precond=None):
    """ONE shard_map program computing the matrix-free LML over the ring
    AND returning the solves the gradient estimator needs.

    Solves [y | z] in one batched distributed CG (BBMM batching: the
    ring tiles are built once per iteration and contracted against
    rhs+probes together), runs batched Lanczos SLQ with psum-reduced
    inner products for the logdet, and returns
    (lml value, alpha = K^-1 y, w = K^-1 z, cg_iters) with alpha/w
    row-sharded. precond: optional (Lk, Lg, s2) factors for the CG
    (round-4 VERDICT next #3/#4).
    """
    import math

    kernel_ops.validate_kind(kind)
    n = X.shape[0]
    num_probes = z.shape[1]
    y2 = y[:, None].astype(jnp.float32)
    views, bases, term_sizes, scal = _views_scal(params, X, kind, jitter)
    if precond is None:
        pre_args = (jnp.zeros((n, 0), jnp.float32),
                    jnp.zeros((0, 0), jnp.float32), jnp.float32(1.0))
    else:
        pre_args = precond
    use_pre = precond is not None

    def body(x_views, y_loc, z_loc, Lk_loc, Lg, s2, scal):
        mv = _make_ring_matvec(x_views, scal, bases, term_sizes, axis)
        am = (_woodbury_apply_sharded(Lk_loc, Lg, s2, axis) if use_pre
              else None)
        B = jnp.concatenate([y_loc, z_loc], axis=1)
        sol, it = _cg_sharded(mv, B, axis, tol, max_iters, apply_m=am)
        alpha, w = sol[:, :1], sol[:, 1:]
        quad = _pdot(y_loc, alpha, axis)[0]

        # batched Lanczos with global (psum) inner products
        nrm = jnp.sqrt(_pdot(z_loc, z_loc, axis))
        q0 = z_loc / nrm[None, :]

        def step(carry, _):
            q_prev, q, beta_prev = carry
            v = mv(q) - beta_prev[None, :] * q_prev
            a = _pdot(q, v, axis)
            v = v - a[None, :] * q
            b = jnp.sqrt(_pdot(v, v, axis))
            q_next = v / jnp.where(b == 0, 1.0, b)[None, :]
            return (q, q_next, b), (a, b)

        (_, _, _), (alphas, betas) = jax.lax.scan(
            step, (jnp.zeros_like(q0), q0,
                   jnp.zeros((num_probes,), jnp.float32)), None,
            length=num_steps)
        betas = betas[:-1]

        def quad_form(a, b):  # replicated tiny eigendecomposition
            t = jnp.diag(a) + jnp.diag(b, 1) + jnp.diag(b, -1)
            evals, evecs = jnp.linalg.eigh(t)
            evals = jnp.maximum(evals, 1e-30)
            w_ = evecs[0, :] ** 2
            return jnp.sum(w_ * jnp.log(evals)) * float(n)

        logdet = jnp.mean(jax.vmap(quad_form, in_axes=(1, 1))(alphas, betas))
        value = (-0.5 * quad - 0.5 * logdet
                 - 0.5 * n * math.log(2 * math.pi))
        return value, alpha, w, it

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(tuple(P(axis, None) for _ in views), P(axis, None),
                  P(axis, None), P(axis, None), P(), P(), P()),
        out_specs=(P(), P(axis, None), P(axis, None), P()))
    return fn(views, y2, z, *pre_args, scal)


def lml_iterative_sharded(params, X, y, mesh, key=None, kind="rbf",
                          jitter=1e-6, axis="r", tol=1e-5, max_iters=500,
                          num_probes=16, num_steps=32, precond=None):
    """Matrix-free LML over the ring: distributed CG for the quadratic
    term + batched Lanczos SLQ with psum-reduced inner products for the
    logdet. One shard_map program; per-chip memory O(n_loc * probes).

    The multi-chip extension of inference/iterative.lml_iterative: the
    same estimator, with every n-vector row-sharded and every scalar
    reduction a psum — capacity for the n axis scales with the ring.
    """
    if key is None:
        key = jax.random.key(0)
    z = jax.random.rademacher(key, (X.shape[0], num_probes),
                              dtype=jnp.float32)
    value, _alpha, _w, _it = _lml_parts_sharded(
        params, X, y, z, mesh, kind=kind, jitter=jitter, axis=axis,
        tol=tol, max_iters=max_iters, num_steps=num_steps, precond=precond)
    return value


# ---- Sharded TRAINING tier (round-4 VERDICT next #3) -------------------
# The ring tier above solves and scores; the functions below make it
# LEARN: a differentiable (scan + remat) ring matvec powers a sharded
# Hutchinson/AD gradient sweep, and fit_iterative_sharded runs the same
# host-Adam loop as inference/map_opt.fit_iterative with every device
# program distributed — K never formed on any chip, per-chip memory
# O(n_loc * (d + probes)).


def _make_ring_matvec_diff(x_views, scal, bases, term_sizes, axis):
    """Differentiable twin of _make_ring_matvec: lax.scan over ring steps
    (fori_loop has no reverse-mode rule) with jax.checkpoint on the step
    so the backward pass REBUILDS each (n_loc, n_loc) tile instead of
    storing R of them — the sharded analog of make_matvec's remat."""
    R = jax.lax.axis_size(axis)
    T = len(term_sizes)
    diag_add = scal[T]
    perm = [(i, (i + 1) % R) for i in range(R)]

    def matvec(v_loc):
        u0 = jnp.zeros_like(v_loc)

        @jax.checkpoint
        def step(carry, _):
            u, rot_views, v_rot = carry
            blk = _tile(x_views, rot_views, scal, bases, term_sizes)
            u = u + jnp.matmul(blk, v_rot,
                               precision=jax.lax.Precision.HIGHEST)
            rot_views = tuple(jax.lax.ppermute(xv, axis, perm)
                              for xv in rot_views)
            v_rot = jax.lax.ppermute(v_rot, axis, perm)
            return (u, rot_views, v_rot), None

        (u, _, _), _ = jax.lax.scan(step, (u0, x_views, v_loc), None,
                                    length=R)
        return u + diag_add * v_loc

    return matvec


def hutchinson_grads_sharded(params, X, alpha, w, z, mesh, kind="rbf",
                             jitter=1e-6, axis="r"):
    """Sharded gradient sweep given precomputed solves (round-4 VERDICT
    next #3): one reverse-mode pass of
    g(p) = 1/2 (alpha^T K(p) alpha - mean_z w^T K(p) z)
    with alpha/w/z held constant — the same estimator as
    inference/iterative.hutchinson_grads_program, with the matvec the
    ring ppermute schedule and every inner product a psum. alpha (n,),
    w/z (n, p) are global arrays (row-sharded by in_specs). Serves every
    kernel family (the tile algebra is the composite-aware one).
    """
    kernel_ops.validate_kind(kind)
    alpha = jax.lax.stop_gradient(alpha)
    w = jax.lax.stop_gradient(w)
    z = jax.lax.stop_gradient(z)
    a2 = (alpha[:, None] if alpha.ndim == 1 else alpha).astype(jnp.float32)
    num_probes = z.shape[1]

    def estimator(p):
        views, bases, term_sizes, scal = _views_scal(p, X, kind, jitter)

        def body(x_views, a_loc, w_loc, z_loc, scal):
            mv = _make_ring_matvec_diff(x_views, scal, bases, term_sizes,
                                        axis)
            # one ring sweep serves quad + trace: tiles contract against
            # [alpha | z] together (BBMM batching)
            U = mv(jnp.concatenate([a_loc, z_loc], axis=1))
            quad = jax.lax.psum(jnp.sum(a_loc * U[:, :1]), axis)
            tr = jax.lax.psum(jnp.sum(w_loc * U[:, 1:]), axis)
            return 0.5 * (quad - tr / num_probes)

        fn = shard_map(
            body, mesh=mesh,
            in_specs=(tuple(P(axis, None) for _ in views), P(axis, None),
                      P(axis, None), P(axis, None), P()),
            out_specs=P())
        return fn(views, a2, w, z, scal)

    return jax.grad(estimator)(params)


def fit_iterative_sharded(init_params, X, y, mesh, *, kind="rbf",
                          jitter=1e-6, axis="r", steps=50,
                          learning_rate=0.05, tol=1e-4, max_iters=400,
                          num_probes=16, precond_rank=128,
                          precond_refresh="auto", refresh_factor=1.5,
                          key=None, log_prior=None, callback=None,
                          verbose=False):
    """Matrix-free MAP fit over the ring — the DISTRIBUTED twin of
    inference/map_opt.fit_iterative (round-4 VERDICT next #3: the ring
    tier can now TRAIN, which with sampling closes config 5
    (BASELINE.json:11) in its matrix-free form).

    Per Adam step: one batched distributed CG for [y | z] (row-sharded
    Woodbury preconditioner), one sharded Hutchinson/AD gradient sweep
    (hutchinson_grads_sharded), host Adam update. The pivoted-Cholesky
    factors are built on the HOST from the global X (the pivot loop is
    O(n rank^2) float64 — setup work, not ring work) and consumed
    row-sharded; precond_refresh="auto" rebuilds when CG iterations
    exceed refresh_factor x the best since the last build.

    Given the same data/key/probes, matches single-device fit_iterative
    to reduction-order tolerance (tests/dist/test_sp_iterative.py).
    Returns (params, info) shaped like fit_iterative's.
    """
    import sys

    import numpy as np
    import optax

    from cugp_tpu.inference import iterative, map_opt

    kernel_ops.validate_kind(kind)
    if key is None:
        key = jax.random.key(0)
    n = X.shape[0]
    adaptive = precond_refresh == "auto"
    if adaptive:
        precond_refresh = 10 ** 9

    def build_precond(p):
        if not precond_rank:
            return None
        return iterative.precond_factors_host(p, X, precond_rank,
                                              kind=kind, jitter=jitter)

    prior_vg = (jax.jit(jax.value_and_grad(log_prior))
                if log_prior is not None else None)
    tx = optax.adam(learning_rate)
    params = init_params
    opt_state = tx.init(params)
    losses, cg_iters = [], []
    rebuilds = 0
    best_since = float("inf")
    need_rebuild = False
    precond = None
    for step in range(steps):
        if precond_rank and (precond is None or need_rebuild
                             or (not adaptive and step > 0
                                 and step % precond_refresh == 0)):
            precond = build_precond(params)
            rebuilds += 1
            best_since = float("inf")
            need_rebuild = False
        kstep = jax.random.fold_in(key, step)
        z = jax.random.rademacher(kstep, (n, num_probes),
                                  dtype=jnp.float32)
        B = jnp.concatenate([y[:, None], z], axis=1)
        sol, it = cg_solve_sharded(params, X, B, mesh, kind=kind,
                                   jitter=jitter, axis=axis, tol=tol,
                                   max_iters=max_iters, precond=precond)
        it = int(it)
        cg_iters.append(it)
        if adaptive and precond_rank:
            if it > refresh_factor * best_since:
                need_rebuild = True
            best_since = min(best_since, it)
        alpha, w = sol[:, 0], sol[:, 1:]
        grads = hutchinson_grads_sharded(params, X, alpha, w, z, mesh,
                                         kind=kind, jitter=jitter,
                                         axis=axis)
        value = -0.5 * jnp.dot(y, alpha)
        if prior_vg is not None:
            pv, pg = prior_vg(params)
            value = value + pv
            grads = jax.tree.map(jnp.add, grads, pg)
        neg = jax.tree.map(jnp.negative, grads)
        updates, opt_state = tx.update(neg, opt_state, params)
        params = map_opt._clamp(optax.apply_updates(params, updates))
        loss = -float(value)
        losses.append(loss)
        if callback is not None:
            callback(step, params, float(value), grads)
        if verbose:
            print(f"# fit_iterative_sharded step {step}: "
                  f"quad-obj={-loss:.4f} cg_it={it}",
                  file=sys.stderr, flush=True)
    info = {"loss": jnp.asarray(np.asarray(losses, np.float32)),
            "quad_obj": -losses[-1] if losses else float("nan"),
            "cg_iters": np.asarray(cg_iters, np.int32),
            "precond_rebuilds": rebuilds,
            "lml": float("nan")}
    return params, info


def make_sharded_logprob(init_params, X, y, mesh, *, kind="rbf",
                         jitter=1e-6, axis="r", tol=1e-5, max_iters=500,
                         num_probes=16, num_steps=32, probe_key=None,
                         precond=None, log_prior=None):
    """(logprob_and_grad, unravel, q0) over the flat hyperparameter
    vector with the SHARDED matrix-free LML — hyperparameter posteriors
    where each density evaluation is itself distributed over the ring
    (round-4 VERDICT next #4: config 5's sampling half, matrix-free).

    Per evaluation: _lml_parts_sharded (one program — batched [y|z]
    distributed CG + sharded SLQ) then hutchinson_grads_sharded (second
    program — the rematerialized ring AD sweep). Probes are drawn ONCE
    and frozen (same pseudo-target trade as
    sampling.make_iterative_logprob, documented there); chains are
    replicated (dim is tiny), only the likelihood is sharded.
    """
    from jax.flatten_util import ravel_pytree

    from cugp_tpu.inference import hmc as hmc_lib

    if log_prior is None:
        log_prior = hmc_lib.default_log_prior
    q0, unravel = ravel_pytree(init_params)
    if probe_key is None:
        probe_key = jax.random.key(7)
    n = X.shape[0]
    z = jax.random.rademacher(probe_key, (n, num_probes),
                              dtype=jnp.float32)

    def logprob_and_grad(q):
        p = unravel(q)
        value, alpha, w, _it = _lml_parts_sharded(
            p, X, y, z, mesh, kind=kind, jitter=jitter, axis=axis,
            tol=tol, max_iters=max_iters, num_steps=num_steps,
            precond=precond)
        grads = hutchinson_grads_sharded(p, X, alpha[:, 0], w, z, mesh,
                                         kind=kind, jitter=jitter,
                                         axis=axis)
        g_lml = ravel_pytree(grads)[0]
        pv, pg = jax.value_and_grad(log_prior)(q)
        return value + pv, g_lml + pg

    return logprob_and_grad, unravel, q0


def sample_hyperparams_sharded(init_params, X, y, mesh, *, kind="rbf",
                               jitter=1e-6, axis="r", num_samples=256,
                               num_chains=8, num_warmup=128,
                               sampler="hmc", key=None, n_leapfrog=16,
                               max_tree_depth=8, eps0=0.05,
                               target_accept=0.8, tol=1e-5, max_iters=500,
                               num_probes=16, num_steps=32,
                               precond_rank=0, probe_key=None,
                               log_prior=None):
    """NUTS/HMC over kernel hyperparameters with the SHARDED matrix-free
    LML — both halves of config 5 (BASELINE.json:11) in matrix-free
    form: every transition's density is a ring-distributed CG+SLQ, and
    the gradient a sharded AD sweep. Same contract as
    sampling.sample_hyperparams_iterative.
    """
    from cugp_tpu.inference import hmc as hmc_lib
    from cugp_tpu.inference import iterative, nuts as nuts_lib, sampling

    if key is None:
        key = jax.random.key(0)
    precond = None
    if precond_rank:
        precond = iterative.precond_factors_host(
            init_params, X, precond_rank, kind=kind, jitter=jitter)
    lp_kw = {} if log_prior is None else {"log_prior": log_prior}
    logprob_and_grad, unravel, q0 = make_sharded_logprob(
        init_params, X, y, mesh, kind=kind, jitter=jitter, axis=axis,
        tol=tol, max_iters=max_iters, num_probes=num_probes,
        num_steps=num_steps, probe_key=probe_key, precond=precond,
        **lp_kw)
    key_init, key_run = jax.random.split(key)
    qs0 = sampling.init_chains(q0, key_init, num_chains)
    if sampler == "nuts":
        out = nuts_lib.run_nuts(
            qs0, key_run, logprob_and_grad, max_depth=max_tree_depth,
            num_warmup=num_warmup, num_samples=num_samples, eps0=eps0,
            target_accept=target_accept)
    elif sampler == "hmc":
        out = hmc_lib.run_hmc(
            qs0, key_run, logprob_and_grad, n_leapfrog=n_leapfrog,
            num_warmup=num_warmup, num_samples=num_samples, eps0=eps0,
            target_accept=target_accept)
    else:
        raise ValueError(f"unknown sampler: {sampler}")
    flat = out.pop("samples_flat")
    out["samples"] = jax.vmap(jax.vmap(unravel))(flat)
    out["samples_flat"] = flat
    return out
