"""Iterative (CG/Lanczos) exact-GP inference — beyond-reference surface.

Matrix-free BBMM-style inference (cf. PAPERS.md: "Blackbox Matrix-Matrix
Gaussian Process Inference", public technique): the covariance is never
materialized — posterior solves run batched conjugate gradients against a
blocked kernel matvec (memory O(N * block) instead of O(N^2)), and the
log-determinant is estimated by stochastic Lanczos quadrature. This lifts
the N <= 32k single-chip ceiling of the dense Cholesky path (a 100k x 100k
fp32 K is 40 GB; the matvec needs ~100 MB of tiles).

Shape: on the GPU each matvec is one fused Pallas/Triton kernel that
builds covariance tiles in registers and contracts them at once
(ops/matvec_pallas.py); elsewhere a (block x N) tile build plus a
(block x N) @ (N x rhs) GEMM per lax.map step. CG/Lanczos iterations are
lax.while_loop/scan — the whole solve is one XLA program.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cugp_tpu.ops import kernels as kernel_ops
from cugp_tpu.ops import matvec_pallas

_HI = jax.lax.Precision.HIGHEST
LOG2PI = math.log(2.0 * math.pi)


def matvec_method(X, kind):
    """What make_matvec(method="auto") runs: the fused Pallas kernel on
    the GPU for base kinds whose (embedded) feature dim fits it, the
    blocked XLA tiles everywhere else. The kernel is single-family, so
    composites always take the XLA tiles."""
    d = X.shape[1] * (2 if kind == "periodic" else 1)
    if (jax.default_backend() == "gpu" and d <= matvec_pallas.MAX_D
            and not kernel_ops.is_composite(kind)):
        return "pallas"
    return "xla"


@partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6))
def _fused_matvec(params, X, v, kind, jitter, block, interpret):
    return matvec_pallas.train_cov_matvec(params, X, v, kind=kind,
                                          jitter=jitter, interpret=interpret)


def _fused_matvec_fwd(params, X, v, kind, jitter, block, interpret):
    out = _fused_matvec(params, X, v, kind, jitter, block, interpret)
    return out, (params, X, v)


def _fused_matvec_bwd(kind, jitter, block, interpret, res, g):
    # Pallas kernels have no JVP rule: the backward pass differentiates
    # the mathematically identical blocked XLA matvec (rematerialized)
    params, X, v = res
    _, vjp = jax.vjp(
        lambda p, x, u: make_matvec(p, x, kind=kind, jitter=jitter,
                                    block=block, method="xla")(u),
        params, X, v)
    return vjp(g)


_fused_matvec.defvjp(_fused_matvec_fwd, _fused_matvec_bwd)


def make_matvec(params, X, kind="rbf", jitter=1e-6, block=4096,
                method="auto", interpret=False):
    """v -> (K(X,X) + noise I) v without materializing K.

    method="pallas" (what "auto" picks on the GPU, see matvec_method):
    the fused Pallas/Triton kernel builds each covariance tile in
    registers and contracts it at once, so no O(N^2) bytes reach device
    memory (ops/matvec_pallas.py); its gradient runs through the XLA
    tiles. interpret=True runs that kernel in the Pallas interpreter.
    method="xla": row blocks built on the fly with lax.map.
    v may be (n,) or (n, r).
    """
    if method == "auto":
        method = matvec_method(X, kind)
    if method == "pallas":
        kernel_ops.require_base_kind(kind, "make_matvec(method='pallas')")
        return lambda v: _fused_matvec(params, X, v, kind, jitter, block,
                                       interpret)
    if method != "xla":
        raise ValueError(f"unknown matvec method {method!r}: auto | xla | "
                         "pallas")
    n = X.shape[0]
    sf2 = kernel_ops.signal_scale(params)
    sn2 = jnp.exp(params["log_noise_var"])
    diag_add = sn2 + jitter * sf2
    nb = -(-n // block)
    npad = nb * block

    # per-factor scaled views (one term/one factor for base kinds); every
    # view is padded identically so row slices line up across factors
    amps, term_sizes, views, bases, extras = [], [], [], [], []
    for amp, factors in kernel_ops.flatten_terms(params, kind):
        amps.append(amp)
        term_sizes.append(len(factors))
        for base, fp in factors:
            xs, b2, extra = kernel_ops.factor_view(fp, X, base)
            views.append(jnp.pad(xs, ((0, npad - n), (0, 0))))
            bases.append(b2)
            extras.append(extra)

    def cov_block(i):
        """One (block, n) composite tile: sum_t amp_t prod_f tile_f."""
        kb = None
        f = 0
        for t, nf in enumerate(term_sizes):
            term = None
            for _ in range(nf):
                rows = jax.lax.dynamic_slice(
                    views[f], (i * block, 0), (block, views[f].shape[1]))
                kf = kernel_ops.tile_eval(rows, views[f][:n], bases[f],
                                          extras[f])
                term = kf if term is None else term * kf
                f += 1
            term = amps[t] * term
            kb = term if kb is None else kb + term
        return kb

    def matvec(v):
        vec = v.ndim == 1
        v2 = v[:, None] if vec else v

        # remat: when this matvec is DIFFERENTIATED (the AD gradient
        # estimator in lml_value_and_grad_iterative), the backward pass
        # rebuilds each (block, n) tile instead of saving it — without
        # this, lax.map stores O(n^2) of tile residuals. No-op when the
        # matvec is only evaluated.
        @jax.checkpoint
        def one_block(i):
            return jnp.dot(cov_block(i), v2, precision=_HI)  # (block, r)

        out = jax.lax.map(one_block, jnp.arange(nb))  # (nb, block, r)
        out = out.reshape(npad, -1)[:n]
        out = out + diag_add * v2
        return out[:, 0] if vec else out

    return matvec


class CGState(NamedTuple):
    x: jnp.ndarray
    r: jnp.ndarray
    p: jnp.ndarray
    rs: jnp.ndarray
    it: jnp.ndarray


def pivoted_cholesky(params, X, rank, kind="rbf"):
    """Rank-`rank` partial pivoted Cholesky of the NOISE-FREE kernel
    matrix Kf (Harbrecht et al.; the BBMM preconditioner recipe, cf.
    PAPERS.md "Blackbox Matrix-Matrix GP Inference").

    Greedy: at each step pick the column with the largest residual
    diagonal, evaluate that single kernel column exactly (O(n d) — K is
    never formed), and deflate. Returns Lk (n, rank) with
    Kf ~ Lk Lk^T; the approximation error is bounded by the residual
    diagonal trace (returned as the second value).
    """
    n, d = X.shape
    diag0 = kernel_ops.kernel_diag(params, X, kind)

    # per-factor scaled views so a single kernel COLUMN evaluates as the
    # same sum-of-products tile recipe the matvec uses (works for every
    # base family and composite without materializing K)
    amps, term_sizes, views, bases, extras = [], [], [], [], []
    for amp, factors in kernel_ops.flatten_terms(params, kind):
        amps.append(amp)
        term_sizes.append(len(factors))
        for base, fp in factors:
            xs, b2, extra = kernel_ops.factor_view(fp, X, base)
            views.append(xs)
            bases.append(b2)
            extras.append(extra)

    def col(j):
        out = None
        f = 0
        for t, nf in enumerate(term_sizes):
            term = None
            for _ in range(nf):
                xj = jax.lax.dynamic_slice(
                    views[f], (j, 0), (1, views[f].shape[1]))
                kf = kernel_ops.tile_eval(views[f], xj, bases[f],
                                          extras[f])[:, 0]
                term = kf if term is None else term * kf
                f += 1
            term = amps[t] * term
            out = term if out is None else out + term
        return out

    def step(carry, i):
        dres, Lk = carry
        j = jnp.argmax(dres)
        c = col(j)
        lj = Lk[j, :]  # (rank,) — zeros beyond step i
        ci = c - jnp.matmul(Lk, lj[:, None], precision=_HI)[:, 0]
        piv = jnp.sqrt(jnp.maximum(dres[j], 1e-12))
        li = ci / piv
        li = li.at[j].set(piv)  # exact by construction; guards fp noise
        Lk = Lk.at[:, i].set(li)
        dres = jnp.maximum(dres - li * li, 0.0)
        dres = dres.at[j].set(0.0)
        return (dres, Lk), None

    Lk0 = jnp.zeros((n, rank), X.dtype)
    (dres, Lk), _ = jax.lax.scan(step, (diag0, Lk0), jnp.arange(rank))
    return Lk, jnp.sum(dres)


def pivoted_cholesky_host(params, X, rank, kind="rbf"):
    """Host (NumPy float64) greedy pivoted Cholesky of the noise-free
    kernel — the robust construction path for the preconditioner.

    The pivot recurrence is sequential and latency-bound (argmax +
    one exact kernel column per step, O(n rank^2) total) — cold-path
    setup work; the default builds it on device (pivoted_cholesky) and
    this float64 host version is the cross-check and the explicit
    precond_where="host" option. The hot O(n^2) paths (CG matvecs, SLQ)
    stay on device either way.
    Column evaluations ride the float64 oracle (all kernel families
    incl. composites). Returns (Lk (n, rank) float32, residual trace).
    """
    import numpy as np

    from cugp_tpu.oracle import exact_gp_np as onp

    # fetch device-resident inputs ONCE — the column loop below calls the
    # oracle ~rank times, and per-call np.asarray() on device params
    # would pay a device-to-host copy per leaf per column
    params = jax.tree.map(lambda a: np.asarray(a), params)
    Xh = np.asarray(X, np.float64)
    n = Xh.shape[0]
    dres = np.asarray(onp.kernel_diag(params, Xh, kind), np.float64).copy()
    if dres.shape == ():  # constant diag (stationary kernels)
        dres = np.full(n, float(dres))
    elif dres.shape != (n,):
        dres = np.broadcast_to(dres, (n,)).copy()
    Lk = np.zeros((n, rank))
    for i in range(rank):
        j = int(np.argmax(dres))
        c = onp.kernel_matrix(params, Xh, Xh[j:j + 1], kind)[:, 0]
        if i:
            c = c - Lk[:, :i] @ Lk[j, :i]
        piv = np.sqrt(max(dres[j], 1e-12))
        li = c / piv
        li[j] = piv
        Lk[:, i] = li
        dres = np.maximum(dres - li * li, 0.0)
        dres[j] = 0.0
    return Lk.astype(np.float32), float(dres.sum())


def precond_factors_host(params, X, rank, kind="rbf", jitter=1e-6,
                         verbose=False):
    """Host-built (Lk, Lg, s2) — see pivoted_cholesky_host. Drop-in for
    precond_factors; returns device arrays. ALL math (incl. signal_scale
    for composite amplitudes) runs in NumPy — no device programs."""
    import sys

    import numpy as np

    def log(msg):
        if verbose:
            print(f"#   precond_host: {msg}", file=sys.stderr, flush=True)

    log("pivot loop")
    Lk, _resid = pivoted_cholesky_host(params, X, rank, kind=kind)
    log("scalars")
    ph = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    if "terms" in ph:  # composite: total amplitude = sum of term amps
        sf2 = float(sum(np.exp(t["log_signal_var"]) for t in ph["terms"]))
    else:
        sf2 = float(np.exp(ph["log_signal_var"]))
    s2 = float(np.exp(ph["log_noise_var"])) + jitter * sf2
    G = s2 * np.eye(rank) + Lk.astype(np.float64).T @ Lk.astype(np.float64)
    Lg = np.linalg.cholesky(G)
    log("device upload")
    out = (jnp.asarray(Lk), jnp.asarray(Lg, jnp.float32),
           jnp.float32(s2))
    log("done")
    return out


def precond_factors(params, X, rank, kind="rbf", jitter=1e-6):
    """Arrays (Lk, Lg, s2) for P = Lk Lk^T + s2 I (s2 = noise+jitter).

    Run this as its OWN jitted program and feed the factors to
    precond_apply_from_factors / cg_solve: one preconditioner serves
    every solve at the same hyperparameters.
    """
    from cugp_tpu.ops import cholesky as chol_ops

    sf2 = kernel_ops.signal_scale(params)
    s2 = jnp.exp(params["log_noise_var"]) + jitter * sf2
    Lk, _resid = pivoted_cholesky(params, X, rank, kind=kind)
    G = s2 * jnp.eye(rank, dtype=X.dtype) + jnp.matmul(
        Lk.mT, Lk, precision=_HI)
    Lg = chol_ops.cholesky(G, method="xla")
    return Lk, Lg, s2


def precond_apply_from_factors(Lk, Lg, s2):
    """P^-1 apply from precomputed factors, via Woodbury:
    P^-1 r = (r - Lk (s2 I_k + Lk^T Lk)^-1 Lk^T r) / s2 — a rank-k solve
    per CG iteration (the k x k Cholesky Lg is already done)."""
    from cugp_tpu.ops import trsm as trsm_ops

    def apply_p(r):
        t = jnp.matmul(Lk.mT, r, precision=_HI)          # (k, rhs)
        t = trsm_ops.cho_solve(Lg, t)
        return (r - jnp.matmul(Lk, t, precision=_HI)) / s2

    return apply_p


def make_pivoted_precond(params, X, rank, kind="rbf", jitter=1e-6):
    """One-program convenience: precond_factors + apply closure (the BBMM
    preconditioner). To share one set of factors across solves, call
    the two pieces separately (see precond_factors)."""
    return precond_apply_from_factors(
        *precond_factors(params, X, rank, kind=kind, jitter=jitter))


def _cg_apply_m(precond_apply, precond_diag):
    minv = (1.0 / precond_diag)[:, None] if precond_diag is not None else None

    def apply_m(r):
        if precond_apply is not None:
            return precond_apply(r)
        return r * minv if minv is not None else r

    return apply_m


def _cg_body(matvec, apply_m):
    def body(s):
        ap = matvec(s.p)
        denom = jnp.sum(s.p * ap, axis=0)
        alpha = s.rs / jnp.where(denom == 0, 1.0, denom)
        x = s.x + alpha[None, :] * s.p
        r = s.r - alpha[None, :] * ap
        z = apply_m(r)
        rs_new = jnp.sum(r * z, axis=0)
        beta = rs_new / jnp.where(s.rs == 0, 1.0, s.rs)
        p = z + beta[None, :] * s.p
        return CGState(x=x, r=r, p=p, rs=rs_new, it=s.it + 1)

    return body


def cg_init(b, precond_apply=None, precond_diag=None, x0=None, matvec=None):
    """Initial CGState for solving K x = b (b is (n, r)).

    x0: optional warm start (same shape as b) — pays ONE matvec to form
    the true residual r0 = b - K x0 and starts CG there. The standard
    trick for slowly-moving systems (fit_iterative's per-step solves at
    nearly-unchanged hyperparameters: round-4 VERDICT next #5); requires
    `matvec`. x0=None starts from zero (r0 = b, no matvec).
    """
    apply_m = _cg_apply_m(precond_apply, precond_diag)
    if x0 is None:
        x, r = jnp.zeros_like(b), b
    else:
        if matvec is None:
            raise ValueError("cg_init(x0=...) needs the matvec for r0")
        x, r = x0, b - matvec(x0)
    z0 = apply_m(r)
    return CGState(x=x, r=r, p=z0,
                   rs=jnp.sum(r * z0, axis=0),
                   it=jnp.asarray(0, jnp.int32))


def cg_segment(matvec, state, num_iters, precond_apply=None,
               precond_diag=None):
    """Run exactly num_iters CG iterations from `state` (lax.scan body).

    The resumable half of the segmented schedule: K-iteration chunks with
    the CGState carried ACROSS program invocations bound each program's
    work and let a long solve stop and resume — same pattern as
    hmc.sample_segment. CG's recurrence needs only (x, r, p, rs), so
    composing segments is exact: segment(A) then segment(B) equals one
    segment(A+B) run up to fp reassociation.
    """
    body = _cg_body(matvec, _cg_apply_m(precond_apply, precond_diag))

    def scan_body(s, _):
        return body(s), None

    state, _ = jax.lax.scan(scan_body, state, None, length=num_iters)
    return state


def cg_solve(matvec, b, tol=1e-6, max_iters=1000, precond_diag=None,
             fixed_iters=False, precond_apply=None):
    """Batched conjugate gradients for SPD systems; b is (n,) or (n, r).

    precond_diag: optional (n,) Jacobi preconditioner diagonal.
    precond_apply: optional callable r -> M^-1 r (e.g. the pivoted-
    Cholesky preconditioner from make_pivoted_precond); takes precedence
    over precond_diag.
    fixed_iters: run exactly max_iters via lax.scan (no data-dependent
    while_loop — deterministic schedule, and a workaround for backends
    where long while_loops are fragile). Returns (x, iterations_used).
    """
    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    apply_m = _cg_apply_m(precond_apply, precond_diag)

    bnorm = jnp.maximum(jnp.linalg.norm(b2, axis=0), 1e-30)
    s0 = cg_init(b2, precond_apply, precond_diag)

    def cond(s):
        rel = jnp.linalg.norm(s.r, axis=0) / bnorm
        return (s.it < max_iters) & jnp.any(rel > tol)

    body = _cg_body(matvec, apply_m)
    if fixed_iters:
        def scan_body(s, _):
            return body(s), None

        s, _ = jax.lax.scan(scan_body, s0, None, length=max_iters)
    else:
        s = jax.lax.while_loop(cond, body, s0)
    x = s.x[:, 0] if vec else s.x
    return x, s.it


def cg_solve_segmented(params, X, b, *, kind="rbf", jitter=1e-6,
                       block=4096, tol=1e-4, iters_per_program=64,
                       max_iters=1024, precond=None, x0=None,
                       verbose=False):
    """Host-segmented CG solve of (K + noise I) x = b.

    Each XLA program runs `iters_per_program` CG iterations
    (cg_segment); the CGState round-trips through the host between
    programs, and the host checks convergence from the carried residual.
    This bounds per-program work regardless of total iteration count.
    b may be (n,) or (n, r); precond is
    optional (Lk, Lg, s2) factors from precond_factors[_host].

    x0: optional warm start (see cg_init) — the first segment pays one
    extra matvec for the true residual.

    Returns (x, total_iters, rel_residual) with the residual taken from
    the carried r (fp32 in-loop estimate; callers wanting a certificate
    recompute with one extra matvec).
    """
    import sys

    import numpy as np

    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    if x0 is not None and x0.ndim == 1:
        x0 = x0[:, None]
    bnorms = np.maximum(np.asarray(jnp.linalg.norm(b2, axis=0)), 1e-30)

    state = None
    total = 0
    rel = np.asarray([np.inf])
    while total < max_iters:
        if state is None and x0 is not None:
            state = _cg_warm_init_program(params, X, b2, x0, precond,
                                          kind=kind, jitter=jitter,
                                          block=block)
        state = _cg_segment_program(params, X, b2, state, precond,
                                    kind=kind, jitter=jitter, block=block,
                                    num_iters=iters_per_program)
        total += iters_per_program
        # one small host fetch per segment: the per-column residual norms
        rel = np.asarray(jnp.linalg.norm(state.r, axis=0)) / bnorms
        if verbose:
            print(f"#   cg_segmented: it={total} max_rel={rel.max():.3e}",
                  file=sys.stderr, flush=True)
        if float(rel.max()) <= tol:
            break
    x = state.x[:, 0] if vec else state.x
    return x, total, float(rel.max())


@partial(jax.jit, static_argnames=("kind", "jitter", "block", "num_iters"))
def _cg_segment_program(params, X, b2, state, precond, kind="rbf",
                        jitter=1e-6, block=4096, num_iters=64):
    """One resumable CG segment as its own program (see cg_solve_segmented)."""
    mv = make_matvec(params, X, kind=kind, jitter=jitter, block=block)
    pre = precond_apply_from_factors(*precond) if precond is not None else None
    if state is None:
        state = cg_init(b2, precond_apply=pre)
    return cg_segment(mv, state, num_iters, precond_apply=pre)


@partial(jax.jit, static_argnames=("kind", "jitter", "block"))
def _cg_warm_init_program(params, X, b2, x0, precond, kind="rbf",
                          jitter=1e-6, block=4096):
    """Warm-start CGState as its own small program (one matvec)."""
    mv = make_matvec(params, X, kind=kind, jitter=jitter, block=block)
    pre = precond_apply_from_factors(*precond) if precond is not None else None
    return cg_init(b2, precond_apply=pre, x0=x0, matvec=mv)


# ---- Segmented Lanczos / SLQ (the cg_segment pattern for the logdet) --

class LanczosState(NamedTuple):
    q_prev: jnp.ndarray  # (n, p)
    q: jnp.ndarray       # (n, p)
    beta: jnp.ndarray    # (p,) — beta feeding the NEXT step
    it: jnp.ndarray


@partial(jax.jit, static_argnames=("kind", "jitter", "block", "num_iters"))
def _lanczos_segment_program(params, X, Z, state, kind="rbf", jitter=1e-6,
                             block=4096, num_iters=8):
    """`num_iters` batched-Lanczos steps as one program.

    state=None starts from the normalized probe block Z (n, p); otherwise
    resumes the three-term recurrence exactly (it carries only
    (q_prev, q, beta), so segments compose like cg_segment). Returns
    (new_state, alphas_chunk (num_iters, p), betas_chunk (num_iters, p)).
    No reorthogonalization is lost by splitting: the plain SLQ recurrence
    never had it (see lanczos_tridiag_batched).
    """
    mv = make_matvec(params, X, kind=kind, jitter=jitter, block=block)
    if state is None:
        q0 = Z / jnp.linalg.norm(Z, axis=0, keepdims=True)
        state = LanczosState(q_prev=jnp.zeros_like(q0), q=q0,
                             beta=jnp.zeros((Z.shape[1],), Z.dtype),
                             it=jnp.asarray(0, jnp.int32))

    def step(carry, _):
        q_prev, q, beta_prev = carry
        v = mv(q) - beta_prev[None, :] * q_prev
        alpha = jnp.sum(q * v, axis=0)
        v = v - alpha[None, :] * q
        beta = jnp.linalg.norm(v, axis=0)
        q_next = v / jnp.where(beta == 0, 1.0, beta)[None, :]
        return (q, q_next, beta), (alpha, beta)

    (qp, q, b), (alphas, betas) = jax.lax.scan(
        step, (state.q_prev, state.q, state.beta), None, length=num_iters)
    return (LanczosState(q_prev=qp, q=q, beta=b, it=state.it + num_iters),
            alphas, betas)


def slq_logdet_segmented(params, X, n, key, *, kind="rbf", jitter=1e-6,
                         block=4096, num_probes=16, num_steps=32,
                         iters_per_program=8, verbose=False):
    """SLQ logdet with the Lanczos recurrence split across programs.

    Equivalent to slq_logdet (same probes, same estimator) but no single
    program runs more than `iters_per_program` matvecs — the schedule
    that bounds each program's work. Quadrature (tiny (m,m) eigh per probe)
    runs on the host in float64.
    """
    import sys

    import numpy as np

    Z = jax.random.rademacher(key, (n, num_probes), dtype=jnp.float32)
    state = None
    a_chunks, b_chunks = [], []
    done = 0
    while done < num_steps:
        seg = min(iters_per_program, num_steps - done)
        state, al, be = _lanczos_segment_program(
            params, X, Z, state, kind=kind, jitter=jitter, block=block,
            num_iters=seg)
        a_chunks.append(np.asarray(al))
        b_chunks.append(np.asarray(be))
        done += seg
        if verbose:
            print(f"#   slq_segmented: step={done}/{num_steps}",
                  file=sys.stderr, flush=True)
    alphas = np.concatenate(a_chunks, axis=0)       # (m, p)
    betas = np.concatenate(b_chunks, axis=0)[:-1]   # (m-1, p)

    total = 0.0
    for j in range(num_probes):
        t = (np.diag(alphas[:, j].astype(np.float64))
             + np.diag(betas[:, j].astype(np.float64), 1)
             + np.diag(betas[:, j].astype(np.float64), -1))
        evals, evecs = np.linalg.eigh(t)
        evals = np.maximum(evals, 1e-30)
        w = evecs[0, :] ** 2
        total += float(np.sum(w * np.log(evals))) * float(n)
    return total / num_probes


def lml_iterative_segmented(params, X, y, key=None, *, kind="rbf",
                            jitter=1e-6, block=4096, tol=1e-4,
                            iters_per_program=16, max_iters=1024,
                            num_probes=16, num_steps=32, precond=None,
                            verbose=False):
    """LML via segmented CG + segmented SLQ — the unbounded-n schedule.

    Same estimator as lml_iterative (CG quadratic term + SLQ logdet) with
    every device program bounded to ~iters_per_program matvecs; the
    public large-n path (GP.log_marginal_likelihood_iterative routes
    here above the single-program envelope). Returns a float.
    """
    kernel_ops.validate_kind(kind)
    if key is None:
        key = jax.random.key(0)
    alpha, _it, _rel = cg_solve_segmented(
        params, X, y, kind=kind, jitter=jitter, block=block, tol=tol,
        iters_per_program=iters_per_program, max_iters=max_iters,
        precond=precond, verbose=verbose)
    n = y.shape[0]
    logdet = slq_logdet_segmented(
        params, X, n, key, kind=kind, jitter=jitter, block=block,
        num_probes=num_probes, num_steps=num_steps,
        iters_per_program=max(1, iters_per_program // 2), verbose=verbose)
    quad = float(jnp.dot(y, alpha))
    return -0.5 * quad - 0.5 * logdet - 0.5 * n * LOG2PI


@partial(jax.jit, static_argnames=("kind",))
def _cross_cov_program(params, X, Xs_chunk, kind="rbf"):
    """One (n, m_chunk) cross-covariance tile as its own program."""
    return kernel_ops.cross_covariance_xla(params, X, Xs_chunk, kind)


def posterior_iterative_segmented(params, X, y, Xs, *, kind="rbf",
                                  jitter=1e-6, block=4096, tol=1e-4,
                                  iters_per_program=16, max_iters=1024,
                                  include_noise=False, precond=None,
                                  col_batch=256, verbose=False):
    """Matrix-free posterior with BOTH large-n safeguards: segmented CG
    (per-program work bounded regardless of iteration count) and
    column-tiled test covariance (round-4 VERDICT next #1 + #9).

    The one-program posterior_iterative materializes the full (n, m)
    cross-covariance and solves all m variance columns in one CG — at
    n=262k, m=2048 that is ~2 GB of Ks plus 4 same-size CG work vectors.
    Here test points stream through in `col_batch`-column chunks: each
    chunk is one small cross-covariance program plus a segmented CG whose
    per-program iteration count is scaled down with the RHS width so
    device work per program stays ~constant.

    Returns (mu, var) as (m,) arrays on the host.
    """
    import numpy as np

    kernel_ops.validate_kind(kind)
    n = X.shape[0]
    m = Xs.shape[0]
    alpha, _it, _rel = cg_solve_segmented(
        params, X, y, kind=kind, jitter=jitter, block=block, tol=tol,
        iters_per_program=iters_per_program, max_iters=max_iters,
        precond=precond, verbose=verbose)
    kss = np.asarray(kernel_ops.kernel_diag(params, Xs, kind))
    if kss.shape == ():
        kss = np.full(m, float(kss), np.float32)
    sn2 = float(np.exp(np.asarray(params["log_noise_var"])))

    mus = np.zeros(m, np.float32)
    var_q = np.zeros(m, np.float32)
    for j0 in range(0, m, col_batch):
        Xs_c = Xs[j0:j0 + col_batch]
        mc = Xs_c.shape[0]
        Ks_c = _cross_cov_program(params, X, Xs_c, kind=kind)  # (n, mc)
        mus[j0:j0 + mc] = np.asarray(
            jnp.matmul(Ks_c.mT, alpha[:, None], precision=_HI)[:, 0])
        # per-program iteration budget scales inversely with RHS width so
        # matvec work per program stays ~iters_per_program single-RHS
        # matvec-equivalents (the crash ceiling is per-program WORK)
        it_pp = max(1, (iters_per_program * 16) // max(16, mc))
        w_c, _it, _rel = cg_solve_segmented(
            params, X, Ks_c, kind=kind, jitter=jitter, block=block,
            tol=tol, iters_per_program=it_pp, max_iters=max_iters,
            precond=precond, verbose=verbose)
        var_q[j0:j0 + mc] = np.asarray(jnp.sum(Ks_c * w_c, axis=0))
    var = kss - var_q
    if include_noise:
        var = var + sn2
    return jnp.asarray(mus), jnp.asarray(np.maximum(var, 0.0))


def lanczos_tridiag(matvec, z, num_steps):
    """Lanczos on SPD operator from start vector z: returns (alphas, betas).

    Full orthogonalization is skipped (standard for SLQ); num_steps is
    static. alphas (m,), betas (m-1,).
    """
    n = z.shape[0]
    q0 = z / jnp.linalg.norm(z)

    def step(carry, _):
        q_prev, q, beta_prev = carry
        v = matvec(q) - beta_prev * q_prev
        alpha = jnp.dot(q, v)
        v = v - alpha * q
        beta = jnp.linalg.norm(v)
        q_next = v / jnp.where(beta == 0, 1.0, beta)
        return (q, q_next, beta), (alpha, beta)

    (_, _, _), (alphas, betas) = jax.lax.scan(
        step, (jnp.zeros(n), q0, jnp.asarray(0.0)), None, length=num_steps)
    return alphas, betas[:-1]


def lanczos_tridiag_batched(matvec, Z, num_steps):
    """Lanczos on SPD operator for a BLOCK of start vectors Z (n, p).

    Each Lanczos step is ONE multi-RHS matvec on the (n, p) block — on the
    fused Pallas matvec the covariance tiles are built once per step and
    contracted against all p probes, so p probes cost ~the same as one
    (the BBMM batching insight). Probes stay independent (no block
    orthogonalization): per-probe scalars ride as (p,) vectors.
    Returns (alphas (m, p), betas (m-1, p)).
    """
    n, p = Z.shape
    q0 = Z / jnp.linalg.norm(Z, axis=0, keepdims=True)

    def step(carry, _):
        q_prev, q, beta_prev = carry
        v = matvec(q) - beta_prev[None, :] * q_prev
        alpha = jnp.sum(q * v, axis=0)
        v = v - alpha[None, :] * q
        beta = jnp.linalg.norm(v, axis=0)
        q_next = v / jnp.where(beta == 0, 1.0, beta)[None, :]
        return (q, q_next, beta), (alpha, beta)

    (_, _, _), (alphas, betas) = jax.lax.scan(
        step, (jnp.zeros((n, p)), q0, jnp.zeros((p,))), None,
        length=num_steps)
    return alphas, betas[:-1]


def slq_logdet(matvec, n, key, num_probes=16, num_steps=32):
    """Stochastic Lanczos quadrature estimate of log det(K).

    E_z[z^T log(K) z] with Rademacher probes; each probe's quadratic form
    is evaluated from the eigendecomposition of its Lanczos tridiagonal.
    All probes advance together through batched Lanczos — num_steps
    multi-RHS matvecs total, not num_probes * num_steps.
    """
    Z = jax.random.rademacher(key, (n, num_probes), dtype=jnp.float32)
    alphas, betas = lanczos_tridiag_batched(matvec, Z, num_steps)

    def quad(a, b):  # per-probe tridiagonal quadrature
        t = jnp.diag(a) + jnp.diag(b, 1) + jnp.diag(b, -1)
        evals, evecs = jnp.linalg.eigh(t)
        evals = jnp.maximum(evals, 1e-30)
        # z^T log(K) z ~ ||z||^2 * sum_i (e1^T v_i)^2 log(lambda_i)
        w = evecs[0, :] ** 2
        return jnp.sum(w * jnp.log(evals)) * float(n)

    return jnp.mean(jax.vmap(quad, in_axes=(1, 1))(alphas, betas))


@partial(jax.jit, static_argnames=("kind", "jitter", "block", "tol",
                                   "max_iters", "num_probes", "num_steps",
                                   "precond_rank"))
def lml_iterative(params, X, y, key=None, kind="rbf", jitter=1e-6,
                  block=4096, tol=1e-5, max_iters=500, num_probes=16,
                  num_steps=32, precond_rank=0, precond=None):
    """LML via CG (quadratic term) + SLQ (logdet). Matrix-free.

    Stochastic in the logdet term: MC error ~ O(1/sqrt(num_probes)) —
    suitable for hyperparameter search at scales where dense Cholesky
    cannot run; use the dense path when it fits.
    precond_rank > 0: pivoted-Cholesky preconditioned CG (the BBMM
    recipe) — large lengthscale / small noise kernels converge in far
    fewer iterations. precond: precomputed (Lk, Lg, s2) factors from
    precond_factors (takes precedence; keeps this program small at
    n >= 64k — see precond_factors docstring).
    """
    kernel_ops.validate_kind(kind)
    if key is None:
        key = jax.random.key(0)
    mv = make_matvec(params, X, kind=kind, jitter=jitter, block=block)
    if precond is not None:
        pre = precond_apply_from_factors(*precond)
    else:
        pre = (make_pivoted_precond(params, X, precond_rank, kind=kind,
                                    jitter=jitter) if precond_rank else None)
    alpha, _ = cg_solve(mv, y, tol=tol, max_iters=max_iters,
                        precond_apply=pre)
    n = y.shape[0]
    logdet = slq_logdet(mv, n, key, num_probes=num_probes,
                        num_steps=num_steps)
    return -0.5 * jnp.dot(y, alpha) - 0.5 * logdet - 0.5 * n * LOG2PI


@partial(jax.jit, static_argnames=("kind", "jitter", "block", "tol",
                                   "max_iters", "include_noise",
                                   "precond_rank"))
def posterior_iterative(params, X, y, Xs, kind="rbf", jitter=1e-6,
                        block=4096, tol=1e-6, max_iters=1000,
                        include_noise=False, precond=None, precond_rank=0):
    """Posterior mean + diagonal variance via CG solves (matrix-free).

    mean: K*^T (K^-1 y). variance: k** - diag(K*^T K^-1 K*), with one CG
    solve per test batch column (batched rhs).

    precond: optional (Lk, Lg, s2) pivoted-Cholesky factors from
    precond_factors[_host] — the production path at large n (the BBMM
    preconditioner cuts CG iterations several-fold on smooth kernels).
    precond_rank > 0 builds the factors inside THIS program instead.
    """
    kernel_ops.validate_kind(kind)
    mv = make_matvec(params, X, kind=kind, jitter=jitter, block=block)
    if precond is not None:
        pre = precond_apply_from_factors(*precond)
    elif precond_rank:
        pre = make_pivoted_precond(params, X, precond_rank, kind=kind,
                                   jitter=jitter)
    else:
        pre = None
    alpha, _ = cg_solve(mv, y, tol=tol, max_iters=max_iters,
                        precond_apply=pre)
    Ks = kernel_ops.cross_covariance_xla(params, X, Xs, kind)  # (n, m)
    mu = Ks.T @ alpha
    w, _ = cg_solve(mv, Ks, tol=tol, max_iters=max_iters,
                    precond_apply=pre)  # (n, m)
    var = kernel_ops.kernel_diag(params, Xs, kind) - jnp.sum(Ks * w, axis=0)
    if include_noise:
        var = var + jnp.exp(params["log_noise_var"])
    return mu, jnp.maximum(var, 0.0)


def _dk_tile(rows, cols, ell, sf2, kind, wrt, k_dim, alpha=None,
             period=None):
    """One (b, n) tile of dK/d(log theta).

    rows/cols are UNSCALED inputs; wrt in {"log_signal_var",
    "log_lengthscale", "log_alpha", "log_period", "log_bias_var"} (noise
    handled in closed form by the caller). alpha doubles as the linear
    bias variance (matching the tile builders' scalar slot). Derivative
    algebra matches models.exact_gp.lml_gradients_analytic.
    """
    if kind == "linear":
        rs = rows / ell
        cs = cols / ell
        if wrt == "log_signal_var":
            return sf2 * jnp.dot(rs, cs.T, precision=_HI)
        if wrt == "log_bias_var":
            b = jnp.asarray(0.0 if alpha is None else alpha)
            return b * jnp.ones((rows.shape[0], cols.shape[0]), rows.dtype)
        if wrt == "log_lengthscale":
            return -2.0 * sf2 * jnp.outer(rs[:, k_dim], cs[:, k_dim])
        raise ValueError(f"{wrt} gradient undefined for kind='linear'")
    if kind == "periodic":
        if period is None:
            raise ValueError("periodic _dk_tile needs the period vector")
        u = jnp.pi * (rows[:, None, :] - cols[None, :, :]) / period
        s2u = jnp.sin(u) ** 2
        kf = sf2 * jnp.exp(-2.0 * jnp.sum(s2u / ell**2, axis=-1))
        if wrt == "log_signal_var":
            return kf
        if wrt == "log_lengthscale":
            return kf * (4.0 * s2u[..., k_dim] / ell[k_dim] ** 2)
        if wrt == "log_period":
            uk = u[..., k_dim]
            return kf * (2.0 * uk * jnp.sin(2.0 * uk) / ell[k_dim] ** 2)
        raise ValueError(f"{wrt} gradient undefined for kind='periodic'")
    rs = rows / ell
    cs = cols / ell
    d2 = (jnp.sum(rs**2, -1)[:, None] + jnp.sum(cs**2, -1)[None, :]
          - 2.0 * jnp.dot(rs, cs.T, precision=_HI))
    d2 = jnp.maximum(d2, 0.0)
    kf = sf2 * kernel_ops.kernel_fn(d2, kind, alpha)
    if wrt == "log_signal_var":
        return kf
    if wrt == "log_alpha":
        if kind != "rq":
            raise ValueError("log_alpha gradient only exists for kind='rq'")
        a = jnp.asarray(1.0 if alpha is None else alpha)
        logb = jnp.log1p(d2 / (2.0 * a))
        return kf * a * (-logb + d2 / (2.0 * a + d2))
    # d k / d d2
    r = jnp.sqrt(jnp.maximum(d2, 1e-30))
    if kind == "rbf":
        dk_dd2 = -0.5 * kf
    elif kind == "rq":
        a = jnp.asarray(1.0 if alpha is None else alpha)
        dk_dd2 = -0.5 * sf2 * jnp.exp(
            -(a + 1.0) * jnp.log1p(d2 / (2.0 * a)))
    elif kind == "matern12":
        dk_dd2 = sf2 * jnp.exp(-r) * (-0.5 / r)
    elif kind == "matern32":
        dk_dd2 = sf2 * (-1.5) * jnp.exp(-math.sqrt(3.0) * r)
    elif kind == "matern52":
        s5 = math.sqrt(5.0)
        dk_dd2 = sf2 * (-(5.0 / 6.0)) * (1.0 + s5 * r) * jnp.exp(-s5 * r)
    else:
        raise ValueError(kind)
    diff2 = (rows[:, None, k_dim] - cols[None, :, k_dim]) ** 2 / ell[k_dim]**2
    dK = dk_dd2 * (-2.0 * diff2)
    # r=0 diagonal entries have zero derivative (mask numerical noise)
    return jnp.where(d2 <= 1e-30, 0.0, dK)


def make_dk_matvec(params, X, wrt, k_dim=0, kind="rbf", block=4096):
    """v -> (dK/d log theta) v, matrix-free (same blocking as make_matvec)."""
    n, d = X.shape
    ell = jnp.exp(params["log_lengthscale"])
    sf2 = jnp.exp(params["log_signal_var"])
    if kind == "rq" and "log_alpha" in params:
        alpha = jnp.exp(params["log_alpha"])
    elif kind == "linear" and "log_bias_var" in params:
        alpha = jnp.exp(params["log_bias_var"])  # bias rides the alpha slot
    else:
        alpha = None
    period = (jnp.exp(params["log_period"]) if kind == "periodic" else None)
    nb = -(-n // block)
    npad = nb * block
    Xp = jnp.pad(X, ((0, npad - n), (0, 0)))

    def matvec(v):
        v2 = v[:, None] if v.ndim == 1 else v

        def one_block(i):
            rows = jax.lax.dynamic_slice(Xp, (i * block, 0), (block, d))
            dk = _dk_tile(rows, X, ell, sf2, kind, wrt, k_dim, alpha, period)
            return jnp.dot(dk, v2, precision=_HI)

        out = jax.lax.map(one_block, jnp.arange(nb)).reshape(npad, -1)[:n]
        return out[:, 0] if v.ndim == 1 else out

    return matvec


@partial(jax.jit, static_argnames=("kind", "jitter", "block", "tol",
                                   "max_iters", "num_probes", "grad_method"))
def lml_value_and_grad_iterative(params, X, y, key=None, kind="rbf",
                                 jitter=1e-6, block=4096, tol=1e-5,
                                 max_iters=500, num_probes=16,
                                 precond=None, grad_method="ad"):
    """Matrix-free LML gradient (BBMM-style training step).

    dLML/dtheta = 1/2 (alpha^T dK alpha - tr(K^{-1} dK)), with the trace
    estimated by Hutchinson probes solved with batched CG:
      tr(K^{-1} dK) ~ E_z[(K^{-1} z)^T dK z],  z Rademacher.
    Returns (quad-form LML value WITHOUT the logdet term, grads dict) —
    for optimization only the gradients matter; use lml_iterative for a
    comparable value with the SLQ logdet.

    grad_method="ad" (default): after the CG solves, ALL hyperparameter
    gradients come from ONE reverse-mode sweep of
    g(p) = 1/2 (alpha^T K(p) alpha - mean_z w^T K(p) z) with alpha/w/z
    held constant — mathematically identical to the per-parameter dK
    estimator but a single rematerialized backward pass over the blocked
    matvec, and it serves EVERY kernel family including composites
    (round-3 VERDICT next #4). grad_method="analytic": the hand-derived
    per-parameter dK-tile path (base families only; kept as the
    cross-check, mirroring the dense tier's analytic-vs-AD pairing).
    precond: optional (Lk, Lg, s2) factors for the CG solves.
    """
    if grad_method not in ("ad", "analytic"):
        raise ValueError(f"unknown grad_method {grad_method!r}")
    if grad_method == "analytic":
        kernel_ops.require_base_kind(
            kind, "lml_value_and_grad_iterative(grad_method='analytic')")
    else:
        kernel_ops.validate_kind(kind)
    if key is None:
        key = jax.random.key(0)
    n, d = X.shape
    mv = make_matvec(params, X, kind=kind, jitter=jitter, block=block)
    pre = (precond_apply_from_factors(*precond) if precond is not None
           else None)
    z = jax.random.rademacher(key, (n, num_probes), dtype=jnp.float32)
    # one batched CG for [y | z]: each iteration's covariance tiles are
    # built once and contracted against rhs+probes together (BBMM
    # batching) — 1+p solves at ~the cost of p
    sol, _ = cg_solve(mv, jnp.concatenate([y[:, None], z], axis=1),
                      tol=tol, max_iters=max_iters, precond_apply=pre)
    alpha, w = sol[:, 0], sol[:, 1:]  # K^{-1} y, K^{-1} z

    if grad_method == "ad":
        alpha_c = jax.lax.stop_gradient(alpha)
        w_c = jax.lax.stop_gradient(w)
        z_c = jax.lax.stop_gradient(z)

        def estimator(p):
            # method="xla": the blocked AD-safe tile path (the fused
            # Pallas matvec has no JVP rule); remat inside make_matvec
            # keeps the backward pass O(block * n) memory
            mvp = make_matvec(p, X, kind=kind, jitter=jitter, block=block,
                              method="xla")
            quad = jnp.dot(alpha_c, mvp(alpha_c))
            tr = jnp.mean(jnp.sum(w_c * mvp(z_c), axis=0))
            return 0.5 * (quad - tr)

        grads = jax.grad(estimator)(params)
        value = -0.5 * jnp.dot(y, alpha)  # quad term only (no logdet)
        return value, grads

    sn2 = jnp.exp(params["log_noise_var"])
    grads = {}
    # noise: dK = sn2 I -> closed form
    grads["log_noise_var"] = 0.5 * sn2 * (
        jnp.dot(alpha, alpha) - jnp.mean(jnp.sum(w * z, axis=0)) * 1.0)
    # signal variance (+ jitter term folded: dK diag includes jitter*sf2)
    sf2 = jnp.exp(params["log_signal_var"])
    dmv = make_dk_matvec(params, X, "log_signal_var", kind=kind, block=block)
    dk_alpha = dmv(alpha) + jitter * sf2 * alpha
    dk_z = dmv(z) + jitter * sf2 * z
    grads["log_signal_var"] = 0.5 * (
        jnp.dot(alpha, dk_alpha) - jnp.mean(jnp.sum(w * dk_z, axis=0)))
    # lengthscales
    g_ell = []
    for k_dim in range(d):
        dmv = make_dk_matvec(params, X, "log_lengthscale", k_dim=k_dim,
                             kind=kind, block=block)
        g_ell.append(0.5 * (jnp.dot(alpha, dmv(alpha))
                            - jnp.mean(jnp.sum(w * dmv(z), axis=0))))
    grads["log_lengthscale"] = jnp.stack(g_ell)
    # rq mixture parameter
    if kind == "rq" and "log_alpha" in params:
        dmv = make_dk_matvec(params, X, "log_alpha", kind=kind, block=block)
        grads["log_alpha"] = 0.5 * (
            jnp.dot(alpha, dmv(alpha))
            - jnp.mean(jnp.sum(w * dmv(z), axis=0)))
    # periodic: per-dim periods
    if kind == "periodic":
        g_per = []
        for k_dim in range(d):
            dmv = make_dk_matvec(params, X, "log_period", k_dim=k_dim,
                                 kind=kind, block=block)
            g_per.append(0.5 * (jnp.dot(alpha, dmv(alpha))
                                - jnp.mean(jnp.sum(w * dmv(z), axis=0))))
        grads["log_period"] = jnp.stack(g_per)
    # linear: bias variance
    if kind == "linear" and "log_bias_var" in params:
        dmv = make_dk_matvec(params, X, "log_bias_var", kind=kind,
                             block=block)
        grads["log_bias_var"] = 0.5 * (
            jnp.dot(alpha, dmv(alpha))
            - jnp.mean(jnp.sum(w * dmv(z), axis=0)))

    value = -0.5 * jnp.dot(y, alpha)  # quad term only (no logdet)
    return value, grads


# ---- Split-program training step --------------------------------------
# Solve, probe solve and gradient sweep as separate jitted programs that
# compose to exactly lml_value_and_grad_iterative's "ad" path;
# map_opt.fit_iterative picks fused vs split by n (split_programs).

@partial(jax.jit, static_argnames=("kind", "jitter", "block", "tol",
                                   "max_iters"))
def cg_solve_program(params, X, b, precond=None, kind="rbf", jitter=1e-6,
                     block=4096, tol=1e-5, max_iters=500, x0=None):
    """One CG solve as its own program: (K + noise I) x = b.

    x0: optional warm start — one extra matvec forms the true residual
    and CG proceeds from there (see cg_init)."""
    mv = make_matvec(params, X, kind=kind, jitter=jitter, block=block)
    pre = (precond_apply_from_factors(*precond) if precond is not None
           else None)
    if x0 is None:
        return cg_solve(mv, b, tol=tol, max_iters=max_iters,
                        precond_apply=pre)
    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    x02 = x0[:, None] if x0.ndim == 1 else x0
    bnorm = jnp.maximum(jnp.linalg.norm(b2, axis=0), 1e-30)
    s0 = cg_init(b2, precond_apply=pre, x0=x02, matvec=mv)

    def cond(s):
        rel = jnp.linalg.norm(s.r, axis=0) / bnorm
        return (s.it < max_iters) & jnp.any(rel > tol)

    s = jax.lax.while_loop(cond, _cg_body(mv, _cg_apply_m(pre, None)), s0)
    return (s.x[:, 0] if vec else s.x), s.it


@partial(jax.jit, static_argnames=("kind", "jitter", "block"))
def hutchinson_grads_program(params, X, alpha, w, z, kind="rbf",
                             jitter=1e-6, block=4096):
    """Gradient sweep given precomputed solves (alpha = K^-1 y,
    w = K^-1 z): one rematerialized backward pass of
    1/2 (alpha^T K(p) alpha - mean_z w^T K(p) z). Serves every kernel
    family including composites (same estimator as the fused "ad" path).
    """
    alpha = jax.lax.stop_gradient(alpha)
    w = jax.lax.stop_gradient(w)
    z = jax.lax.stop_gradient(z)

    def estimator(p):
        mvp = make_matvec(p, X, kind=kind, jitter=jitter, block=block,
                          method="xla")
        quad = jnp.dot(alpha, mvp(alpha))
        tr = jnp.mean(jnp.sum(w * mvp(z), axis=0))
        return 0.5 * (quad - tr)

    return jax.grad(estimator)(params)
