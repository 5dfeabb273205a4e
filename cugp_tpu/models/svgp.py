"""Stochastic variational GP (SVGP) — beyond-reference surface.

Hensman et al. 2013 ("Gaussian Processes for Big Data") / 2015 (scalable
classification): an UNcollapsed inducing-point bound whose per-step cost is
O(b m^2) for a minibatch of b points, so hyperparameters, inducing
locations, and the variational posterior all train by SGD on data that
never has to fit in one kernel matrix — and the likelihood no longer has
to be Gaussian. This is the scalable tier above models/sgpr.py (whose
collapsed bound needs the full K_mn each step and a Gaussian likelihood).

Whitened parameterization (stable, standard): with L = chol(K_mm), the
inducing outputs are u = L v and the variational posterior is
q(v) = N(m, C C^T), C lower-triangular (log-diag storage). Then for a
batch B with A = L^{-1} K_{m,B}:

  q(f_B) = N(A^T m,  diag[k_BB - A^T A + (C^T A)^T (C^T A)])
  ELBO   = (n/b) sum_{i in B} E_{q(f_i)} log p(y_i | f_i)  -  KL(q || N(0,I))
  KL     = (||m||^2 + ||C||_F^2 - M)/2 - sum log diag C

Expected log-likelihoods:
  gaussian :  closed form, -((y-mu)^2 + var)/(2 sn2) - log(2 pi sn2)/2
  bernoulli:  y in {-1,+1}, logistic p(y|f) = sigmoid(y f), via
              Gauss-Hermite quadrature (GH_POINTS nodes)

For the Gaussian likelihood the optimal q(v) is available in closed form
(Titsias 2009): S = (I + A A^T/sn2)^{-1}, m = S A y / sn2, at which point
the bound COLLAPSES to models/sgpr.elbo — `optimal_variational` computes
it (used as a warm start and as the correctness oracle in tests).

All dense ops (K_mm, K_mB, the m x m Cholesky) ride the same ops tier as
the exact model. The reference (BASELINE.json:5) has no scalable or
non-Gaussian surface at all; this extends the config ladder past both.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax

from cugp_tpu.ops import kernels as kernel_ops

LOG2PI = math.log(2.0 * math.pi)
_HI = jax.lax.Precision.HIGHEST

GH_POINTS = 20
_gh_x, _gh_w = np.polynomial.hermite.hermgauss(GH_POINTS)
_GH_X = jnp.asarray(_gh_x, jnp.float32)          # nodes of int e^{-x^2}
_GH_W = jnp.asarray(_gh_w / math.sqrt(math.pi), jnp.float32)

LIKELIHOODS = ("gaussian", "bernoulli", "poisson", "student_t")

# student_t degrees of freedom DEFAULT (heavy-tailed robust regression;
# nu -> inf recovers the gaussian likelihood). nu is LEARNABLE: fit() adds
# a "log_nu" hyperparameter for likelihood='student_t' and the ELBO reads
# nu = exp(log_nu) from params, so SGD adapts the tail weight to the data.
STUDENT_T_NU = 4.0


def student_t_nu(params):
    """nu from params (learnable log_nu) or the static default."""
    if isinstance(params, dict) and "log_nu" in params:
        return jnp.exp(params["log_nu"])
    return jnp.float32(STUDENT_T_NU)


def chol_from_flat(flat, dim):
    """Lower-triangular C: log-diag in flat[:dim], strict lower after."""
    C = jnp.zeros((dim, dim), flat.dtype)
    idx = jnp.tril_indices(dim, k=-1)
    C = C.at[idx].set(flat[dim:])
    return C + jnp.diag(jnp.exp(flat[:dim]))


def flat_from_chol(C):
    dim = C.shape[0]
    idx = jnp.tril_indices(dim, k=-1)
    return jnp.concatenate([jnp.log(jnp.diagonal(C)), C[idx]])


def init_variational(num_inducing, dtype=jnp.float32):
    """q(v) = N(0, I): the whitened prior (ELBO starts at the prior KL=0)."""
    m = num_inducing
    return {
        "m": jnp.zeros((m,), dtype),
        "c": jnp.zeros((m * (m + 1)) // 2, dtype),  # log-diag 0 -> C = I
    }


# K_mm jitter floor, RELATIVE to the signal variance. Deliberately larger
# than sgpr's 1e-6: the whitened parameterization stores q in L-coordinates,
# so an ill-conditioned fp32 chol(K_mm) turns tiny hyperparameter steps into
# huge swings of the represented function u = L v (and NaN hyperparameter
# gradients through L^{-1}) — found by bisection on the joint SGD fit. 1e-4
# keeps cond(K_mm) inside fp32 while perturbing the bound by O(1e-4) per
# inducing point.
KMM_JITTER_FLOOR = 1e-4


def _kmm_chol(params, Z, kind, jitter, kmm_jitter=None):
    from cugp_tpu.models import exact_gp

    if kmm_jitter is None:
        kmm_jitter = KMM_JITTER_FLOOR
    mm = Z.shape[0]
    sf2 = kernel_ops.signal_scale(params)
    Kmm = kernel_ops.cross_covariance_xla(params, Z, Z, kind)
    Kmm = Kmm + (jitter + kmm_jitter) * sf2 * jnp.eye(mm, dtype=Kmm.dtype)
    return exact_gp.safe_cholesky(Kmm, sf2, method="xla", max_attempts=3,
                                  jitter0=1e-4)


def _qf(params, Z, vp, Xb, kind, jitter, kmm_jitter=None):
    """Marginal q(f) mean/variance at the batch inputs."""
    mm = Z.shape[0]
    L = _kmm_chol(params, Z, kind, jitter, kmm_jitter)
    Kmb = kernel_ops.cross_covariance_xla(params, Z, Xb, kind)
    A = jax.lax.linalg.triangular_solve(L, Kmb, left_side=True, lower=True)
    C = chol_from_flat(vp["c"], mm)
    CtA = jnp.matmul(C.mT, A, precision=_HI)
    mu = A.mT @ vp["m"]
    kbb = kernel_ops.kernel_diag(params, Xb, kind)
    var = kbb - jnp.sum(A * A, axis=0) + jnp.sum(CtA * CtA, axis=0)
    return mu, jnp.maximum(var, 1e-10)


def expected_loglik(y, mu, var, likelihood, sn2=None, nu=None):
    """E_{f ~ N(mu, var)} [log p(y | f)], elementwise over the batch."""
    if likelihood == "gaussian":
        r = y - mu
        return -0.5 * (LOG2PI + jnp.log(sn2)) - (r * r + var) / (2.0 * sn2)
    if likelihood == "bernoulli":
        # y in {-1,+1}; log sigmoid(y f) integrated over q(f) by GH quadrature
        f = mu[:, None] + jnp.sqrt(2.0 * var)[:, None] * _GH_X[None, :]
        return jnp.sum(_GH_W[None, :] * jax.nn.log_sigmoid(y[:, None] * f),
                       axis=1)
    if likelihood == "poisson":
        # counts with log link: log p = y f - e^f - log y!, and
        # E[e^f] = exp(mu + var/2) under q(f) — fully closed form
        return (y * mu - jnp.exp(mu + 0.5 * var)
                - jax.lax.lgamma(y + 1.0))
    if likelihood == "student_t":
        # heavy-tailed robust regression; scale^2 = sn2, nu learnable
        # (student_t_nu). No closed form — GH quadrature like bernoulli.
        nu = jnp.float32(STUDENT_T_NU) if nu is None else nu
        const = (jax.lax.lgamma((nu + 1.0) / 2.0)
                 - jax.lax.lgamma(nu / 2.0)
                 - 0.5 * jnp.log(nu * jnp.pi * sn2))
        f = mu[:, None] + jnp.sqrt(2.0 * var)[:, None] * _GH_X[None, :]
        r2 = (y[:, None] - f) ** 2
        logp = const - 0.5 * (nu + 1.0) * jnp.log1p(r2 / (nu * sn2))
        return jnp.sum(_GH_W[None, :] * logp, axis=1)
    raise ValueError(f"unknown likelihood: {likelihood}")


def kl_whitened(vp):
    """KL( N(m, CC^T) || N(0, I) )."""
    mm = vp["m"].shape[0]
    C = chol_from_flat(vp["c"], mm)
    logdet = 2.0 * jnp.sum(vp["c"][:mm])
    return 0.5 * (jnp.sum(vp["m"] ** 2) + jnp.sum(C * C) - mm - logdet)


@partial(jax.jit, static_argnames=("kind", "jitter", "likelihood",
                                   "kmm_jitter"))
def elbo(params, Z, vp, X, y, kind="rbf", jitter=1e-6,
         likelihood="gaussian", scale=1.0, kmm_jitter=None):
    """SVGP bound on a batch; `scale` = n_total / batch for minibatches.

    With likelihood='gaussian', scale=1, and vp = optimal_variational(...),
    equals models/sgpr.elbo (tested). kmm_jitter: relative K_mm jitter
    floor (default KMM_JITTER_FLOOR; see its comment for the tradeoff)."""
    mu, var = _qf(params, Z, vp, X, kind, jitter, kmm_jitter)
    sn2 = (jnp.exp(params["log_noise_var"])
           if likelihood in ("gaussian", "student_t") else None)
    nu = student_t_nu(params) if likelihood == "student_t" else None
    ell = jnp.sum(expected_loglik(y, mu, var, likelihood, sn2, nu))
    return scale * ell - kl_whitened(vp)


# Above this n, optimal_variational streams K_mn in column chunks instead
# of materializing the (m, n) matrix — only A A^T (m, m) and A y (m,) are
# ever held, preserving the module's O(b m^2) memory claim at warm-start.
_WARMSTART_CHUNK = 8192


@partial(jax.jit, static_argnames=("kind", "jitter", "kmm_jitter"))
def optimal_variational(params, Z, X, y, kind="rbf", jitter=1e-6,
                        kmm_jitter=None):
    """Closed-form optimal whitened q(v) for the Gaussian likelihood.

    S = (I + A A^T / sn2)^{-1}, m = S A y / sn2 — at these values the
    uncollapsed bound equals the Titsias collapsed bound (sgpr.elbo).
    For n > _WARMSTART_CHUNK the statistics A A^T and A y accumulate over
    column chunks of K_mn under lax.scan (exact, never (m, n) resident)."""
    mm = Z.shape[0]
    n = X.shape[0]
    sn2 = jnp.exp(params["log_noise_var"])
    L = _kmm_chol(params, Z, kind, jitter, kmm_jitter)
    if n <= _WARMSTART_CHUNK:
        Kmn = kernel_ops.cross_covariance_xla(params, Z, X, kind)
        A = jax.lax.linalg.triangular_solve(L, Kmn, left_side=True,
                                            lower=True)
        AAt = jnp.matmul(A, A.mT, precision=_HI)
        Ay = A @ y
    else:
        c = _WARMSTART_CHUNK
        nc = -(-n // c)
        pad = nc * c - n
        Xp = jnp.pad(X, ((0, pad), (0, 0))).reshape(nc, c, X.shape[1])
        yp = jnp.pad(y, (0, pad)).reshape(nc, c)
        valid = (jnp.arange(nc * c) < n).reshape(nc, c)

        def chunk_stats(carry, xs):
            AAt, Ay = carry
            Xc, yc, vc = xs
            Kmc = kernel_ops.cross_covariance_xla(params, Z, Xc, kind)
            Ac = jax.lax.linalg.triangular_solve(L, Kmc, left_side=True,
                                                 lower=True)
            Ac = jnp.where(vc[None, :], Ac, 0.0)  # padded cols contribute 0
            AAt = AAt + jnp.matmul(Ac, Ac.mT, precision=_HI)
            Ay = Ay + Ac @ yc
            return (AAt, Ay), None

        (AAt, Ay), _ = jax.lax.scan(
            chunk_stats,
            (jnp.zeros((mm, mm), jnp.float32), jnp.zeros((mm,), jnp.float32)),
            (Xp, yp, valid))
    B = jnp.eye(mm, dtype=AAt.dtype) + AAt / sn2
    S = jnp.linalg.inv(B)
    S = 0.5 * (S + S.mT) + 1e-8 * jnp.eye(mm, dtype=S.dtype)
    m = S @ Ay / sn2
    return {"m": m, "c": flat_from_chol(jnp.linalg.cholesky(S))}


@partial(jax.jit, static_argnames=("kind", "jitter", "include_noise",
                                   "likelihood", "kmm_jitter"))
def posterior(params, Z, vp, Xs, kind="rbf", jitter=1e-6,
              include_noise=False, likelihood="gaussian", kmm_jitter=None):
    """Predictive q(f*) mean/variance at Xs.

    include_noise adds the OBSERVATION variance for the likelihood:
    sn2 for gaussian; nu/(nu-2) * sn2 for student_t (sn2 is the scale^2
    there, not the variance). Count/label likelihoods have no additive
    observation-noise notion — use predict_rate / predict_proba."""
    if include_noise and likelihood not in ("gaussian", "student_t"):
        raise ValueError(
            f"include_noise is undefined for likelihood={likelihood!r}; "
            "use predict_rate (poisson) or predict_proba (bernoulli)")
    mu, var = _qf(params, Z, vp, Xs, kind, jitter, kmm_jitter)
    if include_noise:
        sn2 = jnp.exp(params["log_noise_var"])
        if likelihood == "student_t":
            nu = student_t_nu(params)
            # variance of a student-t with nu<=2 is undefined/infinite;
            # clamp so the reported observation variance stays finite
            sn2 = sn2 * nu / jnp.maximum(nu - 2.0, 1e-3)
        var = var + sn2
    return mu, var


@partial(jax.jit, static_argnames=("kind", "jitter"))
def predict_rate(params, Z, vp, Xs, kind="rbf", jitter=1e-6):
    """Poisson-likelihood predictive rate: mean and variance of e^f under
    q(f) (lognormal moments)."""
    mu, var = _qf(params, Z, vp, Xs, kind, jitter)
    rate = jnp.exp(mu + 0.5 * var)
    rate_var = jnp.exp(2.0 * mu + var) * (jnp.exp(var) - 1.0)
    return rate, rate_var


def predict_proba(params, Z, vp, Xs, kind="rbf", jitter=1e-6):
    """p(y=+1 | x*) for the bernoulli likelihood (MacKay probit approx,
    same rule as models/gpc.predict_proba)."""
    mu, var = _qf(params, Z, vp, jnp.asarray(Xs, jnp.float32), kind, jitter)
    kappa = 1.0 / jnp.sqrt(1.0 + (jnp.pi / 8.0) * var)
    return jax.nn.sigmoid(kappa * mu), mu, var


@partial(jax.jit, static_argnames=(
    "kind", "jitter", "likelihood", "steps", "batch", "learning_rate",
    "optimize_inducing"))
def _fit_scan(trainables, fixed_Z, X, y, key, kind, jitter, likelihood,
              steps, batch, learning_rate, optimize_inducing,
              grad_clip=100.0, kmm_jitter=None, idx_schedule=None):
    from cugp_tpu.inference import map_opt

    n = X.shape[0]
    scale = n / batch

    def neg_elbo(tr, idx):
        Z = tr["Z"] if optimize_inducing else fixed_Z
        Xb, yb = X[idx], y[idx]
        return -elbo(tr["params"], Z, {"m": tr["m"], "c": tr["c"]}, Xb, yb,
                     kind=kind, jitter=jitter, likelihood=likelihood,
                     scale=scale, kmm_jitter=kmm_jitter)

    # clip: hyperparameter gradients through L^{-1} spike when K_mm
    # conditioning degrades mid-trajectory; clipping keeps one bad
    # minibatch from ejecting q from its basin
    tx = optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(grad_clip),
                    optax.adam(learning_rate)), 1000)
    opt_state = tx.init(trainables)

    def step(carry, xs):
        tr, s = carry
        k, sched = xs
        idx = (jax.random.randint(k, (batch,), 0, n)
               if sched is None else sched)
        loss, grads = jax.value_and_grad(neg_elbo)(tr, idx)
        updates, s = tx.update(grads, s, tr)
        tr = optax.apply_updates(tr, updates)
        tr["params"] = map_opt._clamp(tr["params"])
        return (tr, s), loss

    keys = jax.random.split(key, steps)
    (trainables, _), losses = jax.lax.scan(step, (trainables, opt_state),
                                           (keys, idx_schedule))
    return trainables, losses


def fit(init_params, X, y, *, num_inducing=512, Z=None, kind="rbf",
        jitter=1e-6, likelihood="gaussian", steps=2000, batch=256,
        learning_rate=0.01, optimize_inducing=True, warm_start=True,
        seed=0, key=None, grad_clip=100.0, kmm_jitter=None,
        batch_sampling="replacement"):
    """SGD on the SVGP bound over (hyperparams, inducing locs, q(v)).

    warm_start: for the Gaussian likelihood, initialize q(v) at its
    closed-form optimum given the initial hyperparameters (big head
    start; falls back to the whitened prior for other likelihoods).
    grad_clip: global-norm clip on the joint gradient (see _fit_scan
    comment). kmm_jitter: relative K_mm jitter floor override (default
    KMM_JITTER_FLOOR). batch_sampling: "replacement" (randint per step)
    or "shuffle" (cycled shuffled epochs — every point visited once per
    epoch; schedule precomputed host-side, shapes stay static).
    Returns (params, Z, vp, info)."""
    from cugp_tpu.models import sgpr

    if likelihood not in LIKELIHOODS:
        raise ValueError(f"unknown likelihood: {likelihood}; "
                         f"supported: {LIKELIHOODS}")
    if likelihood == "student_t" and "log_nu" not in init_params:
        init_params = dict(init_params)
        init_params["log_nu"] = jnp.asarray(math.log(STUDENT_T_NU),
                                            jnp.float32)
    X = jnp.asarray(X, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    n = X.shape[0]
    batch = min(batch, n)
    if Z is None:
        Z = sgpr.init_inducing(X, num_inducing, seed=seed)
    mm = Z.shape[0]
    if warm_start and likelihood == "gaussian":
        vp = optimal_variational(init_params, Z, X, y, kind=kind,
                                 jitter=jitter, kmm_jitter=kmm_jitter)
    else:
        vp = init_variational(mm)
    trainables = {"params": init_params, "m": vp["m"], "c": vp["c"]}
    if optimize_inducing:
        trainables["Z"] = Z
    if key is None:
        key = jax.random.key(seed)
    if batch_sampling == "shuffle":
        import numpy as _np

        rng = _np.random.default_rng(seed)
        need = steps * batch
        order = _np.concatenate([rng.permutation(n)
                                 for _ in range(-(-need // n))])[:need]
        idx_schedule = jnp.asarray(order.reshape(steps, batch), jnp.int32)
    elif batch_sampling == "replacement":
        idx_schedule = None
    else:
        raise ValueError(f"unknown batch_sampling: {batch_sampling!r}")
    trainables, losses = _fit_scan(
        trainables, Z, X, y, key, kind, jitter, likelihood, steps, batch,
        learning_rate, optimize_inducing, grad_clip=grad_clip,
        kmm_jitter=kmm_jitter, idx_schedule=idx_schedule)
    Z_out = trainables["Z"] if optimize_inducing else Z
    vp_out = {"m": trainables["m"], "c": trainables["c"]}
    return trainables["params"], Z_out, vp_out, {
        "loss": losses, "elbo_batch_final": -losses[-1]}
