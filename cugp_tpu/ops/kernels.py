"""Covariance (kernel-matrix) construction — component C1 (SURVEY.md section 2).

The reference builds its dense N x N covariance with CUDA kernels over pairwise
distances (BASELINE.json:5, "dense covariance-matrix construction (RBF/Matern
kernels)"). Here it is plain jnp on every backend: XLA turns the
distance expansion into one GEMM for the cross term plus a fused
elementwise kernel evaluation. Writing K (4.3 GB at N=32k) is bound by
device-memory bandwidth, a few ms beside a factorization of a second or
more, so a hand-written builder has nothing to win (PERF.md).

Hyperparameters are a dict of log-space values:
  ``log_lengthscale`` (d,), ``log_signal_var`` (), ``log_noise_var`` ().
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

SUPPORTED_KERNELS = ("rbf", "matern12", "matern32", "matern52", "rq",
                     "periodic", "linear")

# Stationary families expressible as f(scaled squared distance) — these go
# through kernel_fn(). "periodic" reduces to rbf on the cos/sin feature map
# (periodic_rbf_view below); "linear" is a plain GEMM (dot-product
# kernel) and dispatches separately.
STATIONARY_KERNELS = ("rbf", "matern12", "matern32", "matern52", "rq")


# ---- Kernel algebra (sum-of-products composition) ----
# kind strings compose base families with '+' and '*', e.g. the classic
# quasi-periodic kernel "periodic*rbf+linear" (GPML section 4.2.4 kernel
# arithmetic: sums and elementwise products of PSD kernels are PSD).
# Composite params:
#   {"log_noise_var": (),
#    "terms": [{"log_signal_var": (),            # amplitude of the term
#               "factors": [<factor dict>, ...]},# lengthscale + extras,
#              ...]}                             #   NO signal/noise inside
# Factor amplitudes are unidentifiable inside a product, so amplitude
# lives at the term level. Gradients flow by AD through the combination.
# Composites are first-class in the XLA builders, the ring (SP)
# builder, and the iterative matvec/pivoted-Cholesky tiles (all via
# flatten_terms/factor_view/tile_eval below); only the ANALYTIC-gradient
# cross-check paths stay base-family-only (AD is the default everywhere).


def is_composite(kind):
    return ("+" in kind) or ("*" in kind)


def parse_kind(kind):
    """'a*b+c' -> (('a','b'), ('c',)). Validates every base family."""
    terms = []
    for term in kind.split("+"):
        factors = tuple(f.strip() for f in term.split("*"))
        if not all(factors):
            raise ValueError(f"malformed composite kernel kind: {kind!r}")
        for f in factors:
            if f not in SUPPORTED_KERNELS:
                raise ValueError(
                    f"unknown kernel kind {f!r} in composite {kind!r}; "
                    f"supported bases: {SUPPORTED_KERNELS}")
        terms.append(factors)
    return tuple(terms)


def require_base_kind(kind, where):
    """Paths that specialize per family (the analytic-gradient cross-check,
    the fused single-family Pallas matvec) serve base kinds only;
    composites go through the AD / per-factor tile routes."""
    if is_composite(kind):
        raise NotImplementedError(
            f"{where} supports base kernel families only, got composite "
            f"{kind!r}; use the default AD path (method='auto'/'xla')")


def validate_kind(kind):
    """Raise ValueError unless kind is a supported base family or a
    well-formed composite of them."""
    parse_kind(kind)  # parse validates every base (a bare base parses too)


def signal_scale(params):
    """Representative signal variance for jitter/conditioning decisions:
    exp(log_signal_var) for base families, the sum of term amplitudes for
    composites (= the prior variance scale of the summed process)."""
    if "terms" in params:
        return sum(jnp.exp(t["log_signal_var"]) for t in params["terms"])
    return jnp.exp(params["log_signal_var"])


def _unit_amplitude(fparams):
    p = dict(fparams)
    p["log_signal_var"] = jnp.zeros((), jnp.float32)
    return p


def _composite_combine(params, kind, factor_fn):
    """Sum over terms of (amplitude * product over factors of
    factor_fn(unit-amplitude factor params, base))."""
    terms = parse_kind(kind)
    if len(params.get("terms", ())) != len(terms):
        raise ValueError(
            f"composite params have {len(params.get('terms', ()))} terms, "
            f"kind {kind!r} needs {len(terms)}")
    K = None
    for tparams, bases in zip(params["terms"], terms):
        Kt = None
        for fparams, base in zip(tparams["factors"], bases):
            Kf = factor_fn(_unit_amplitude(fparams), base)
            Kt = Kf if Kt is None else Kt * Kf
        Kt = jnp.exp(tparams["log_signal_var"]) * Kt
        K = Kt if K is None else K + Kt
    return K

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)
_TWO_PI = 2.0 * math.pi

# Minimum squared distance used before sqrt for Matern kernels: keeps the
# gradient of sqrt finite at r=0 (the true derivative contribution there is
# handled by masking the diagonal in the analytic-gradient path; for AD the
# epsilon bounds the error well below fp32 resolution of the kernel value).
_R2_EPS = 1e-12


def kernel_fn(d2, kind, alpha=None):
    """Kernel value as a function of scaled squared distance (unit amplitude).

    alpha: rational-quadratic mixture parameter (required for kind="rq";
    rq -> rbf as alpha -> inf).
    """
    if kind == "rbf":
        return jnp.exp(-0.5 * d2)
    if kind == "rq":
        a = jnp.asarray(1.0 if alpha is None else alpha)
        return jnp.exp(-a * jnp.log1p(d2 / (2.0 * a)))
    r = jnp.sqrt(jnp.maximum(d2, _R2_EPS))
    if kind == "matern12":
        return jnp.exp(-r)
    if kind == "matern32":
        s = _SQRT3 * r
        return (1.0 + s) * jnp.exp(-s)
    if kind == "matern52":
        s = _SQRT5 * r
        return (1.0 + s + (s * s) / 3.0) * jnp.exp(-s)
    raise ValueError(f"unknown kernel kind: {kind}")


def periodic_features(X, log_period):
    """cos/sin embedding phi(x) = [cos(2 pi x/p), sin(2 pi x/p)] per dim.

    ||phi_d(x) - phi_d(x')||^2 = 4 sin^2(pi (x_d - x'_d)/p_d), so the
    exp-sine-squared (periodic, GPML eq. 4.31) kernel
    exp(-2 sum_d sin^2(pi delta_d/p_d)/ell_d^2) is EXACTLY the RBF kernel
    on phi(X) with each lengthscale duplicated across its cos/sin pair —
    the whole GEMM distance-expansion machinery (XLA builders and the
    fused matvec kernel) serves the periodic family through this map
    unchanged.
    """
    p = jnp.exp(log_period)
    ang = _TWO_PI * X / p
    return jnp.concatenate([jnp.cos(ang), jnp.sin(ang)], axis=-1)


def periodic_rbf_view(params, *Xs):
    """(params', phi(X)...) such that rbf on them == periodic on inputs."""
    ll = params["log_lengthscale"]
    p2 = {k: v for k, v in params.items() if k != "log_period"}
    p2["log_lengthscale"] = jnp.concatenate([ll, ll])
    feats = tuple(periodic_features(X, params["log_period"]) for X in Xs)
    return (p2,) + feats


def extra_scalar(params, kind):
    """The family-specific scalar the tile builders carry beside sf2:
    rq mixture alpha, linear bias variance, else 1.0 (unused)."""
    if kind == "rq" and "log_alpha" in params:
        return jnp.exp(params["log_alpha"]).astype(jnp.float32)
    if kind == "linear":
        return (jnp.exp(params["log_bias_var"]).astype(jnp.float32)
                if "log_bias_var" in params else jnp.float32(0.0))
    return jnp.float32(1.0)


def flatten_terms(params, kind):
    """Uniform per-term/per-factor view of ANY kind (base or composite).

    Returns [(amplitude, [(base, unit_factor_params), ...]), ...]: one
    entry per additive term; every factor carries unit amplitude. Base
    kinds become a single one-factor term with amplitude
    exp(log_signal_var). This is what lets the blocked/ring tile builders
    treat composites as sums of products of base-family tile evaluations.
    """
    if not is_composite(kind):
        fp = _unit_amplitude(params)
        if kind == "linear" and "log_bias_var" in params:
            # base-linear semantics put the bias OUTSIDE the amplitude
            # (K = sf2 * x.x' + bias, cross_covariance_xla); pre-divide so
            # amp * tile_eval reproduces it. (Inside composites the bias
            # rides WITH the term amplitude — _composite_combine — and the
            # unit factor params are already right.)
            fp["log_bias_var"] = (params["log_bias_var"]
                                  - params["log_signal_var"])
        return [(jnp.exp(params["log_signal_var"]), [(kind, fp)])]
    out = []
    terms = parse_kind(kind)
    if len(params.get("terms", ())) != len(terms):
        raise ValueError(
            f"composite params have {len(params.get('terms', ()))} terms, "
            f"kind {kind!r} needs {len(terms)}")
    for tparams, bases in zip(params["terms"], terms):
        out.append((jnp.exp(tparams["log_signal_var"]),
                    [(base, _unit_amplitude(fp))
                     for fp, base in zip(tparams["factors"], bases)]))
    return out


def factor_view(fparams, X, base):
    """Scale X into a factor's evaluation space.

    Returns (Xs, base', extra) such that the factor's unit-amplitude tile
    between row/col chunks of Xs is ``tile_eval(rows, cols, base',
    extra)`` — periodic is rewritten to rbf on the cos/sin embedding, so
    every factor reduces to a scaled-dot-product tile (one GEMM).
    """
    if base == "periodic":
        fparams, X = periodic_rbf_view(fparams, X)
        base = "rbf"
    ell = jnp.exp(fparams["log_lengthscale"])
    return (X / ell).astype(jnp.float32), base, extra_scalar(fparams, base)


def tile_eval(rows_s, cols_s, base, extra):
    """Unit-amplitude kernel tile between pre-scaled row/col chunks.

    base must be post-factor_view (no 'periodic'); extra is the rq alpha
    or the linear bias (ignored otherwise). The cross term is one GEMM.
    """
    cross = jnp.dot(rows_s, cols_s.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    if base == "linear":
        return cross + extra
    r2 = jnp.sum(rows_s * rows_s, axis=-1)[:, None]
    c2 = jnp.sum(cols_s * cols_s, axis=-1)[None, :]
    d2 = jnp.maximum(r2 + c2 - 2.0 * cross, 0.0)
    return kernel_fn(d2, base, extra if base == "rq" else None)


def kernel_diag(params, X, kind="rbf"):
    """Prior variance diag k(x, x) at the inputs (no noise).

    Stationary families (incl. periodic): constant sf2. Linear:
    sf2 * sum_d x_d^2/ell_d^2 + bias — posterior-variance code must use
    this, never the bare sf2 (non-stationarity).
    """
    if is_composite(kind):
        return _composite_combine(
            params, kind, lambda fp, base: kernel_diag(fp, X, base))
    sf2 = jnp.exp(params["log_signal_var"])
    n = X.shape[0]
    if kind == "linear":
        ell = jnp.exp(params["log_lengthscale"])
        Xs = X / ell
        bias = (jnp.exp(params["log_bias_var"])
                if "log_bias_var" in params else 0.0)
        return sf2 * jnp.sum(Xs * Xs, axis=-1) + bias
    return sf2 * jnp.ones((n,), X.dtype)


def scaled_sqdist(X1, X2, lengthscale):
    """Pairwise squared distance after per-dim scaling (cross term: GEMM)."""
    X1 = X1 / lengthscale
    X2 = X2 / lengthscale
    n1 = jnp.sum(X1 * X1, axis=-1)[:, None]
    n2 = jnp.sum(X2 * X2, axis=-1)[None, :]
    cross = jnp.dot(X1, X2.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(n1 + n2 - 2.0 * cross, 0.0)


@partial(jax.jit, static_argnames=("kind", "n_true"))
def cross_covariance_xla(params, X1, X2, kind="rbf", n_true=None):
    """K(X1, X2) without noise — XLA path.

    n_true: if X1 is zero-padded beyond row n_true, those rows are masked
    to 0 so padded training points do not leak into posterior algebra.
    """
    if is_composite(kind):
        K = _composite_combine(
            params, kind,
            lambda fp, base: cross_covariance_xla(fp, X1, X2, base))
        if n_true is not None and n_true < X1.shape[0]:
            rows = jnp.arange(X1.shape[0])[:, None]
            K = jnp.where(rows >= n_true, 0.0, K)
        return K
    if kind == "periodic":
        params, X1, X2 = periodic_rbf_view(params, X1, X2)
        kind = "rbf"
    ell = jnp.exp(params["log_lengthscale"])
    sf2 = jnp.exp(params["log_signal_var"])
    if kind == "linear":
        cross = jnp.dot(X1 / ell, (X2 / ell).T,
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
        bias = (jnp.exp(params["log_bias_var"])
                if "log_bias_var" in params else 0.0)
        K = sf2 * cross + bias
    else:
        d2 = scaled_sqdist(X1, X2, ell)
        alpha = (jnp.exp(params["log_alpha"])
                 if kind == "rq" and "log_alpha" in params else None)
        K = sf2 * kernel_fn(d2, kind, alpha)
    if n_true is not None and n_true < X1.shape[0]:
        rows = jnp.arange(X1.shape[0])[:, None]
        K = jnp.where(rows >= n_true, 0.0, K)
    return K


@partial(jax.jit, static_argnames=("kind", "jitter", "n_true"))
def train_covariance_xla(params, X, kind="rbf", jitter=1e-6, n_true=None):
    """K(X, X) + (noise_var + jitter*signal_var) I — XLA path.

    n_true: rows/cols at or beyond it become an exact identity block, so
    Cholesky/LML on zero-padded inputs equal the unpadded results (the
    same contract as the distributed builders).
    """
    K = cross_covariance_xla(params, X, X, kind)
    sn2 = jnp.exp(params["log_noise_var"])
    sf2 = signal_scale(params)
    n = K.shape[0]
    K = K + (sn2 + jitter * sf2) * jnp.eye(n, dtype=K.dtype)
    if n_true is not None and n_true < n:
        rows = jnp.arange(n)[:, None]
        cols = jnp.arange(n)[None, :]
        pad = (rows >= n_true) | (cols >= n_true)
        K = jnp.where(pad, jnp.where(rows == cols, 1.0, 0.0), K)
    return K


def cross_covariance(params, X1, X2, kind="rbf", n_true=None):
    """K(X1, X2) without noise (the XLA builder on every backend)."""
    return cross_covariance_xla(params, X1, X2, kind, n_true=n_true)


def train_covariance(params, X, kind="rbf", jitter=1e-6, n_true=None):
    """K(X, X) + noise/jitter diagonal (the XLA builder on every backend).

    n_true: see train_covariance_xla — identity block beyond the true rows.
    """
    return train_covariance_xla(params, X, kind, jitter, n_true=n_true)


def init_params(d=1, lengthscale=1.0, signal_var=1.0, noise_var=0.1,
                alpha=None, period=None, bias_var=None, dtype=jnp.float32):
    """Convenience constructor for the log-space hyperparameter dict.

    alpha: include a rational-quadratic mixture parameter (kind="rq").
    period: include per-dim periods (kind="periodic").
    bias_var: include a bias/offset variance (kind="linear").
    """
    p = {
        "log_lengthscale": jnp.full((d,), math.log(lengthscale), dtype=dtype),
        "log_signal_var": jnp.asarray(math.log(signal_var), dtype=dtype),
        "log_noise_var": jnp.asarray(math.log(noise_var), dtype=dtype),
    }
    if alpha is not None:
        p["log_alpha"] = jnp.asarray(math.log(alpha), dtype=dtype)
    if period is not None:
        p["log_period"] = jnp.full((d,), math.log(period), dtype=dtype)
    if bias_var is not None:
        p["log_bias_var"] = jnp.asarray(math.log(bias_var), dtype=dtype)
    return p


def default_init(kind, d=1, **kw):
    """Family-aware init_params: includes the extra hyperparameter the
    family carries (rq mixture alpha, periodic per-dim period, linear bias
    variance) so MAP/HMC/VI learn it by default. Composite kinds get the
    nested terms/factors structure (see the kernel-algebra note above)."""
    if is_composite(kind):
        return composite_init(kind, d=d, **kw)
    if kind == "rq":
        kw.setdefault("alpha", 1.0)
    elif kind == "periodic":
        kw.setdefault("period", 1.0)
    elif kind == "linear":
        kw.setdefault("bias_var", 1.0)
    return init_params(d=d, **kw)


def composite_init(kind, d=1, lengthscale=1.0, signal_var=1.0,
                   noise_var=0.1, dtype=jnp.float32):
    """Nested params for a composite kind: one amplitude per additive
    term, lengthscale + family extras per factor."""
    terms = []
    for bases in parse_kind(kind):
        factors = []
        for base in bases:
            fp = default_init(base, d=d, lengthscale=lengthscale,
                              signal_var=1.0, noise_var=1.0, dtype=dtype)
            fp.pop("log_signal_var")
            fp.pop("log_noise_var")
            factors.append(fp)
        terms.append({
            "log_signal_var": jnp.asarray(math.log(signal_var), dtype=dtype),
            "factors": factors,
        })
    return {
        "log_noise_var": jnp.asarray(math.log(noise_var), dtype=dtype),
        "terms": terms,
    }
