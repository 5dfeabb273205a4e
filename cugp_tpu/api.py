"""User-facing API facade (SURVEY.md section 1.2, layer "API").

The reference exposes its pipeline through a C++ ``main()`` driver; here the
equivalent surface is a small object-oriented facade over the pure-functional
models/inference tiers: ``GP.fit`` / ``GP.predict`` /
``GP.log_marginal_likelihood`` / ``GP.sample_hyperparams`` / ``GP.fit_vi``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cugp_tpu.models import exact_gp
from cugp_tpu.ops import kernels as kernel_ops


def _tree_struct(p):
    """JSON-serializable shape of a params pytree (leaves -> None) —
    recorded at save time so load can rebuild the probe treedef for any
    param structure, including composite-kernel terms/factors nesting."""
    if isinstance(p, dict):
        return {k: _tree_struct(v) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [_tree_struct(v) for v in p]
    return None


def _probe_from_struct(s):
    if isinstance(s, dict):
        return {k: _probe_from_struct(v) for k, v in s.items()}
    if isinstance(s, list):
        return [_probe_from_struct(v) for v in s]
    return np.zeros(())


@dataclasses.dataclass
class GP:
    """Exact Gaussian-process regression.

    Parameters
    ----------
    kind: kernel family — 'rbf' | 'matern12' | 'matern32' | 'matern52' |
        'rq' | 'periodic' | 'linear'.
    jitter: diagonal jitter (times signal variance) for PD safety.
    method: dense Cholesky path — 'auto' | 'xla' | 'blocked'.
    """

    kind: str = "rbf"
    jitter: float = 1e-6
    method: str = "auto"
    basis: Optional[str] = None  # None | "constant" | "linear" (GPML 2.7)
    normalize_y: bool = False    # standardize targets internally
    params: Optional[dict] = None
    X: Optional[Any] = None
    y: Optional[Any] = None
    y_mean: float = 0.0
    y_std: float = 1.0

    def __post_init__(self):
        kernel_ops.validate_kind(self.kind)
        if self.basis not in (None, "constant", "linear"):
            raise ValueError(f"unknown basis {self.basis!r}")

    def _data(self, X, y):
        """Validate; with normalize_y, standardize targets and record the
        stats. self.y is ALWAYS the internal (standardized) targets;
        predictions and the reported LML are mapped back to y units."""
        X = jnp.asarray(X, dtype=jnp.float32)
        y = jnp.asarray(y, dtype=jnp.float32)
        if X.ndim != 2:
            raise ValueError(f"X must be (n, d), got shape {X.shape}")
        if y.ndim != 1 or y.shape[0] != X.shape[0]:
            raise ValueError(
                f"y must be (n,) matching X (n={X.shape[0]}), got {y.shape}")
        if self.normalize_y:
            self.y_mean = float(jnp.mean(y))
            self.y_std = float(jnp.maximum(jnp.std(y), 1e-12))
            y = (y - self.y_mean) / self.y_std
        return X, y

    def _out_mean(self, mu):
        return mu * self.y_std + self.y_mean if self.normalize_y else mu

    def _out_var(self, v):
        return v * (self.y_std ** 2) if self.normalize_y else v

    def _out_lml(self, lml):
        """log p(y) = log p(y_std) - n log(sigma_y) (change of variables)."""
        import math

        if not self.normalize_y:
            return lml
        return lml - self.y.shape[0] * math.log(self.y_std)

    def fit(self, X, y, *, steps=200, optimizer="adam", learning_rate=0.05,
            init=None, key=None, log_prior=None, objective="lml",
            restarts=1):
        """MAP hyperparameter fit by maximizing the LML — or, with
        log_prior (callable params dict -> scalar), the log posterior
        (inference/map_opt; map_opt.weak_log_prior matches the samplers'
        default prior). objective="loo" maximizes the leave-one-out
        pseudo-likelihood instead (GPML section 5.4.2; see loo()).
        restarts > 1: multi-start optimization as one vmapped program
        (map_opt.fit_restarts) — the LML surface is multimodal in
        lengthscale/period space; the best final objective wins."""
        from cugp_tpu.inference import map_opt

        X, y = self._data(X, y)
        if init is None:
            init = kernel_ops.default_init(self.kind, d=X.shape[1])
        kw = dict(kind=self.kind, jitter=self.jitter, method=self.method,
                  steps=steps, optimizer=optimizer,
                  learning_rate=learning_rate, basis=self.basis,
                  log_prior=log_prior, objective=objective)
        if restarts > 1:
            params, info = map_opt.fit_restarts(
                init, X, y, restarts=restarts, key=key, **kw)
        else:
            params, info = map_opt.fit(init, X, y, **kw)
        self.params, self.X, self.y = params, X, y
        return info

    def condition(self, X, y, params=None):
        """Attach data (and optionally hyperparameters) without fitting."""
        self.X, self.y = self._data(X, y)
        if params is not None:
            self.params = jax.tree.map(
                lambda v: jnp.asarray(v, jnp.float32), params)
        elif self.params is None:
            self.params = kernel_ops.default_init(self.kind, d=self.X.shape[1])
        return self

    def log_marginal_likelihood(self, params=None):
        p = params if params is not None else self.params
        if self.basis is not None:
            lml = exact_gp.log_marginal_likelihood_basis(
                p, self.X, self.y, kind=self.kind, jitter=self.jitter,
                method=self.method, basis=self.basis)
        else:
            lml = exact_gp.log_marginal_likelihood(
                p, self.X, self.y, kind=self.kind, jitter=self.jitter,
                method=self.method,
            )
        return self._out_lml(lml)

    def loo(self, params=None):
        """Leave-one-out cross-validation at the training points from ONE
        factorization (GPML section 5.4.2; exact_gp.loo_cv) — no refits.
        Returns dict with per-point predictive "mean"/"var" (of the noisy
        observation, in y units), per-point "logp", and the scalar
        "pseudo_likelihood" = sum(logp). Optimize it directly with
        fit(objective="loo")."""
        import math

        if self.basis is not None:
            raise NotImplementedError(
                "loo() is defined for the zero-mean model (basis=None)")
        p = params if params is not None else self.params
        mu, var, logp = exact_gp.loo_cv(
            p, self.X, self.y, kind=self.kind, jitter=self.jitter,
            method=self.method)
        if self.normalize_y:
            logp = logp - math.log(self.y_std)
        return {
            "mean": self._out_mean(mu),
            "var": self._out_var(var),
            "logp": logp,
            "pseudo_likelihood": jnp.sum(logp),
        }

    def predict(self, Xs, *, include_noise=False, full_cov=False, batch=4096):
        """Posterior mean/variance at Xs, tiled over test batches.

        With a basis configured, the semiparametric corrections apply and
        the fitted coefficients land in self.beta.
        """
        Xs = jnp.asarray(Xs, dtype=jnp.float32)
        if self.basis is not None:
            if full_cov:
                if include_noise:
                    raise ValueError("full_cov returns the latent posterior"
                                     " covariance; include_noise applies to"
                                     " the diagonal path only")
                mu, cov, beta = exact_gp.posterior_basis_full_cov(
                    self.params, self.X, self.y, Xs, kind=self.kind,
                    jitter=self.jitter, method=self.method,
                    basis=self.basis)
                self.beta = beta
                return self._out_mean(mu), self._out_var(cov)
            mu, var, beta = exact_gp.posterior_basis(
                self.params, self.X, self.y, Xs, kind=self.kind,
                jitter=self.jitter, method=self.method, basis=self.basis,
                include_noise=include_noise)
            self.beta = beta
            return self._out_mean(mu), self._out_var(var)
        if full_cov:
            mu, cov = exact_gp.posterior_full_cov(
                self.params, self.X, self.y, Xs, kind=self.kind,
                jitter=self.jitter, method=self.method,
            )
            return self._out_mean(mu), self._out_var(cov)
        m = Xs.shape[0]
        if m <= batch:
            mu, var = exact_gp.posterior(
                self.params, self.X, self.y, Xs, kind=self.kind,
                jitter=self.jitter, method=self.method,
                include_noise=include_noise,
            )
            return self._out_mean(mu), self._out_var(var)
        # pad the ragged final batch so every slice compiles once, and keep
        # jax arrays throughout (same return type as the small-m path)
        mus, vars_ = [], []
        for lo in range(0, m, batch):
            xs_b = Xs[lo:lo + batch]
            pad = batch - xs_b.shape[0]
            if pad:
                xs_b = jnp.pad(xs_b, ((0, pad), (0, 0)))
            mu, var = exact_gp.posterior(
                self.params, self.X, self.y, xs_b, kind=self.kind,
                jitter=self.jitter, method=self.method,
                include_noise=include_noise,
            )
            if pad:
                mu, var = mu[:-pad], var[:-pad]
            mus.append(mu)
            vars_.append(var)
        return (self._out_mean(jnp.concatenate(mus)),
                self._out_var(jnp.concatenate(vars_)))

    def sample_hyperparams(self, *, num_samples=512, num_chains=8,
                           num_warmup=256, sampler="nuts", key=None,
                           init=None, max_tree_depth=8, chain_block=0):
        """Posterior over hyperparameters via NUTS/HMC (inference tier).

        chain_block > 0 runs the chains as lax.map over chain_block-wide
        vmapped blocks inside ONE program (hmc.blocked_chains); 0 (the
        default) vmaps all chains at once.

        With normalize_y=True the posterior is over the STANDARDIZED
        model's hyperparameters (signal/noise variances are in units of
        sigma_y^2; lengthscales are unaffected)."""
        from cugp_tpu.inference import sampling

        if init is None:
            init = self.params or kernel_ops.default_init(self.kind, d=self.X.shape[1])
        return sampling.sample_hyperparams(
            init, self.X, self.y, kind=self.kind, jitter=self.jitter,
            method=self.method, num_samples=num_samples, num_chains=num_chains,
            num_warmup=num_warmup, sampler=sampler, key=key,
            max_tree_depth=max_tree_depth, chain_block=chain_block,
        )

    def fit_sparse(self, X, y, *, num_inducing=512, steps=500,
                   learning_rate=0.05, optimize_inducing=True, seed=0):
        """SGPR fit (Titsias collapsed bound, models/sgpr.py): O(n m^2).

        Stores inducing points in self.Z; predict_sparse serves the sparse
        posterior. Use when n is too large for the dense pipeline.
        """
        from cugp_tpu.models import sgpr

        X, y = self._data(X, y)
        init = self.params or kernel_ops.default_init(self.kind, d=X.shape[1])
        params, Z, info = sgpr.fit(
            init, X, y, num_inducing=num_inducing, kind=self.kind,
            jitter=self.jitter, steps=steps, learning_rate=learning_rate,
            optimize_inducing=optimize_inducing, seed=seed)
        self.params, self.X, self.y = params, X, y
        self.Z = Z
        return info

    def predict_sparse(self, Xs, *, include_noise=False):
        """Posterior mean/variance through the fitted inducing points."""
        from cugp_tpu.models import sgpr

        Xs = jnp.asarray(Xs, jnp.float32)
        mu, var = sgpr.posterior(self.params, self.Z, self.X, self.y, Xs,
                                 kind=self.kind, jitter=self.jitter,
                                 include_noise=include_noise)
        return self._out_mean(mu), self._out_var(var)

    def sample_posterior(self, Xs, num_samples=8, key=None, jitter=1e-6):
        """Draw function samples from the posterior at Xs.

        f ~ N(mu, Sigma) via Sigma's Cholesky factor (full posterior
        covariance; use moderate len(Xs)).
        """
        import jax
        import jax.numpy as jnp
        from cugp_tpu.models import exact_gp

        if key is None:
            key = jax.random.key(0)
        Xs = jnp.asarray(Xs, jnp.float32)
        mu, cov = exact_gp.posterior_full_cov(
            self.params, self.X, self.y, Xs, kind=self.kind,
            jitter=self.jitter, method=self.method)
        m = cov.shape[0]
        # posterior covariance can be numerically indefinite at fp32; scale
        # the jitter by its diagonal and use the escalating-jitter ladder
        scale = jnp.maximum(jnp.mean(jnp.diagonal(cov)), 1e-12)
        Ls = exact_gp.safe_cholesky(
            cov + jitter * scale * jnp.eye(m, dtype=cov.dtype), scale,
            method="xla", max_attempts=3, jitter0=max(jitter, 1e-6))
        eps = jax.random.normal(key, (m, num_samples), cov.dtype)
        return self._out_mean(mu[None, :] + (Ls @ eps).T)  # (num_samples, m)

    def fit_iterative(self, X, y, *, steps=50, learning_rate=0.05,
                      init=None, key=None, log_prior=None, **kw):
        """Matrix-free MAP hyperparameter fit (map_opt.fit_iterative) —
        hyperparameter LEARNING at N beyond the dense Cholesky ceiling:
        per step, preconditioned CG solves + a Hutchinson/AD gradient
        sweep; K is never formed. Extra kwargs (precond_rank, num_probes,
        tol, block, ...) pass through to map_opt.fit_iterative."""
        from cugp_tpu.inference import map_opt

        if self.basis is not None:
            raise NotImplementedError(
                "fit_iterative is defined for the zero-mean model; "
                "the basis-marginalized LML needs the dense tier")
        X, y = self._data(X, y)
        if init is None:
            init = kernel_ops.default_init(self.kind, d=X.shape[1])
        params, info = map_opt.fit_iterative(
            init, X, y, kind=self.kind, jitter=self.jitter, steps=steps,
            learning_rate=learning_rate, key=key, log_prior=log_prior, **kw)
        self.params, self.X, self.y = params, X, y
        self._precond_cache = None
        return info

    def _iterative_precond(self, precond_rank, params):
        """(Lk, Lg, s2) pivoted-Cholesky factors for the iterative entry
        points, built on the device as their OWN program and cached by
        (params, X, rank) object identity."""
        from cugp_tpu.inference import iterative

        n = self.X.shape[0]
        if precond_rank == "auto":
            # small problems converge in few CG iterations anyway; the
            # factor build would dominate
            precond_rank = 128 if n >= 8192 else 0
        if not precond_rank:
            return None
        cached = getattr(self, "_precond_cache", None)
        if cached is not None:
            c_params, c_X, c_rank, fac = cached
            if c_params is params and c_X is self.X and c_rank == precond_rank:
                return fac
        fac = iterative.precond_factors(
            params, self.X, precond_rank, kind=self.kind,
            jitter=self.jitter)
        self._precond_cache = (params, self.X, precond_rank, fac)
        return fac

    @staticmethod
    def _segment_auto(segment_iters):
        """Resolve segment_iters: "auto" is 0, one program per solve."""
        return 0 if segment_iters == "auto" else int(segment_iters)

    def log_marginal_likelihood_iterative(self, params=None, *, block=4096,
                                          num_probes=16, num_steps=32,
                                          key=None, precond_rank="auto",
                                          segment_iters="auto"):
        """Matrix-free LML (CG + stochastic Lanczos) for N beyond the dense
        Cholesky memory ceiling (inference/iterative.py). CG runs under
        the pivoted-Cholesky preconditioner by default at n >= 8192
        (precond_rank="auto"; pass 0 to disable, or an int rank).
        segment_iters: >0 bounds every device program to ~that many
        matvecs (iterative.lml_iterative_segmented); "auto" (0) runs one
        program per solve."""
        import jax
        from cugp_tpu.inference import iterative

        p = params if params is not None else self.params
        pre = self._iterative_precond(precond_rank, p)
        seg = self._segment_auto(segment_iters)
        if seg:
            return self._out_lml(iterative.lml_iterative_segmented(
                p, self.X, self.y, key=key or jax.random.key(0),
                kind=self.kind, jitter=self.jitter, block=block,
                iters_per_program=seg, num_probes=num_probes,
                num_steps=num_steps, precond=pre))
        return self._out_lml(iterative.lml_iterative(
            p, self.X, self.y, key=key or jax.random.key(0), kind=self.kind,
            jitter=self.jitter, block=block, num_probes=num_probes,
            num_steps=num_steps, precond=pre))

    def predict_iterative(self, Xs, *, block=4096, tol=1e-6,
                          include_noise=False, precond_rank="auto",
                          segment_iters="auto", col_batch=256):
        """Matrix-free posterior via batched CG solves (no N x N storage).

        precond_rank="auto": at n >= 8192 the solves run under a rank-128
        pivoted-Cholesky preconditioner built (and cached) as its own
        program — the production 100k path at ~100 CG iterations instead
        of ~650 unpreconditioned (PERF.md; round-3 VERDICT next #5).
        segment_iters: >0 routes through the segmented schedule
        (iterative.posterior_iterative_segmented): bounded per-program CG
        work AND test points streamed in `col_batch`-column chunks, so
        both compute and device memory stay bounded at any n; "auto" (0)
        runs one program per solve."""
        import jax.numpy as jnp
        from cugp_tpu.inference import iterative

        Xs = jnp.asarray(Xs, jnp.float32)
        pre = self._iterative_precond(precond_rank, self.params)
        seg = self._segment_auto(segment_iters)
        if seg:
            mu, var = iterative.posterior_iterative_segmented(
                self.params, self.X, self.y, Xs, kind=self.kind,
                jitter=self.jitter, block=block, tol=max(tol, 1e-5),
                iters_per_program=seg, include_noise=include_noise,
                precond=pre, col_batch=col_batch)
        else:
            mu, var = iterative.posterior_iterative(
                self.params, self.X, self.y, Xs, kind=self.kind,
                jitter=self.jitter, block=block, tol=tol,
                include_noise=include_noise, precond=pre)
        return self._out_mean(mu), self._out_var(var)

    def save(self, path):
        """Persist hyperparameters + conditioning data (utils.checkpoint)."""
        from cugp_tpu.utils import checkpoint

        checkpoint.save(path, {"params": self.params, "X": self.X,
                               "y": self.y},
                        extra_json={"kind": self.kind, "jitter": self.jitter,
                                    "method": self.method,
                                    "normalize_y": self.normalize_y,
                                    "y_mean": self.y_mean,
                                    "y_std": self.y_std,
                                    "param_keys": sorted(self.params),
                                    "param_struct": _tree_struct(self.params)})

    @classmethod
    def load(cls, path):
        """Restore a GP saved with save().

        The probe tree is rebuilt from the saved param key names (recorded
        in meta extra_json), so kernels with extra hyperparameters — e.g.
        'rq' with log_alpha — roundtrip correctly. Checkpoints from before
        param_keys was recorded fall back on the leaf count (6 leaves =
        3 base params + log_alpha + X + y).
        """
        import numpy as np
        from cugp_tpu.utils import checkpoint

        meta0 = checkpoint.peek_meta(path)
        if meta0 is None:
            raise FileNotFoundError(path)
        struct = meta0.get("extra", {}).get("param_struct")
        if struct is not None:
            pprobe = _probe_from_struct(struct)
        else:
            keys = meta0.get("extra", {}).get("param_keys")
            if keys is None:
                keys = ["log_lengthscale", "log_noise_var", "log_signal_var"]
                if meta0.get("num_leaves") == 6:
                    keys.append("log_alpha")
            pprobe = {k: np.zeros(()) for k in keys}
        probe = {"params": pprobe, "X": np.zeros((1, 1)), "y": np.zeros(1)}
        tree, meta = checkpoint.restore(path, probe)
        if tree is None:
            raise FileNotFoundError(path)
        gp = cls(kind=meta["extra"]["kind"], jitter=meta["extra"]["jitter"],
                 method=meta["extra"]["method"])
        # condition with normalize_y off: saved y is ALREADY standardized;
        # restore the recorded stats afterwards
        gp.condition(tree["X"], tree["y"], params=tree["params"])
        gp.normalize_y = meta["extra"].get("normalize_y", False)
        gp.y_mean = meta["extra"].get("y_mean", 0.0)
        gp.y_std = meta["extra"].get("y_std", 1.0)
        return gp

    def fit_classifier(self, X, y, **kw):
        """Convenience: build a GPClassifier with this GP's config and fit."""
        clf = GPClassifier(kind=self.kind, jitter=self.jitter,
                           method=self.method)
        clf.fit(X, y, **kw)
        return clf

    def fit_vi(self, *, steps=2000, learning_rate=0.01, rank="meanfield",
               num_mc=8, key=None, init=None):
        """Variational posterior over hyperparameters (inference/vi).
        Same normalize_y caveat as sample_hyperparams."""
        from cugp_tpu.inference import vi

        if init is None:
            init = self.params or kernel_ops.default_init(self.kind, d=self.X.shape[1])
        return vi.fit(
            init, self.X, self.y, kind=self.kind, jitter=self.jitter,
            method=self.method, steps=steps, learning_rate=learning_rate,
            rank=rank, num_mc=num_mc, key=key,
        )


@dataclasses.dataclass
class GPClassifier:
    """GP classification via the Laplace approximation.

    Two classes route to the binary model — inference="laplace"
    (models/gpc, logistic likelihood, GPML Alg 3.1/3.2, MacKay probit
    predictive) or inference="ep" (models/gpc_ep, probit likelihood,
    parallel EP, GPML ch. 3.6 — the more accurate classical scheme;
    its predictive probit integral is exact). Three or more classes
    route to the multiclass softmax-Laplace model (models/gpc_multiclass,
    GPML Alg 3.3/3.4 — predict_proba returns an (m, C) matrix in
    classes_ order; EP is binary-only). Labels may be anything hashable;
    predict() returns them in their original form via classes_.
    """

    kind: str = "rbf"
    jitter: float = 1e-6
    method: str = "auto"
    inference: str = "laplace"   # laplace | ep (binary only)
    params: Optional[dict] = None
    X: Optional[Any] = None
    y: Optional[Any] = None
    classes_: Optional[Any] = None

    def _data(self, X, y):
        X = jnp.asarray(X, jnp.float32)
        y = np.asarray(y)
        classes = np.unique(y)
        if classes.shape[0] < 2:
            raise ValueError(f"need at least 2 classes, got {classes}")
        self.classes_ = classes
        if classes.shape[0] == 2:
            ypm = np.where(y == classes[1], 1.0, -1.0).astype(np.float32)
            return X, jnp.asarray(ypm)
        idx = np.searchsorted(classes, y)
        from cugp_tpu.models import gpc_multiclass

        return X, gpc_multiclass.one_hot(idx, classes.shape[0])

    @property
    def _multiclass(self):
        return self.classes_ is not None and len(self.classes_) > 2

    def fit(self, X, y, *, steps=100, learning_rate=0.05, init=None,
            num_newton=20):
        X, yenc = self._data(X, y)
        if init is None:
            init = kernel_ops.default_init(self.kind, d=X.shape[1])
        if self._multiclass:
            if self.inference == "ep":
                raise ValueError("inference='ep' is binary-only; "
                                 "multiclass uses the softmax Laplace")
            from cugp_tpu.models import gpc_multiclass as model
        elif self.inference == "ep":
            from cugp_tpu.models import gpc_ep as model
        elif self.inference == "laplace":
            from cugp_tpu.models import gpc as model
        else:
            raise ValueError(f"unknown inference {self.inference!r}")
        params, info = model.fit(
            init, X, yenc, kind=self.kind, jitter=self.jitter,
            method=self.method, steps=steps, learning_rate=learning_rate,
            num_newton=num_newton)
        self.params, self.X, self.y = params, X, yenc
        return info

    def predict_proba(self, Xs, *, num_newton=20):
        Xs = jnp.asarray(Xs, jnp.float32)
        if self._multiclass:
            from cugp_tpu.models import gpc_multiclass

            p, _, _ = gpc_multiclass.predict_proba(
                self.params, self.X, self.y, Xs, kind=self.kind,
                jitter=self.jitter, method=self.method,
                num_newton=num_newton)
            return p
        if self.inference == "ep":
            from cugp_tpu.models import gpc_ep

            p, _, _ = gpc_ep.predict_proba(
                self.params, self.X, self.y, Xs,
                kind=self.kind, jitter=self.jitter, method=self.method)
            return p
        from cugp_tpu.models import gpc

        p, _, _ = gpc.predict_proba(
            self.params, self.X, self.y, Xs,
            kind=self.kind, jitter=self.jitter, method=self.method,
            num_newton=num_newton)
        return p

    def predict(self, Xs):
        proba = self.predict_proba(Xs)
        if self._multiclass:
            return self.classes_[np.asarray(jnp.argmax(proba, axis=1))]
        return self.classes_[np.asarray(proba > 0.5, dtype=np.int64)]

    def save(self, path):
        """Persist hyperparameters, conditioning data, and the label set."""
        from cugp_tpu.utils import checkpoint

        checkpoint.save(
            path,
            {"params": self.params, "X": self.X, "y": self.y,
             "classes": np.asarray(self.classes_)},
            extra_json={"kind": self.kind, "jitter": self.jitter,
                        "method": self.method, "model": "gpc",
                        "inference": self.inference,
                        "param_struct": _tree_struct(self.params)})

    @classmethod
    def load(cls, path):
        from cugp_tpu.utils import checkpoint

        meta0 = checkpoint.peek_meta(path)
        if meta0 is None:
            raise FileNotFoundError(path)
        extra = meta0.get("extra", {})
        probe = {"params": _probe_from_struct(extra["param_struct"]),
                 "X": np.zeros((1, 1)), "y": np.zeros(1),
                 "classes": np.zeros(1)}
        tree, _meta = checkpoint.restore(path, probe)
        clf = cls(kind=extra["kind"], jitter=extra["jitter"],
                  method=extra["method"],
                  inference=extra.get("inference", "laplace"))
        clf.params = {k: jnp.asarray(v) for k, v in tree["params"].items()}
        clf.X = jnp.asarray(tree["X"])
        clf.y = jnp.asarray(tree["y"])
        clf.classes_ = np.asarray(tree["classes"])
        return clf


@dataclasses.dataclass
class SVGP:
    """Stochastic variational GP (models/svgp): minibatch SGD on the
    uncollapsed inducing-point bound — scales past both the exact model
    (O(n^3)) and SGPR (full K_mn per step), and supports non-Gaussian
    likelihoods.

    likelihood: 'gaussian' (regression) | 'bernoulli' (classification,
    labels mapped to {-1, +1}) | 'poisson' (counts, log link) |
    'student_t' (robust regression, nu=svgp.STUDENT_T_NU).
    """

    kind: str = "rbf"
    jitter: float = 1e-6
    likelihood: str = "gaussian"
    params: Optional[dict] = None
    Z: Optional[Any] = None
    vp: Optional[dict] = None

    def __post_init__(self):
        from cugp_tpu.models import svgp as svgp_mod

        kernel_ops.validate_kind(self.kind)
        if self.likelihood not in svgp_mod.LIKELIHOODS:
            raise ValueError(
                f"unknown likelihood {self.likelihood!r}; supported: "
                f"{svgp_mod.LIKELIHOODS}")

    def _encode(self, y):
        """y -> {-1,+1} for bernoulli. Reuses the classes recorded at fit
        time when present, so elbo() on a single-class slice encodes
        consistently instead of re-inferring labels per call."""
        if self.likelihood != "bernoulli":
            return jnp.asarray(y, jnp.float32), None
        y = np.asarray(y)
        classes = getattr(self, "_classes", None)
        if classes is None:
            classes = np.unique(y)
            if classes.shape[0] != 2:
                raise ValueError(f"need exactly 2 classes, got {classes}")
        elif not np.isin(y, classes).all():
            raise ValueError(
                f"labels {np.unique(y)} not within fitted classes {classes}")
        return jnp.asarray(np.where(y == classes[1], 1.0, -1.0)
                           .astype(np.float32)), classes

    def fit(self, X, y, *, num_inducing=256, steps=2000, batch=256,
            learning_rate=0.01, optimize_inducing=True, init=None, seed=0):
        from cugp_tpu.models import svgp as svgp_mod

        X = jnp.asarray(X, jnp.float32)
        y, self._classes = self._encode(y)
        if init is None:
            init = kernel_ops.default_init(self.kind, d=X.shape[1])
        self.params, self.Z, self.vp, info = svgp_mod.fit(
            init, X, y, num_inducing=num_inducing, kind=self.kind,
            jitter=self.jitter, likelihood=self.likelihood, steps=steps,
            batch=batch, learning_rate=learning_rate,
            optimize_inducing=optimize_inducing, seed=seed)
        return info

    def predict(self, Xs, *, include_noise=False):
        """Predictive mean/variance (gaussian/student_t), rate (poisson),
        or hard labels in the ORIGINAL label set (bernoulli)."""
        from cugp_tpu.models import svgp as svgp_mod

        Xs = jnp.asarray(Xs, jnp.float32)
        if self.likelihood == "bernoulli":
            pos = np.asarray(self.predict_proba(Xs)) > 0.5
            classes = getattr(self, "_classes", None)
            if classes is None:
                return jnp.where(pos, 1, -1)
            return np.where(pos, classes[1], classes[0])
        if self.likelihood == "poisson":
            return svgp_mod.predict_rate(self.params, self.Z, self.vp, Xs,
                                         kind=self.kind, jitter=self.jitter)
        return svgp_mod.posterior(self.params, self.Z, self.vp, Xs,
                                  kind=self.kind, jitter=self.jitter,
                                  include_noise=include_noise,
                                  likelihood=self.likelihood)

    def predict_proba(self, Xs):
        from cugp_tpu.models import svgp as svgp_mod

        if self.likelihood != "bernoulli":
            raise ValueError("predict_proba needs likelihood='bernoulli'")
        p, _, _ = svgp_mod.predict_proba(
            self.params, self.Z, self.vp, jnp.asarray(Xs, jnp.float32),
            kind=self.kind, jitter=self.jitter)
        return p

    def elbo(self, X, y):
        """Full-batch bound at the fitted state (diagnostic)."""
        from cugp_tpu.models import svgp as svgp_mod

        X = jnp.asarray(X, jnp.float32)
        y, _ = self._encode(y)
        return svgp_mod.elbo(self.params, self.Z, self.vp, X, y,
                             kind=self.kind, jitter=self.jitter,
                             likelihood=self.likelihood)

    def save(self, path):
        """Persist hyperparameters, inducing points, and q(v) — the full
        predictive state (training data is NOT needed at predict time)."""
        from cugp_tpu.utils import checkpoint

        tree = {"params": self.params, "Z": self.Z, "vp": self.vp}
        classes = getattr(self, "_classes", None)
        if classes is not None:
            tree["classes"] = np.asarray(classes)
        checkpoint.save(
            path, tree,
            extra_json={"kind": self.kind, "jitter": self.jitter,
                        "likelihood": self.likelihood, "model": "svgp",
                        "has_classes": classes is not None,
                        "param_struct": _tree_struct(self.params)})

    @classmethod
    def load(cls, path):
        from cugp_tpu.utils import checkpoint

        meta0 = checkpoint.peek_meta(path)
        if meta0 is None:
            raise FileNotFoundError(path)
        extra = meta0.get("extra", {})
        probe = {"params": _probe_from_struct(extra["param_struct"]),
                 "Z": np.zeros((1, 1)),
                 "vp": {"m": np.zeros(1), "c": np.zeros(1)}}
        if extra.get("has_classes"):
            probe["classes"] = np.zeros(1)
        tree, _meta = checkpoint.restore(path, probe)
        model = cls(kind=extra["kind"], jitter=extra["jitter"],
                    likelihood=extra["likelihood"])
        model.params = {k: jnp.asarray(v) for k, v in tree["params"].items()}
        model.Z = jnp.asarray(tree["Z"])
        model.vp = {k: jnp.asarray(v) for k, v in tree["vp"].items()}
        if extra.get("has_classes"):
            model._classes = np.asarray(tree["classes"])
        return model


@dataclasses.dataclass
class MultiOutputGP:
    """Correlated multi-output GP regression (LMC / intrinsic
    coregionalization, models/lmc.py).

    Joint prior covariance B (x) K with learnable low-rank-plus-diagonal
    B = A A^T + diag(softplus(raw_d)); solved exactly at O(p n^3) via the
    eigendecomposition rotation (no pn x pn matrix). For UNCORRELATED
    outputs sharing one kernel use GP with exact_gp.*_multi instead.
    """

    kind: str = "rbf"
    jitter: float = 1e-6
    method: str = "auto"
    rank: int = 1
    params: Optional[dict] = None
    X: Optional[Any] = None
    Y: Optional[Any] = None

    def fit(self, X, Y, *, steps=200, learning_rate=0.05, init=None,
            seed=0):
        from cugp_tpu.models import lmc

        X = jnp.asarray(X, jnp.float32)
        Y = jnp.asarray(Y, jnp.float32)
        if Y.ndim != 2:
            raise ValueError(f"Y must be (n, p); got {Y.shape}")
        if init is None:
            init = lmc.init_lmc_params(d=X.shape[1], p=Y.shape[1],
                                       q=self.rank, seed=seed)
        params, info = lmc.fit(init, X, Y, kind=self.kind,
                               jitter=self.jitter, method=self.method,
                               steps=steps, learning_rate=learning_rate)
        self.params, self.X, self.Y = params, X, Y
        return info

    def predict(self, Xs, *, include_noise=False, full_output_cov=False):
        """Mean (m, p) and per-point output variance (m, p) — or the full
        (m, p, p) cross-output covariance with full_output_cov=True."""
        from cugp_tpu.models import lmc

        if self.params is None:
            raise RuntimeError("call fit() first")
        return lmc.posterior_lmc(
            self.params, self.X, self.Y, jnp.asarray(Xs, jnp.float32),
            kind=self.kind, jitter=self.jitter, method=self.method,
            include_noise=include_noise, full_output_cov=full_output_cov)

    def log_marginal_likelihood(self):
        from cugp_tpu.models import lmc

        if self.params is None:
            raise RuntimeError("call fit() first")
        return lmc.log_marginal_likelihood_lmc(
            self.params, self.X, self.Y, kind=self.kind,
            jitter=self.jitter, method=self.method)

    def output_correlation(self):
        """Fitted B normalized to a correlation matrix (p, p)."""
        from cugp_tpu.models import lmc

        B = lmc.coregionalization(self.params)
        s = jnp.sqrt(jnp.diagonal(B))
        return B / (s[:, None] * s[None, :])

    def save(self, path):
        """Persist LMC hyperparameters + conditioning data."""
        from cugp_tpu.utils import checkpoint

        checkpoint.save(
            path, {"params": self.params, "X": self.X, "Y": self.Y},
            extra_json={"kind": self.kind, "jitter": self.jitter,
                        "method": self.method, "rank": self.rank,
                        "model": "lmc",
                        "param_struct": _tree_struct(self.params)})

    @classmethod
    def load(cls, path):
        from cugp_tpu.utils import checkpoint

        meta0 = checkpoint.peek_meta(path)
        if meta0 is None:
            raise FileNotFoundError(path)
        extra = meta0.get("extra", {})
        probe = {"params": _probe_from_struct(extra["param_struct"]),
                 "X": np.zeros((1, 1)), "Y": np.zeros((1, 1))}
        tree, _meta = checkpoint.restore(path, probe)
        model = cls(kind=extra["kind"], jitter=extra["jitter"],
                    method=extra["method"], rank=extra.get("rank", 1))
        model.params = {k: jnp.asarray(v) for k, v in tree["params"].items()}
        model.X = jnp.asarray(tree["X"])
        model.Y = jnp.asarray(tree["Y"])
        return model


@dataclasses.dataclass
class MultiOutputGPQ:
    """Rank-Q LMC multi-output GP with DISTINCT latent kernels
    (models/lmc.py's lmcq family): joint prior sum_q (a_q a_q^T) (x) K_q
    — e.g. one periodic + one RBF latent process mixing into p outputs.

    Unlike MultiOutputGP (ICM: one shared kernel, eigendecomposition
    rotation), the rank-Q model has no common rotation; exact inference
    factors the dense pn x pn covariance — OR, past the dense ceiling,
    runs matrix-free on the sum-of-Kronecker operator
    (predict_iterative / log_marginal_likelihood_iterative: CG + SLQ,
    Sigma never formed; round-4 VERDICT next #8).
    """

    kinds: tuple = ("rbf", "rbf")
    jitter: float = 1e-6
    params: Optional[dict] = None
    X: Optional[Any] = None
    Y: Optional[Any] = None

    def _kinds(self):
        return tuple(self.kinds)

    def fit(self, X, Y, *, steps=200, learning_rate=0.05, init=None,
            seed=0):
        from cugp_tpu.models import lmc

        X = jnp.asarray(X, jnp.float32)
        Y = jnp.asarray(Y, jnp.float32)
        if Y.ndim != 2:
            raise ValueError(f"Y must be (n, p); got {Y.shape}")
        if init is None:
            init = lmc.init_lmcq_params(d=X.shape[1], p=Y.shape[1],
                                        kinds=self._kinds(), seed=seed)
        params, info = lmc.fit_lmcq(init, X, Y, kinds=self._kinds(),
                                    jitter=self.jitter, steps=steps,
                                    learning_rate=learning_rate)
        self.params, self.X, self.Y = params, X, Y
        return info

    def condition(self, X, Y, params=None, seed=0):
        """Attach data (and optionally params) without fitting."""
        from cugp_tpu.models import lmc

        self.X = jnp.asarray(X, jnp.float32)
        self.Y = jnp.asarray(Y, jnp.float32)
        self.params = params or lmc.init_lmcq_params(
            d=self.X.shape[1], p=self.Y.shape[1], kinds=self._kinds(),
            seed=seed)
        return self

    def predict(self, Xs, *, include_noise=False):
        """Dense posterior: mean (m, p) and per-output variance (m, p)."""
        from cugp_tpu.models import lmc

        if self.params is None:
            raise RuntimeError("call fit() or condition() first")
        return lmc.posterior_lmcq(
            self.params, self.X, self.Y, jnp.asarray(Xs, jnp.float32),
            self._kinds(), jitter=self.jitter,
            include_noise=include_noise)

    def predict_iterative(self, Xs, *, include_noise=False, block=4096,
                          tol=1e-6, max_iters=1000, col_batch=256,
                          segment_iters="auto"):
        """Matrix-free posterior on the joint operator — the path past
        the dense pn ceiling. segment_iters > 0 bounds per-program CG
        work; "auto" (0) runs one program per solve."""
        from cugp_tpu.models import lmc

        if self.params is None:
            raise RuntimeError("call fit() or condition() first")
        return lmc.posterior_lmcq_iterative(
            self.params, self.X, self.Y, jnp.asarray(Xs, jnp.float32),
            self._kinds(), jitter=self.jitter, block=block, tol=tol,
            max_iters=max_iters, include_noise=include_noise,
            col_batch=col_batch,
            segment_iters=0 if segment_iters == "auto" else int(segment_iters))

    def log_marginal_likelihood(self):
        from cugp_tpu.models import lmc

        if self.params is None:
            raise RuntimeError("call fit() or condition() first")
        return lmc.log_marginal_likelihood_lmcq(
            self.params, self.X, self.Y, self._kinds(),
            jitter=self.jitter)

    def log_marginal_likelihood_iterative(self, *, block=4096,
                                          num_probes=16, num_steps=32,
                                          key=None):
        """Matrix-free LML (CG + SLQ on the joint operator)."""
        from cugp_tpu.models import lmc

        if self.params is None:
            raise RuntimeError("call fit() or condition() first")
        return lmc.log_marginal_likelihood_lmcq_iterative(
            self.params, self.X, self.Y, self._kinds(),
            key=key or jax.random.key(0), jitter=self.jitter,
            block=block, num_probes=num_probes, num_steps=num_steps)

    def save(self, path):
        from cugp_tpu.utils import checkpoint

        checkpoint.save(
            path, {"params": self.params, "X": self.X, "Y": self.Y},
            extra_json={"kinds": list(self._kinds()),
                        "jitter": self.jitter, "model": "lmcq",
                        "param_struct": _tree_struct(self.params)})

    @classmethod
    def load(cls, path):
        from cugp_tpu.utils import checkpoint

        meta0 = checkpoint.peek_meta(path)
        if meta0 is None:
            raise FileNotFoundError(path)
        extra = meta0.get("extra", {})
        probe = {"params": _probe_from_struct(extra["param_struct"]),
                 "X": np.zeros((1, 1)), "Y": np.zeros((1, 1))}
        tree, _meta = checkpoint.restore(path, probe)
        model = cls(kinds=tuple(extra["kinds"]), jitter=extra["jitter"])
        model.params = jax.tree.map(jnp.asarray, tree["params"])
        model.X = jnp.asarray(tree["X"])
        model.Y = jnp.asarray(tree["Y"])
        return model
