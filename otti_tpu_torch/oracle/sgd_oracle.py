# copied from otti_tpu/oracle/sgd_oracle.py
"""SGD training oracle: produce the max-margin certificate weights.

Mirrors the reference's witness-time training step (sgdcodegen.py:17-27):
fit sklearn's SGDClassifier(loss="squared_hinge", alpha=0) and assert the
total subgradient norm is zero — i.e. every sample is classified with
margin >= 1 so the zero-subgradient optimality certificate exists.  The
solver runs *outside* the proof (SURVEY.md §0: witness oracle); soundness
never depends on it.

Falls back to a deterministic perceptron-style integer solver when
sklearn fails to converge to an exact certificate on integer data (the
synthetic datasets are constructed separable, so this always succeeds).
"""

from __future__ import annotations

import numpy as np


def _subgrad_ok(w: np.ndarray, X: np.ndarray, y: np.ndarray) -> bool:
    """Zero total squared-hinge subgradient == all margins >= 1
    (sgdcodegen.py:10-15 grad: nonzero only when y*(w.x) < 1)."""
    return bool(np.all(y * (X @ w) >= 1))


def _perceptron_int(X: np.ndarray, y: np.ndarray, max_epochs: int = 2000):
    """Integer margin perceptron: guaranteed on separable integer data."""
    n, d = X.shape
    w = np.zeros(d, dtype=np.int64)
    for _ in range(max_epochs):
        updated = False
        for i in range(n):
            if y[i] * (X[i] @ w) < 1:
                w = w + y[i] * X[i]
                updated = True
        if not updated:
            return w
    # scale-up trick: a separable dataset always admits an integer
    # certificate; scaling any real separator works too
    raise RuntimeError("SGD oracle: could not find integer certificate")


def _svc_round_int(X: np.ndarray, y: np.ndarray):
    """Scaled-rounded hard-margin separator -> integer certificate.

    For real benchmark data (wine, the breast-cancer prob half) the
    margin perceptron's (R/gamma)^2 mistake bound is astronomically bad
    (features span 0.1..16000 after decimal scaling), but a separator is
    easy to find in floats: fit near-hard-margin LinearSVC, normalize to
    min margin 1, then round K*w for growing K until the INTEGER margins
    y_i * (w_int . x_i) >= 1 hold exactly.  Soundness never depends on
    this (the circuit checks the margins); this is witness search only."""
    try:
        from sklearn.svm import LinearSVC

        clf = LinearSVC(
            C=1e6, max_iter=500_000, tol=1e-10, fit_intercept=False
        ).fit(X, y)
    except Exception:
        return None
    w = clf.coef_.flatten()
    marg = float(np.min(y * (X @ w)))
    if marg <= 0:
        return None
    for K in (2, 4, 8, 16, 32, 64, 128, 256, 1024, 4096, 16384):
        wi = np.round(K * w / marg).astype(np.int64)
        if _subgrad_ok(wi, X, y):
            return wi
    return None


def solve(X: np.ndarray, y: np.ndarray, seed=0, eta0=0.1, maxiter=1000, tol=1e-4):
    """-> integer weight vector w with y_i * (w . x_i) >= 1 for all i.

    Tries the reference's sklearn recipe first (same hyperparameters as
    datasets/SGD/pmlb-*.json), then the deterministic integer fallback.
    """
    try:
        from sklearn.linear_model import SGDClassifier

        clf = SGDClassifier(
            loss="squared_hinge",
            alpha=0.0,
            eta0=eta0,
            learning_rate="adaptive",
            random_state=seed,
            max_iter=maxiter,
            tol=tol,
            fit_intercept=True,
        )
        clf.fit(X, y)
        w = np.asarray([int(v) for v in clf.coef_.flatten()], dtype=np.int64)
        if _subgrad_ok(w, X, y):
            return w
    except Exception:
        pass
    try:
        w = _perceptron_int(X, y)
    except RuntimeError:
        w = _svc_round_int(X, y)
        if w is None:
            raise RuntimeError("SGD oracle: could not find integer certificate")
    assert _subgrad_ok(w, X, y)
    return w
