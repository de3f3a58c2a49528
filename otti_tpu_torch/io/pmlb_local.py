# copied from otti_tpu/io/pmlb_local.py
"""Hermetic PMLB-compatible dataset access for the SGD workload.

The reference fetches PMLB datasets over the network at codegen time
(sgdcodegen.py:30, SURVEY.md §3.3 "network fetch!").  This environment has
zero egress, so we provide: (1) a loader for locally cached PMLB CSVs if
present (PMLB_CACHE_DIR or ~/.pmlb), and (2) a deterministic synthetic
generator producing linearly separable integer datasets with the same
shape/feel as the benchmark configs — so every pipeline stage runs
hermetically.  The dataset *names and hyperparameters* still come from the
reference's datasets/SGD/pmlb-*.json configs.
"""

from __future__ import annotations

import json
import os

import numpy as np

# rough (n_samples, n_features) shapes of the benchmark datasets so the
# synthetic fallback exercises realistic sizes (public PMLB metadata)
_KNOWN_SHAPES = {
    "iris": (100, 4),
    "wine_recognition": (130, 13),
    "breast_cancer": (569, 30),
    "mushroom": (8124, 22),
    "ionosphere": (351, 34),
    "sonar": (208, 60),
    "spambase": (4601, 57),
    "diabetes": (768, 8),
}
_DEFAULT_SHAPE = (200, 10)


def _cache_paths(dataset: str):
    roots = [
        os.environ.get("PMLB_CACHE_DIR", ""),
        os.path.expanduser("~/.pmlb"),
        os.path.join(os.path.dirname(__file__), "..", "..", "datasets", "pmlb_cache"),
    ]
    for root in roots:
        if not root:
            continue
        for ext in (".tsv", ".csv"):
            p = os.path.join(root, dataset, dataset + ext)
            if os.path.exists(p):
                yield p


def synthesize(dataset: str, c1: int, c2: int, seed: int = 0):
    """Deterministic, linearly separable integer dataset (X, y) with
    y in {c1, c2}.  Separable with an *integer* weight vector so the
    squared-hinge SGD certificate (zero subgradient) exists — mirroring
    the reference's assertion that the certificate holds
    (sgdcodegen.py:22-27)."""
    n, d = _KNOWN_SHAPES.get(dataset, _DEFAULT_SHAPE)
    rng = np.random.default_rng(abs(hash((dataset, seed))) % (2**32))
    w_true = rng.integers(-4, 5, size=d)
    while not w_true.any():
        w_true = rng.integers(-4, 5, size=d)
    X = rng.integers(-20, 21, size=(n, d))
    margin = X @ w_true
    # force a margin of at least 1 by shifting along w_true where needed
    y = np.where(margin >= 0, 1, -1)
    scale = int(np.abs(w_true).sum())
    bump = rng.integers(1, 4, size=n)
    for i in range(n):
        while abs(int(X[i] @ w_true)) < scale * 2:
            X[i] += y[i] * bump[i] * np.sign(w_true) * (np.abs(w_true) > 0)
    labels = np.where(y == 1, c1, c2)
    return X.astype(np.int64), labels.astype(np.int64)


def fetch(dataset: str, c1: int, c2: int, seed: int = 0, scale: int = 1):
    """(X_int, y_pm1, source) filtered to the two classes, as the reference
    does (sgdcodegen.py:32-33: X .astype(int) truncation, labels mapped to
    +-1).  ``source`` is "pmlb_cache" for real benchmark data (the in-repo
    datasets/pmlb_cache TSVs, e.g. the canonical UCI iris/wine) or
    "synthetic" for the hermetic fallback.

    ``scale`` multiplies the raw features BEFORE integer truncation —
    decimal-preserving integerization for sets whose separating margin
    lives below the unit grid (wine's 0.xx features).  The proved
    statement is over the scaled integer dataset; metas record the
    factor as ``data_scale``."""
    for path in _cache_paths(dataset):
        sep = "\t" if path.endswith(".tsv") else ","
        import csv

        with open(path) as f:
            rows = list(csv.reader(f, delimiter=sep))
        header = rows[0]
        t_idx = header.index("target")
        data = np.asarray(
            [[float(v) for v in r] for r in rows[1:]], dtype=np.float64
        )
        mask = np.isin(data[:, t_idx], [c1, c2])
        data = data[mask]
        y = np.where(data[:, t_idx] == c1, 1, -1).astype(np.int64)
        X = (np.delete(data, t_idx, axis=1) * scale).astype(np.int64)
        return X, y, "pmlb_cache"
    X, labels = synthesize(dataset, c1, c2, seed)
    y = np.where(labels == c1, 1, -1).astype(np.int64)
    return X, y, "synthetic"


def load_config(json_path: str) -> dict:
    with open(json_path) as f:
        return json.load(f)
