"""FID, KID, Inception Score and PRDC: the metric math, feature-source
agnostic (port of ``tpugan/eval/fid.py``: numpy and scipy on the host, the
same arithmetic, so the same features give the same numbers bit for bit).

FID = ‖μr−μf‖² + Tr(Σr + Σf − 2·(Σr·Σf)^{1/2}) over pooled features of real
and generated image sets (Heusel et al. 2017).  IS = exp(E_x[KL(p(y|x) ‖
p(y))]) over classifier probabilities (Salimans et al. 2016).  The math here
is exactly the reference pipeline's; which network supplies features/probits
is decided by ``eval/features.py`` (InceptionV3 when weights are given, a
deterministic proxy otherwise).
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.linalg


def _sqrtm(a: np.ndarray) -> np.ndarray:
    # scipy <1.18 needs disp=False for the no-print path (and 1.17 warns
    # that disp is deprecated); >=1.18 drops the argument entirely.
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=DeprecationWarning)
        try:
            m, _ = scipy.linalg.sqrtm(a, disp=False)
        except TypeError:
            m = scipy.linalg.sqrtm(a)
    return m


def fid_from_features(feat_real: np.ndarray, feat_fake: np.ndarray,
                      eps: float = 1e-6) -> float:
    mu_r, mu_f = feat_real.mean(0), feat_fake.mean(0)
    sig_r = np.cov(feat_real, rowvar=False)
    sig_f = np.cov(feat_fake, rowvar=False)

    diff = mu_r - mu_f
    covmean = _sqrtm(sig_r @ sig_f)
    if not np.isfinite(covmean).all():
        # regularize singular covariances
        offset = np.eye(sig_r.shape[0]) * eps
        covmean = _sqrtm((sig_r + offset) @ (sig_f + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sig_r) + np.trace(sig_f)
                 - 2.0 * np.trace(covmean))


def kid_from_features(feat_real: np.ndarray, feat_fake: np.ndarray,
                      subset_size: int = 1000, n_subsets: int = 10,
                      seed: int = 0) -> tuple[float, float]:
    """Kernel Inception Distance (Bińkowski et al. 2018): unbiased MMD² with
    the polynomial kernel k(x,y) = (xᵀy/d + 1)³, averaged over random
    subsets.  Unlike FID, the estimator is unbiased — preferred when the
    sample budget is small."""
    rng = np.random.default_rng(seed)
    d = feat_real.shape[1]
    m = min(subset_size, len(feat_real), len(feat_fake))
    if m < 2:
        # the unbiased within-set term divides by m*(m-1)
        raise ValueError(
            f"KID needs at least 2 samples per set, got "
            f"{len(feat_real)} real / {len(feat_fake)} fake")
    if m == len(feat_real) and m == len(feat_fake):
        # subsets would all be full-set permutations (kernel sums are
        # permutation-invariant): one exact pass, zero estimator variance
        n_subsets = 1
    scores = []
    for _ in range(n_subsets):
        x = feat_real[rng.choice(len(feat_real), m, replace=False)]
        y = feat_fake[rng.choice(len(feat_fake), m, replace=False)]
        kxx = (x @ x.T / d + 1.0) ** 3
        kyy = (y @ y.T / d + 1.0) ** 3
        kxy = (x @ y.T / d + 1.0) ** 3
        # unbiased: drop diagonals of the within-set terms
        sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
        sum_yy = (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
        scores.append(float(sum_xx + sum_yy - 2.0 * kxy.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def inception_score(probs: np.ndarray, splits: int = 10
                    ) -> tuple[float, float]:
    """probs: (N, n_classes) softmax outputs of the scoring classifier."""
    n = len(probs)
    # With n < splits, array_split yields empty parts whose mean is NaN —
    # which would propagate into logged metrics; clamp to one-per-sample.
    splits = max(1, min(splits, n))
    scores = []
    for part in np.array_split(probs, splits):
        py = part.mean(0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(float(np.exp(kl.sum(1).mean())))
    return float(np.mean(scores)), float(np.std(scores))


def prdc_from_features(feat_real: np.ndarray, feat_fake: np.ndarray,
                       k: int = 5, chunk: int = 2048) -> dict:
    """Precision / Recall / Density / Coverage (Kynkäänniemi et al. 2019;
    Naeem et al. 2020): manifold-overlap metrics that separate fidelity
    (precision, density) from diversity (recall, coverage) — FID conflates
    the two.  k-NN radii define each set's manifold:

    - precision: fraction of fakes inside SOME real point's k-NN ball
    - recall:    fraction of reals inside SOME fake point's k-NN ball
    - density:   mean number of real k-NN balls covering a fake, / k
    - coverage:  fraction of reals whose k-NN ball contains SOME fake
    """
    fr = np.asarray(feat_real, np.float64)
    ff = np.asarray(feat_fake, np.float64)
    if min(len(fr), len(ff)) <= k:
        raise ValueError(f"need more than k={k} samples per set, got "
                         f"{len(fr)} real / {len(ff)} fake")

    def _pairwise(a, b):
        # (n, m) euclidean distances without materializing differences
        aa = np.sum(a * a, axis=1)[:, None]
        bb = np.sum(b * b, axis=1)[None, :]
        d2 = np.maximum(aa + bb - 2.0 * (a @ b.T), 0.0)
        return np.sqrt(d2)

    # Row-chunked throughout: a full (n, m) float64 matrix at the default
    # fid_n=10000 is 800 MB and np.partition copies it again — chunking
    # bounds the peak at chunk x m while computing identical per-row values.
    def _knn_radius(a):
        # k-th nearest EXCLUDING self (self-distance 0 occupies slot 0)
        out = np.empty(len(a), np.float64)
        for i in range(0, len(a), chunk):
            d = _pairwise(a[i:i + chunk], a)
            out[i:i + chunk] = np.partition(d, k, axis=1)[:, k]
        return out

    r_real = _knn_radius(fr)  # (n_real,)
    r_fake = _knn_radius(ff)  # (n_fake,)

    fake_in_some_real = np.zeros(len(ff), bool)  # fake j in ANY real ball
    real_balls_per_fake = np.zeros(len(ff), np.float64)
    coverage_hits = 0  # reals whose k-NN ball contains SOME fake
    recall_hits = 0    # reals inside SOME fake point's k-NN ball
    for i in range(0, len(fr), chunk):
        d = _pairwise(fr[i:i + chunk], ff)  # (c, n_fake)
        inside_real = d < r_real[i:i + chunk, None]
        fake_in_some_real |= inside_real.any(axis=0)
        real_balls_per_fake += inside_real.sum(axis=0)
        coverage_hits += int((d.min(axis=1) < r_real[i:i + chunk]).sum())
        recall_hits += int((d < r_fake[None, :]).any(axis=1).sum())

    return {"precision": float(fake_in_some_real.mean()),
            "recall": float(recall_hits / len(fr)),
            "density": float(real_balls_per_fake.mean() / k),
            "coverage": float(coverage_hits / len(fr))}
