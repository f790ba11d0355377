"""Synthetic stand-ins for the paper's eight datasets (App. B, Table 1).

A copy of ``repro.data.synth`` (numpy only): the same seed gives the same
arrays in both packages.

The UCI/OpenML tables are not downloaded.  Each generator matches the
original's (n, d, task, #classes) and is built to exercise the same
compression mechanisms the real data does:

  * redundant / correlated features  -> the feature penalty ι has room to act;
  * axis-aligned piecewise targets   -> trees are the right model class;
  * low-cardinality & boolean columns -> 1/2/4-bit threshold encodings and
    threshold sharing (ξ) pay off;
  * label noise                      -> quality/memory trade-offs are smooth.

All experiments compare ToaD against baselines *on identical data*, which is
what the paper's figures measure; absolute scores differ from UCI.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    x: np.ndarray
    y: np.ndarray
    task: str            # regression | binary | multiclass
    n_classes: int = 0

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def d(self) -> int:
        return self.x.shape[1]


def _redundant_block(rng, n, latent, out_dim, noise=0.1):
    """Mix ``latent`` (n, k) into ``out_dim`` correlated observed features."""
    k = latent.shape[1]
    mix = rng.normal(size=(k, out_dim)) * (rng.random((k, out_dim)) < 0.4)
    return latent @ mix + noise * rng.normal(size=(n, out_dim))


def make_covtype(n: int = 40_000, seed: int = 0, multiclass: bool = False) -> Dataset:
    """54 features: 10 continuous terrain + 4 one-hot wilderness + 40 one-hot
    soil types; 7 cover classes from terrain rules (or binarized class 2-vs-rest)."""
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(n, 6))
    cont = _redundant_block(rng, n, lat, 10, noise=0.3)
    cont[:, 0] = cont[:, 0] * 600 + 2800          # elevation-like
    cont[:, 1] = np.abs(cont[:, 1]) * 90          # slope-like
    wild = np.eye(4)[rng.integers(0, 4, n)]
    soil_id = np.clip((lat[:, 0] * 6 + rng.normal(size=n) + 20).astype(int) % 40, 0, 39)
    soil = np.eye(40)[soil_id]
    x = np.concatenate([cont, wild, soil], axis=1).astype(np.float32)
    score = (
        (cont[:, 0] - 2800) / 600
        + 0.5 * (cont[:, 1] > 45)
        + 0.8 * lat[:, 1]
        + 0.3 * soil_id / 40
        + 0.4 * rng.normal(size=n)
    )
    if multiclass:
        qs = np.quantile(score, [0.2, 0.45, 0.6, 0.75, 0.85, 0.95])
        y = np.digitize(score, qs).astype(np.float32)  # 7 classes
        return Dataset("covtype_multi", x, y, "multiclass", 7)
    y = (score > np.quantile(score, 0.51)).astype(np.float32)
    return Dataset("covtype_binary", x, y, "binary")


def make_california(n: int = 20_640, seed: int = 0) -> Dataset:
    """8 housing-like features, heavy-tailed, smooth nonlinear price target."""
    rng = np.random.default_rng(seed)
    inc = rng.lognormal(1.2, 0.5, n)              # median income
    age = rng.integers(1, 52, n).astype(float)    # house age (integer!)
    rooms = rng.lognormal(1.6, 0.3, n)
    bedrms = rooms * rng.uniform(0.15, 0.3, n)
    popn = rng.lognormal(7.0, 0.6, n)
    occup = rng.lognormal(1.0, 0.3, n)
    lati = rng.uniform(32.5, 42.0, n)
    longi = rng.uniform(-124.3, -114.3, n)
    x = np.stack([inc, age, rooms, bedrms, popn, occup, lati, longi], 1).astype(np.float32)
    coastal = np.exp(-np.abs(longi + 122) / 2.0)
    y = (
        2.0 * np.log1p(inc)
        + 0.8 * coastal
        + 0.01 * age
        - 0.3 * np.abs(lati - 34)
        + 0.15 * np.log(rooms / bedrms)
        + 0.2 * rng.normal(size=n)
    ).astype(np.float32)
    return Dataset("california_housing", x, y, "regression")


def make_kin8nm(n: int = 8_192, seed: int = 0) -> Dataset:
    """Forward kinematics of an 8-link planar arm (the real kin8nm's setup)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-np.pi / 2, np.pi / 2, (n, 8)).astype(np.float32)
    ang = np.cumsum(theta, axis=1)
    ex = np.sum(np.cos(ang), axis=1)
    ey = np.sum(np.sin(ang), axis=1)
    y = np.sqrt(ex**2 + ey**2).astype(np.float32) + 0.05 * rng.normal(size=n).astype(np.float32)
    return Dataset("kin8nm", theta, y, "regression")


def make_mushroom(n: int = 8_124, seed: int = 0) -> Dataset:
    """22 small-integer categorical features; edibility = noiseless DNF rules
    (the real mushroom dataset is separable)."""
    rng = np.random.default_rng(seed)
    card = rng.integers(2, 10, 22)
    x = np.stack([rng.integers(0, c, n) for c in card], 1).astype(np.float32)
    y = (
        ((x[:, 4] < 2) & (x[:, 8] > 1))
        | ((x[:, 2] == 0) & (x[:, 19] < 3))
        | (x[:, 11] > card[11] - 2)
    ).astype(np.float32)
    return Dataset("mushroom", x, y, "binary")


def make_wine(n: int = 6_497, seed: int = 0) -> Dataset:
    """11 physicochemical features; 7 ordinal quality classes (scores 3-9)."""
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(n, 4))
    x = _redundant_block(rng, n, lat, 11, noise=0.4).astype(np.float32)
    score = 1.2 * lat[:, 0] - 0.7 * lat[:, 1] + 0.4 * np.abs(lat[:, 2]) + 0.8 * rng.normal(size=n)
    qs = np.quantile(score, [0.03, 0.20, 0.55, 0.85, 0.97, 0.995])
    y = np.digitize(score, qs).astype(np.float32)
    return Dataset("wine_quality", x, y, "multiclass", 7)


def make_krkp(n: int = 3_196, seed: int = 0) -> Dataset:
    """36 boolean chess-position features; label = noisy XOR-of-conjunctions."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, 36)) < 0.5).astype(np.float32)
    rule = (
        (x[:, 0].astype(bool) & x[:, 5].astype(bool))
        ^ (x[:, 9].astype(bool) & ~x[:, 14].astype(bool))
        | (x[:, 20].astype(bool) & x[:, 21].astype(bool) & x[:, 22].astype(bool))
    )
    flip = rng.random(n) < 0.03
    y = (rule ^ flip).astype(np.float32)
    return Dataset("kr_vs_kp", x, y, "binary")


def make_breast_cancer(n: int = 569, seed: int = 0) -> Dataset:
    """30 highly correlated morphology features (10 bases × mean/se/worst)."""
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(n, 3))
    base = _redundant_block(rng, n, lat, 10, noise=0.2)
    x = np.concatenate(
        [base, base * rng.uniform(0.1, 0.2, 10) + 0.05 * rng.normal(size=(n, 10)),
         base * rng.uniform(1.2, 1.6, 10) + 0.1 * rng.normal(size=(n, 10))],
        axis=1,
    ).astype(np.float32)
    score = 1.5 * lat[:, 0] + lat[:, 1] + 0.5 * rng.normal(size=n)
    y = (score > np.quantile(score, 0.63)).astype(np.float32)  # ~37% positive
    return Dataset("breast_cancer", x, y, "binary")


REGISTRY = {
    "covtype_binary": lambda seed=0, n=40_000: make_covtype(n, seed, multiclass=False),
    "covtype_multi": lambda seed=0, n=40_000: make_covtype(n, seed, multiclass=True),
    "california_housing": lambda seed=0, n=20_640: make_california(n, seed),
    "kin8nm": lambda seed=0, n=8_192: make_kin8nm(n, seed),
    "mushroom": lambda seed=0, n=8_124: make_mushroom(n, seed),
    "wine_quality": lambda seed=0, n=6_497: make_wine(n, seed),
    "kr_vs_kp": lambda seed=0, n=3_196: make_krkp(n, seed),
    "breast_cancer": lambda seed=0, n=569: make_breast_cancer(n, seed),
}


def load(name: str, seed: int = 0, n: int | None = None) -> Dataset:
    fn = REGISTRY[name]
    return fn(seed=seed) if n is None else fn(seed=seed, n=n)
