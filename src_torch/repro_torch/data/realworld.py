"""Synthetic surrogates for the paper's six real-world datasets (App. H).

Port of ``repro.data.realworld``, drawing through
:mod:`repro_torch.core.prng`, so a key gives the reference's surrogate.
The originals (School, Computer Survey, ATP, Protein, Landmine, Cal500)
are not redistributable offline, so each surrogate matches the published
dimensions (m tasks, p features, n per task), the label type and the
qualitative task-relatedness (predictors drawn near a shared low-rank
subspace with a task-specific deviation, correlated features), which
keeps the *relative* behaviour of the methods, the quantity Fig 4 plots,
meaningful.  Absolute numbers are NOT comparable to the paper's and are
labelled "(surrogate)" wherever reported.

The uniform draws, and so the classification labels' coin flips, are
the reference's bit for bit; the normal draws agree to ~2.5e-7 relative
(:func:`prng.normal`), and X and the regression labels to float32
rounding of that.  A classification label can flip where its coin lands
within that rounding of ``sigmoid(margin)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..core import prng
from .synthetic import feature_cov


@dataclasses.dataclass(frozen=True)
class RealSpec:
    name: str
    m: int            # tasks
    p: int            # features
    n: int            # training samples per task (post 20% split, approx)
    task: str         # regression | classification
    r: int            # latent shared rank used by the surrogate
    deviation: float  # per-task deviation off the shared subspace
    corr_decay: float
    noise: float


# Dimensions follow App. H descriptions.
REAL_SPECS: Dict[str, RealSpec] = {
    "school": RealSpec("school", m=72, p=27, n=40, task="regression",
                       r=3, deviation=0.3, corr_decay=0.5, noise=1.0),
    "computer": RealSpec("computer", m=180, p=14, n=8, task="regression",
                         r=3, deviation=0.2, corr_decay=0.8, noise=0.8),
    "atp": RealSpec("atp", m=6, p=411, n=67, task="regression",
                    r=2, deviation=0.15, corr_decay=0.05, noise=0.5),
    "protein": RealSpec("protein", m=3, p=357, n=1600, task="classification",
                        r=2, deviation=0.2, corr_decay=0.2, noise=0.0),
    "landmine": RealSpec("landmine", m=19, p=9, n=100, task="classification",
                         r=2, deviation=0.25, corr_decay=0.6, noise=0.0),
    "cal500": RealSpec("cal500", m=78, p=68, n=100, task="classification",
                       r=4, deviation=0.3, corr_decay=0.3, noise=0.0),
}


def surrogate_keys(key: torch.Tensor) -> torch.Tensor:
    """The seven keys a surrogate draws from, ``(ku, kv, kd, kx, ky,
    kxt, kyt)``: basis, codes, deviation, then the train and test
    features and labels."""
    return prng.split(key, 7)


def surrogate_predictor(key: torch.Tensor, spec: RealSpec) -> torch.Tensor:
    """The surrogate's true predictor ``W = U V + deviation N / sqrt(p)``
    (p, m), on the key's device."""
    ku, kv, kd = surrogate_keys(key)[:3]
    U = torch.linalg.qr(prng.normal(ku, (spec.p, spec.r)))[0]
    V = prng.normal(kv, (spec.r, spec.m)) / math.sqrt(spec.r)
    return U @ V + spec.deviation * prng.normal(kd, (spec.p, spec.m)) \
        / math.sqrt(spec.p)


def generate_surrogate(key: torch.Tensor, spec: RealSpec,
                       device: DeviceLike = None
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor]:
    """Returns (Xs, ys, Xs_test, ys_test) float32 on ``device`` (default:
    the card); the test split is 3x the train size (paper: 60%)."""
    dev = resolve_device(device)
    key = key.to(dev)
    _, _, _, kx, ky, kxt, kyt = surrogate_keys(key)
    W = surrogate_predictor(key, spec)
    Sigma = feature_cov(spec.p, spec.corr_decay, device=dev)
    eye = torch.eye(spec.p, dtype=Sigma.dtype, device=dev)
    chol = torch.linalg.cholesky(Sigma + 1e-9 * eye)

    def draw(kx_, ky_, n):
        X = prng.normal(kx_, (spec.m, n, spec.p)) @ chol.T
        marg = torch.einsum("mnp,pm->mn", X, W)
        if spec.task == "regression":
            y = marg + spec.noise * prng.normal(ky_, tuple(marg.shape))
        else:
            pr = torch.sigmoid(marg)
            y = torch.where(prng.uniform(ky_, tuple(marg.shape)) < pr,
                            1.0, -1.0)
        return X, y

    Xs, ys = draw(kx, ky, spec.n)
    Xt, yt = draw(kxt, kyt, 3 * spec.n)
    return Xs, ys, Xt, yt


def split_tasks(m: int, holdout: int, seed: int = 0,
                device: DeviceLike = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic TASK-level split: (train_ids, holdout_ids), int32
    on ``device`` (default: the card).

    Holds out whole tasks — the transfer / few-shot-onboarding
    evaluation (``repro_torch.serve.mtl``): a solver learns the shared
    subspace on the train tasks only, and the held-out tasks are fit
    afterwards from a handful of their samples inside that subspace.
    A fixed ``seed`` gives the reference's split (sorted ids, disjoint,
    covering ``range(m)``)."""
    if not 0 < holdout < m:
        raise ValueError(f"holdout={holdout} must be in (0, m={m})")
    perm = prng.permutation(prng.PRNGKey(seed, device=device), m)
    return (torch.sort(perm[holdout:]).values,
            torch.sort(perm[:holdout]).values)


def take_tasks(ids: torch.Tensor, *arrays: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
    """Restrict task-stacked arrays (m leading axis) to the given task
    ids — the companion of :func:`split_tasks` for carving a surrogate
    into train-task and held-out-task problems."""
    return tuple(a.index_select(0, ids.to(a.device).long()) for a in arrays)


def test_metric(task: str, W: torch.Tensor, Xt: torch.Tensor,
                yt: torch.Tensor) -> torch.Tensor:
    """RMSE for regression, 1 - the tasks' mean AUC for classification
    (as in Fig 4), a 0-dim float32 tensor."""
    preds = torch.einsum("mnp,pm->mn", Xt, W)
    if task == "regression":
        return torch.sqrt(torch.mean((preds - yt) ** 2))
    return 1.0 - torch.mean(_auc(preds, yt))   # report 1-AUC (error)


def _auc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Rank-based AUC of each row, ``P(score_pos > score_neg)``: ranks
    from a stable argsort (``jnp.argsort``'s), ties in index order."""
    pos = labels > 0
    n = scores.shape[-1]
    order = torch.argsort(scores, dim=-1, stable=True)
    ranks = torch.empty_like(scores).scatter_(
        -1, order, torch.arange(1, n + 1, dtype=scores.dtype,
                                device=scores.device).expand_as(scores))
    n_pos = pos.sum(-1).to(torch.int32)
    n_neg = n - n_pos
    sum_pos = torch.where(pos, ranks, torch.zeros_like(ranks)).sum(-1)
    half = (n_pos * (n_pos + 1)).to(scores.dtype) / 2.0
    auc = (sum_pos - half) / torch.clamp(n_pos * n_neg, min=1).to(
        scores.dtype)
    # degenerate single-class fold -> 0.5
    return torch.where((n_pos == 0) | (n_neg == 0),
                       torch.full_like(auc, 0.5), auc)
