"""Carry the JAX package's state across to the port as numpy arrays.

Models that were saved cross over through the shared store format
(``FactoredModel.load`` reads the reference's stores).  A model held in
memory by the reference crosses as numpy factors: hand
``np.asarray(model.U)``, ``np.asarray(model.s)`` and ``np.asarray(model.V)``
to :func:`factored_from_numpy`.  The bytes are kept as they are, so the
port's model has the reference model's ``version``.  A problem crosses
with :func:`problem_from_numpy` (its Gram cache too, when the reference
built one), and a spectral engine's warm carry with
:func:`sv_carry_from_numpy`, a language model's parameter tree with
:func:`lm_params_from_numpy`.  This module imports neither JAX nor the
reference: the caller does the ``np.asarray``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .core.methods.base import MTLProblem
from .configs.base import ModelConfig
from .core.losses import get_loss
from .models.blocks import _pattern_names, build_plan
from .models.model import LM
from .serve.mtl import FactoredModel


def _move(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(dev)   # own copy


def factored_from_numpy(U: np.ndarray, s: np.ndarray, V: np.ndarray,
                        loss: str = "squared",
                        task_keys: Optional[Sequence[str]] = None,
                        device: DeviceLike = None) -> FactoredModel:
    """A port :class:`FactoredModel` on ``device`` (default: the card)
    from numpy factors ``U (p, r)``, ``s (r,)``, ``V (m, r)``, dtype
    kept, with the same content-hash ``version`` as the model they came
    from."""
    dev = resolve_device(device)
    return FactoredModel(U=_move(U, dev), s=_move(s, dev), V=_move(V, dev),
                         loss=loss,
                         task_keys=None if task_keys is None
                         else tuple(task_keys))


def problem_from_numpy(Xs: np.ndarray, ys: np.ndarray, loss: str = "squared",
                       gram: bool = True, A: float = 1.0, r: int = 5,
                       l2: float = 0.0, device: DeviceLike = None,
                       gram_A: Optional[np.ndarray] = None,
                       gram_b: Optional[np.ndarray] = None) -> MTLProblem:
    """A port :class:`MTLProblem` on ``device`` (default: the card) from
    numpy designs ``Xs (m, n, p)`` and labels ``ys (m, n)``.

    When the reference's Gram cache is passed (``gram_A (m, p, p)``,
    ``gram_b (m, p)``) it is kept byte for byte, so both packages start
    from the same cache; otherwise ``gram=True`` builds one on the device
    for the squared loss, as :meth:`MTLProblem.make` does.
    """
    if (gram_A is None) != (gram_b is None):
        raise ValueError("pass both gram_A and gram_b, or neither")
    dev = resolve_device(device)
    if gram_A is None:
        return MTLProblem.make(_move(Xs, dev), _move(ys, dev), loss,
                               gram=gram, device=dev, A=A, r=r, l2=l2)
    if not gram or loss != "squared":
        raise ValueError("a Gram cache belongs to a squared-loss problem "
                         "built with gram=True")
    return MTLProblem(Xs=_move(Xs, dev), ys=_move(ys, dev),
                      loss=get_loss(loss), A=A, r=r, l2=l2,
                      gram_A=_move(gram_A, dev), gram_b=_move(gram_b, dev))


def sv_carry_from_numpy(carry: Dict[str, np.ndarray],
                        device: DeviceLike = None) -> Dict[str, object]:
    """A ``ShrinkEngine`` warm carry on ``device`` (default: the card)
    from the reference's carry as numpy arrays: ``V``, ``s`` and ``T``
    become tensors, the ``warm`` flag and the ``exact_rounds`` counter
    host ints (the port's carry keeps those two on the host)."""
    dev = resolve_device(device)
    if not carry:
        return {}
    return {"V": _move(carry["V"], dev), "s": _move(carry["s"], dev),
            "T": _move(carry["T"], dev), "warm": int(carry["warm"]),
            "exact_rounds": int(carry["exact_rounds"])}


def _tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor, bf16 (``ml_dtypes.bfloat16``, which
    numpy holds as 2-byte words) kept bit for bit."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _fill(param: torch.Tensor, a, name: str) -> None:
    t = _tensor(a)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{name}: reference shape {tuple(t.shape)}, port "
                         f"shape {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(t)


def _fill_layer(layer, tree, j: int, name: str) -> None:
    """Layer ``j`` of a stacked reference layer tree into ``layer``."""
    mamba = "mamba" in tree
    for norm in ("norm1",) if mamba else ("norm1", "norm2"):
        for leaf, a in tree[norm].items():
            _fill(getattr(getattr(layer, norm), leaf), a[j],
                  f"{name}.{norm}.{leaf}")
    if mamba:
        for leaf, a in tree["mamba"].items():
            _fill(getattr(layer.mamba, leaf), a[j], f"{name}.mamba.{leaf}")
        return
    for w in ("wq", "wk", "wv", "wo"):
        _fill(getattr(layer.attn, w), tree["attn"][w][j], f"{name}.attn.{w}")
    for w, a in tree["mlp"].items():
        _fill(getattr(layer.mlp, w), a[j], f"{name}.mlp.{w}")


def lm_params_from_numpy(tree: Dict[str, object], cfg: ModelConfig,
                         device: DeviceLike = None) -> LM:
    """The port's :class:`~repro_torch.models.model.LM` on ``device``
    (default: the card) holding the reference's parameters
    (``jax.tree.map(np.asarray, params)``): ``embed.table``,
    ``final_norm``, ``head.w`` when untied, and per segment the layer
    trees stacked on a leading layer axis (a ``"mamba"`` segment's
    ``norm1`` and ``mamba`` leaves, index ``j``, go into layer ``j``).
    Weights keep the reference's ``(d_in, d_out)`` layout and dtype, bit
    for bit; super-block ``j``'s entry
    ``name`` of an ``attn_pattern`` segment becomes layer
    ``len(pattern) * j + index(name)``."""
    model = LM(cfg, resolve_device(device))
    _fill(model.embed, tree["embed"]["table"], "embed.table")
    for leaf, a in tree["final_norm"].items():
        _fill(getattr(model.final_norm, leaf), a, f"final_norm.{leaf}")
    if model.head is not None:
        _fill(model.head, tree["head"]["w"], "head.w")
    first = 0
    for seg, seg_tree in zip(build_plan(cfg), tree["segments"]):
        if seg.kind in ("attn", "mamba"):
            for j in range(seg.count):
                _fill_layer(model.layers[first + j], seg_tree, j,
                            f"layer {first + j}")
            first += seg.count
            continue
        names = _pattern_names(cfg)          # attn_pattern (LM checked)
        for j in range(seg.count):
            for i, name in enumerate(names):
                idx = first + len(names) * j + i
                _fill_layer(model.layers[idx], seg_tree[name], j,
                            f"layer {idx} ({name})")
        first += seg.count * len(names)
    return model
