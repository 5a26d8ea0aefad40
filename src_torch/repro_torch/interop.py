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
:func:`lm_params_from_numpy` and a training state with
:func:`train_state_from_numpy`.  The way back is :func:`lm_tree` (and
:func:`lm_tree_to_numpy`): the port's parameters, gradients or moments
in the reference's layout, which is also what a training checkpoint
holds (:func:`train_state_tree`, :func:`load_train_state`).  This
module imports neither JAX nor the reference: the caller does the
``np.asarray``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

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
    """A numpy array (or a tensor) as a CPU tensor, bf16 kept bit for
    bit: ``ml_dtypes.bfloat16`` and the 2-byte words (``|V2``) an npz
    file gives back for it alike."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _fill(param: torch.Tensor, a, name: str) -> None:
    t = _tensor(a)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{name}: reference shape {tuple(t.shape)}, port "
                         f"shape {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(t)


def _layer_slots(cfg: ModelConfig) -> List[Tuple[int, Optional[str], int]]:
    """Where each port layer sits in the reference's tree, in layer order:
    (segment index, ``attn_pattern`` entry or None, index on the
    segment's stacked layer axis).  Super-block ``j``'s entry ``name``
    is layer ``len(pattern) * j + index(name)`` of its segment."""
    slots = []
    for si, seg in enumerate(build_plan(cfg)):
        if seg.kind in ("attn", "mamba"):
            slots += [(si, None, j) for j in range(seg.count)]
        else:                                # attn_pattern (LM checked)
            names = _pattern_names(cfg)
            slots += [(si, name, j) for j in range(seg.count)
                      for name in names]
    return slots


def _ref_path(name: str, slots) -> Tuple[tuple, Optional[int]]:
    """A port parameter name's path in the reference's tree and its index
    on a stacked layer axis (None for the embedding, head and final
    norm)."""
    parts = name.split(".")
    if parts[0] == "embed":
        return ("embed", "table"), None
    if parts[0] == "head":
        return ("head", "w"), None
    if parts[0] == "final_norm":
        return ("final_norm", parts[1]), None
    si, entry, j = slots[int(parts[1])]
    return (("segments", si) + ((entry,) if entry else ())
            + tuple(parts[2:])), j


def _walk(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def lm_tree(tensors: Mapping[str, torch.Tensor],
            cfg: ModelConfig) -> Dict[str, object]:
    """Tensors keyed by the port's parameter names (``model.named_
    parameters()``, or gradients or moments under those names) as a tree
    in the reference's layout, on the CPU: ``embed.table``,
    ``final_norm``, ``head`` (``{}`` when tied), and ``segments``, a list
    of per-segment trees whose layer leaves are stacked on a leading
    layer axis."""
    slots = _layer_slots(cfg)
    tree: Dict[str, object] = {"head": {}}
    stacks: Dict[tuple, Dict[int, torch.Tensor]] = {}
    for name, t in tensors.items():
        path, j = _ref_path(name, slots)
        t = t.detach().cpu()
        if j is None:
            tree.setdefault(path[0], {})[path[1]] = t
        else:
            stacks.setdefault(path, {})[j] = t
    segments: Dict[int, dict] = {}
    for path, parts in stacks.items():
        node = segments.setdefault(path[1], {})
        for key in path[2:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.stack([parts[j] for j in range(len(parts))])
    tree["segments"] = [segments[i] for i in range(len(segments))]
    return tree


def lm_tree_to_numpy(tensors: Mapping[str, torch.Tensor],
                     cfg: ModelConfig) -> Dict[str, object]:
    """:func:`lm_tree` as numpy arrays, to hold leaf by leaf against the
    reference's ``jax.tree.map(np.asarray, params)`` (or its gradients);
    bfloat16 leaves come back as float32, exactly."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        if node.dtype == torch.bfloat16:
            node = node.to(torch.float32)
        return node.numpy()
    return conv(lm_tree(tensors, cfg))


def load_lm_tree(tensors: Mapping[str, torch.Tensor], tree: Dict[str, object],
                 cfg: ModelConfig) -> None:
    """Copy a tree in the reference's layout (numpy arrays, bf16 as
    ``ml_dtypes.bfloat16`` or as 2-byte words, or CPU tensors) into
    tensors keyed by the port's parameter names, in place, bit for bit;
    a shape that differs raises naming the leaf."""
    slots = _layer_slots(cfg)
    for name, t in tensors.items():
        path, j = _ref_path(name, slots)
        a = _walk(tree, path)
        _fill(t, a if j is None else a[j], name)


def lm_params_from_numpy(tree: Dict[str, object], cfg: ModelConfig,
                         device: DeviceLike = None) -> LM:
    """The port's :class:`~repro_torch.models.model.LM` on ``device``
    (default: the card) holding the reference's parameters
    (``jax.tree.map(np.asarray, params)``), laid out as :func:`lm_tree`
    describes.  Weights keep the reference's ``(d_in, d_out)`` layout and
    dtype, bit for bit."""
    model = LM(cfg, resolve_device(device))
    load_lm_tree(dict(model.named_parameters()), tree, cfg)
    return model


def train_state_tree(state: Dict[str, object]) -> Dict[str, object]:
    """A port train state ``{"model", "opt"}`` as the reference's
    ``{"params", "opt": {"mu", "nu", "count"}}`` in its layout, on the
    CPU: what a checkpoint of either package holds."""
    model, opt = state["model"], state["opt"]
    cfg = model.cfg
    return {"params": lm_tree(dict(model.named_parameters()), cfg),
            "opt": {"mu": lm_tree(opt["mu"], cfg),
                    "nu": lm_tree(opt["nu"], cfg),
                    "count": opt["count"].detach().cpu()}}


def load_train_state(state: Dict[str, object], tree: Dict[str, object]
                     ) -> Dict[str, object]:
    """Copy a tree laid out as :func:`train_state_tree` (the reference's
    state as numpy arrays, or a checkpoint) into a port train state, in
    place, bit for bit; returns the state."""
    model, opt = state["model"], state["opt"]
    cfg = model.cfg
    load_lm_tree(dict(model.named_parameters()), tree["params"], cfg)
    load_lm_tree(opt["mu"], tree["opt"]["mu"], cfg)
    load_lm_tree(opt["nu"], tree["opt"]["nu"], cfg)
    with torch.no_grad():
        opt["count"].copy_(_tensor(tree["opt"]["count"]))
    return state


def train_state_from_numpy(tree: Dict[str, object], cfg: ModelConfig,
                           device: DeviceLike = None) -> Dict[str, object]:
    """The reference's train state (``jax.tree.map(np.asarray, state)``:
    ``{"params", "opt": {"mu", "nu", "count"}}``) as a port train state
    ``{"model", "opt"}`` on ``device`` (default: the card), parameters
    trainable, the moments in the tree's dtype."""
    dev = resolve_device(device)
    model = LM(cfg, dev).requires_grad_(True)
    names = dict(model.named_parameters())
    slots = _layer_slots(cfg)

    def like(moments):
        out = {}
        for name, p in names.items():
            path, j = _ref_path(name, slots)
            a = _walk(moments, path)
            dt = _tensor(a if j is None else a[j]).dtype
            out[name] = torch.empty(p.shape, dtype=dt, device=dev)
        return out

    opt = {"mu": like(tree["opt"]["mu"]), "nu": like(tree["opt"]["nu"]),
           "count": torch.zeros((), dtype=torch.int32, device=dev)}
    return load_train_state({"model": model, "opt": opt}, tree)
