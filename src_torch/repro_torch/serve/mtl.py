"""Factored MTL serving on the card: the online half of the system.

Port of ``repro.serve.mtl``.  A fitted multi-task model is
``W = U diag(s) Vᵀ``: a shared rank-r basis ``U (p, r)`` plus per-task
codes (rows of ``V (m, r)`` scaled by the spectrum), so a mixed-task
request batch is scored in O(p r) per request and an unseen task is
learnt from a handful of samples by an r-dimensional fit inside the
frozen subspace.

* :class:`FactoredModel` — the serving artifact, built by
  :func:`repro_torch.core.spectral.truncate_factors`, saved and loaded
  through the store format of :mod:`repro_torch.train.checkpoint`.  The
  store and the content-hash ``version`` are the reference's, so each
  package loads the other's stores with the same version id.
* :class:`MTLServer` — fixed batch slots: requests are scored in waves
  of ``batch_size`` (the last wave padded), each wave by ONE launch of
  the hand-written CUDA kernel (:mod:`repro_torch.kernels.mtl_score`)
  when the model lies on the card, by its plain version on the CPU.
  Every ``code_dtype`` (f32 with scale 1.0, int8, fp8) goes through the
  same kernel.  Versions hot-swap atomically.  ``mesh=`` shards the code
  table over a ``torch.distributed`` mesh axis.
* few-shot onboarding through
  :func:`repro_torch.core.linear_model.projected_erm`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.linear_model import projected_erm
from ..core.losses import get_loss
from ..core.spectral import truncate_factors
from ..kernels.mtl_score import CODE_DTYPES, mtl_score, quantize_codes
from ..obs.metrics import default_registry
from ..obs.tracing import emit_event, trace_span
from ..train import checkpoint

_MANIFEST_VERSION = 1


# ---------------------------------------------------------------------------
# the factored artifact
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FactoredModel:
    """The serving artifact: ``W ≈ U diag(s) Vᵀ``, tensors on one device.

    ``U (p, r)`` is the shared orthonormal basis, ``s (r,)`` the
    spectrum, ``V (m, r)`` the per-task right factors.  The per-task
    CODE is ``c_j = s ⊙ V[j]`` so that ``w_j = U c_j``.

    ``version`` is the reference's content hash: sha256 over the raw
    bytes of U, s and V, the loss name and ``repr(task_keys)``, first 12
    hex digits.  Identical factors give identical ids in both packages.
    """

    U: torch.Tensor                    # (p, r) shared basis
    s: torch.Tensor                    # (r,)   spectrum
    V: torch.Tensor                    # (m, r) per-task right factors
    loss: str = "squared"
    task_keys: Optional[Tuple[str, ...]] = None
    version: str = ""

    def __post_init__(self):
        if self.U.ndim != 2 or self.V.ndim != 2 or self.s.ndim != 1:
            raise ValueError("FactoredModel wants U (p,r), s (r,), V (m,r)")
        r = self.U.shape[1]
        if self.s.shape[0] != r or self.V.shape[1] != r:
            raise ValueError(
                f"rank mismatch: U {tuple(self.U.shape)}, s "
                f"{tuple(self.s.shape)}, V {tuple(self.V.shape)}")
        if len({self.U.device, self.s.device, self.V.device}) != 1:
            raise ValueError("U, s and V must lie on one device")
        if self.task_keys is not None and len(self.task_keys) != self.m:
            raise ValueError(f"{len(self.task_keys)} task_keys for "
                             f"{self.m} tasks")
        get_loss(self.loss)            # fail early on unknown loss names
        if not self.version:
            object.__setattr__(self, "version", self._content_hash())

    # -- shapes --------------------------------------------------------
    @property
    def p(self) -> int:
        return self.U.shape[0]

    @property
    def m(self) -> int:
        return self.V.shape[0]

    @property
    def rank(self) -> int:
        return self.U.shape[1]

    @property
    def device(self) -> torch.device:
        return self.U.device

    @property
    def codes(self) -> torch.Tensor:
        """The (m, r) code table ``C`` with ``w_j = U C[j]``."""
        return self.V * self.s[None, :]

    def _content_hash(self) -> str:
        h = hashlib.sha256()
        for arr in (self.U, self.s, self.V):
            h.update(arr.detach().cpu().numpy().tobytes())
        h.update(self.loss.encode())
        # task_keys route requests to code rows, so a permuted or edited
        # key list must fail the load-time check like a tampered factor
        h.update(repr(self.task_keys).encode())
        return h.hexdigest()[:12]

    def manifest(self) -> Dict:
        """The artifact's self-description, stored alongside the factors."""
        return {"format": _MANIFEST_VERSION, "rank": self.rank,
                "m": self.m, "p": self.p, "loss": self.loss,
                "version": self.version,
                "task_keys": (None if self.task_keys is None
                              else list(self.task_keys))}

    # -- construction --------------------------------------------------
    @classmethod
    def from_W(cls, W, rank: int, loss: str = "squared",
               task_keys: Optional[Sequence[str]] = None,
               device: DeviceLike = None) -> "FactoredModel":
        """Factor a dense (p, m) predictor matrix at the given rank on
        ``device`` (default: the card), through
        :func:`repro_torch.core.spectral.truncate_factors`."""
        dev = resolve_device(device)
        M = torch.as_tensor(W, dtype=torch.float32, device=dev)
        U, s, V = truncate_factors(M, int(rank))
        return cls(U=U.contiguous(), s=s.contiguous(), V=V.contiguous(),
                   loss=loss,
                   task_keys=None if task_keys is None else tuple(task_keys))

    # -- dense view ----------------------------------------------------
    def dense(self) -> torch.Tensor:
        """Materialize the (p, m) predictor matrix (diagnostics only —
        serving never needs it)."""
        return self.U @ self.codes.T

    # -- onboarding (the transfer setting) -----------------------------
    def onboard(self, task_key: Optional[str], X, y, l2: float = 1e-3,
                iters: int = 25) -> "FactoredModel":
        """Fit an UNSEEN task inside the frozen subspace and append it.

        Solves ``min_c L(X U c, y) + (l2/2)‖c‖²`` on the projected design
        (:func:`onboard_code`).  U and the existing m code rows are
        untouched; the new model has m + 1 tasks.  The stored right
        factor is ``c / s``; directions with s ≈ 0 are dropped.
        """
        c = onboard_code(self.U, X, y, loss=self.loss, l2=l2, iters=iters)
        safe = torch.abs(self.s) > 1e-12
        v_new = torch.where(safe, c / torch.where(safe, self.s,
                                                  torch.ones_like(self.s)),
                            torch.zeros_like(c))
        keys = None
        if self.task_keys is not None:
            if task_key is None:
                raise ValueError("model carries task_keys; onboard needs one")
            if task_key in self.task_keys:
                raise ValueError(f"task key {task_key!r} already onboarded")
            keys = self.task_keys + (task_key,)
        elif task_key is not None:
            # silently dropping the key would make the new task
            # unroutable by the name the caller just supplied
            raise ValueError("model has no task_keys; onboard with "
                             "task_key=None and route by id")
        return FactoredModel(U=self.U, s=self.s,
                             V=torch.cat([self.V, v_new[None, :]]),
                             loss=self.loss, task_keys=keys)

    # -- persistence ---------------------------------------------------
    def save(self, store_dir: str, step: Optional[int] = None,
             keep: Optional[int] = None) -> int:
        """Atomically write this model as version ``step`` of a store
        (default: latest + 1).  Returns the step written."""
        steps = checkpoint.available_steps(store_dir)
        if step is None:
            step = (steps[-1] + 1) if steps else 0
        man = np.frombuffer(json.dumps(self.manifest()).encode(), np.uint8)
        state = {"U": self.U, "s": self.s, "V": self.V,
                 "manifest": man.copy()}
        checkpoint.save_checkpoint(store_dir, step, state, keep=keep)
        return step

    @classmethod
    def load(cls, store_dir: str, step: Optional[int] = None,
             device: DeviceLike = None) -> Tuple[int, "FactoredModel"]:
        """Load version ``step`` (default: latest intact) from a store
        onto ``device`` (default: the card).  Validates the factors
        against the manifest: a truncated or mixed-up artifact fails
        loudly instead of serving garbage."""
        dev = resolve_device(device)
        step, state = checkpoint.load_checkpoint(store_dir, step)
        man = json.loads(bytes(state["manifest"].numpy()).decode())
        if man["format"] != _MANIFEST_VERSION:
            raise ValueError(f"unknown artifact format {man['format']}")
        model = cls(U=state["U"].to(dev), s=state["s"].to(dev),
                    V=state["V"].to(dev), loss=man["loss"],
                    task_keys=None if man["task_keys"] is None
                    else tuple(man["task_keys"]))
        got = (model.p, model.m, model.rank)
        want = (man["p"], man["m"], man["rank"])
        if got != want:
            raise ValueError(f"artifact shape {got} contradicts its "
                             f"manifest {want}")
        if model.version != man["version"]:
            raise ValueError(
                f"artifact content hash {model.version} does not match "
                f"manifest version {man['version']} — corrupt store?")
        return step, model


def onboard_code(U: torch.Tensor, X, y, loss: str = "squared",
                 l2: float = 1e-3, iters: int = 25) -> torch.Tensor:
    """The r-vector code of a new task in the frozen subspace ``U``:
    ``min_c L(X U c, y) + (l2/2)‖c‖²`` — closed form for squared loss,
    damped Newton for logistic — through
    :func:`repro_torch.core.linear_model.projected_erm`.  X and y are
    moved to U's device and dtype."""
    X = torch.as_tensor(X, dtype=U.dtype, device=U.device)
    y = torch.as_tensor(y, dtype=U.dtype, device=U.device)
    return projected_erm(get_loss(loss), U, X, y, l2, iters)[1]


# ---------------------------------------------------------------------------
# the batched scoring server
# ---------------------------------------------------------------------------
def _score_batch(U: torch.Tensor, C: torch.Tensor, ids: torch.Tensor,
                 X: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain f32 scoring of one wave — the reference's unfused hot path,
    kept as the oracle the served path is tested against (the server
    itself scores every table through :func:`_score_batch_quant`).
    Returns the scores and the id-validity flag ``all(0 <= ids < m)``
    as a device scalar; ids are clamped for the gather, so a bad id
    never reads out of bounds."""
    ok = torch.all((ids >= 0) & (ids < m))
    idx = torch.clamp(ids.long(), 0, C.shape[0] - 1)
    return torch.sum((X @ U) * C.index_select(0, idx), dim=1), ok


def _score_batch_quant(U: torch.Tensor, C: torch.Tensor, S: torch.Tensor,
                       ids: torch.Tensor, X: torch.Tensor, m: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One wave through the fused scorer with any code table (f32 with
    S = 1.0, int8, fp8): the CUDA kernel on the card, its plain version
    on the CPU.  Same validity flag as :func:`_score_batch`."""
    ok = torch.all((ids >= 0) & (ids < m))
    return mtl_score(U, C, S, ids, X), ok


@dataclasses.dataclass(frozen=True)
class _ServeState:
    """One immutable served version — swapped as a unit, never mutated,
    so a score wave that grabbed it can never observe a half-update."""
    model: FactoredModel
    U: torch.Tensor                    # (p, r) f32 basis, contiguous
    C: torch.Tensor                    # (m, r) code table (f32/int8/fp8)
    S: torch.Tensor                    # (m, 1) f32 per-code scales
    version: str = ""
    step: Optional[int] = None         # store step, when loaded/saved
    key_index: Optional[Dict[str, int]] = None   # task_key -> id
    gen: int = 0                       # install generation: the token
                                       # maybe_reload checks so a slow
                                       # store load never overwrites a
                                       # concurrently installed model
    row0: int = 0                      # under a mesh: the first global
                                       # task id of this rank's C rows


class MTLServer:
    """Batched factored scoring with hot-swap and few-shot onboarding.

    Requests are processed in waves of ``batch_size`` (the last wave is
    padded with id 0 and zero rows); each wave is one call of
    :func:`repro_torch.kernels.mtl_score.mtl_score` — one kernel launch
    on the card.  The server serves on the device its model lies on.

    Hot-swap semantics: ``swap``/``onboard``/``maybe_reload`` replace the
    served state ATOMICALLY (one reference rebind of an immutable
    snapshot under a lock); every ``score`` call reads that reference
    once, so a call is served entirely by one model version and reports
    the version id it used.

    ``code_dtype="int8"|"fp8"`` stores the code table quantized with
    per-code scales; f32 serves with scales of exactly 1.0.  Onboarding
    requantizes on install.

    ``mesh=`` (a ``DeviceMesh`` with a "tasks" axis, e.g.
    ``runtime.task_mesh``) shards the code table over that axis: the
    table is padded to a multiple of the axis with zero rows (an int8
    or fp8 table's scales with 1.0), and each rank holds its block of
    rows.  Every rank calls ``score`` with the whole batch; each scores
    it with its own block through the same kernel, zeroes the scores of
    ids outside the block, and one all-reduce of the ``(B,)`` scores per
    wave gives every rank the full result.  The validity flag is still
    taken against the global ``m``.

    SLO telemetry: every scoring call reports into ``registry`` —
    ``serve_latency_seconds`` (measured on the host around the launches
    and the one validity sync), ``serve_requests_total``,
    ``serve_waves_total``, ``serve_swaps_total`` and
    ``serve_invalid_batches_total``.  ``swap_log`` is a ring of at most
    ``swap_log_limit`` installs; evicted entries leave as
    ``serve.swap_evicted`` events.
    """

    def __init__(self, model: FactoredModel, *, batch_size: int = 64,
                 mesh=None, code_dtype: str = "f32", registry=None,
                 swap_log_limit: int = 256):
        self.mesh = mesh
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(
                    f"mesh= takes a torch.distributed DeviceMesh with a "
                    f"'tasks' axis (repro_torch.runtime.task_mesh), got "
                    f"{type(mesh).__name__}")
            if mesh.device_type != model.device.type:
                raise ValueError(f"the mesh lies on {mesh.device_type!r} "
                                 f"devices and the model on {model.device}")
            from ..runtime.mesh import mesh_axis
            self._shards, self._shard, self._group = mesh_axis(mesh, "tasks")
        if code_dtype not in CODE_DTYPES:
            raise ValueError(f"code_dtype must be one of {CODE_DTYPES}, "
                             f"got {code_dtype!r}")
        if swap_log_limit < 1:
            raise ValueError(f"swap_log_limit must be >= 1, got "
                             f"{swap_log_limit}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.code_dtype = code_dtype
        self.B = int(batch_size)
        self._lock = threading.Lock()
        self.registry = default_registry() if registry is None else registry
        self._lat = self.registry.histogram("serve_latency_seconds")
        self._req = self.registry.counter("serve_requests_total")
        self._wav = self.registry.counter("serve_waves_total")
        self._swp = self.registry.counter("serve_swaps_total")
        self._bad = self.registry.counter("serve_invalid_batches_total")
        # (monotonic install time, version id) per install; bounded
        self.swap_log: list = []
        self.swap_log_limit = int(swap_log_limit)
        self._state: _ServeState = self._prepare(model)
        self._log_swap(self._state.version)

    # -- state building / swapping -------------------------------------
    def _prepare(self, model: FactoredModel,
                 step: Optional[int] = None) -> _ServeState:
        # quantize (f32: scale by an exact 1.0) from the model's float
        # codes — onboarding reinstalls through here, so an appended row
        # is requantized with the same per-code scheme as the table
        C, S = quantize_codes(model.codes, self.code_dtype)
        row0 = 0
        if self.mesh is not None:
            pad = (-C.shape[0]) % self._shards
            if pad:                    # zero rows no valid id reaches
                C = torch.cat([C, C.new_zeros((pad, C.shape[1]))])
                S = torch.cat([S, S.new_ones((pad, 1))])  # pad rows exact
            rows = C.shape[0] // self._shards
            row0 = self._shard * rows
            C = C[row0:row0 + rows].contiguous()
            S = S[row0:row0 + rows].contiguous()
        keys = model.task_keys
        return _ServeState(model=model,
                           U=model.U.to(torch.float32).contiguous(),
                           C=C, S=S, version=model.version, step=step,
                           key_index=None if keys is None else
                           {k: i for i, k in enumerate(keys)}, row0=row0)

    def _log_swap(self, version: str) -> None:
        """Append an install record, evicting the oldest past the ring
        limit (each eviction leaves as an obs event)."""
        self.swap_log.append((time.monotonic(), version))
        self._swp.inc()
        while len(self.swap_log) > self.swap_log_limit:
            t_inst, v_old = self.swap_log.pop(0)
            emit_event("serve.swap_evicted", version=v_old,
                       t_install_monotonic_s=t_inst)

    def _install(self, state: _ServeState) -> None:
        """Rebind the served state (CALL UNDER self._lock): every
        install bumps the generation token."""
        self._state = dataclasses.replace(state, gen=self._state.gen + 1)
        self._log_swap(self._state.version)

    def swap(self, model: FactoredModel, step: Optional[int] = None) -> str:
        """Install a new model version; in-flight waves finish on the
        old one.  Returns the new version id."""
        with trace_span("serve.swap", version=model.version, step=step):
            state = self._prepare(model, step)
            with self._lock:
                self._install(state)
        return state.version

    @property
    def model(self) -> FactoredModel:
        return self._state.model

    @property
    def version(self) -> str:
        return self._state.version

    @property
    def device(self) -> torch.device:
        return self._state.model.device

    def maybe_reload(self, store_dir: str, *, retries: int = 2,
                     backoff_s: float = 0.05) -> bool:
        """Hot-swap to the store's newest version if it is newer than
        the one being served.  False when already current or the store
        is empty.

        Reloading replaces the served model WHOLESALE (tasks onboarded
        but never published are dropped with it).  The load happens
        outside the lock; the rebind is guarded by the install-generation
        token captured BEFORE the load, so a reload never overwrites a
        model installed concurrently — it loses the race and returns
        False.  A store version that fails to load is retried
        ``retries`` times with exponential backoff, then skipped with a
        warning for the next older step; when nothing newer verifies,
        the served version stays and the call returns False.
        """
        with trace_span("serve.maybe_reload", store=store_dir) as span:
            span["swapped"] = False
            start = self._state
            steps = checkpoint.available_steps(store_dir)
            newer = [s for s in steps
                     if start.step is None or s > start.step]
            if not newer:
                return False
            step = model = None
            for cand in reversed(newer):   # newest first, degrade older
                err = None
                for attempt in range(retries + 1):
                    try:
                        step, model = FactoredModel.load(
                            store_dir, cand, device=self.device)
                        err = None
                        break
                    except (checkpoint.CheckpointError, ValueError,
                            KeyError, OSError, json.JSONDecodeError) as e:
                        err = e
                        if attempt < retries:
                            time.sleep(backoff_s * (2 ** attempt))
                if err is None:
                    break
                warnings.warn(
                    f"serve store {store_dir} step {cand} failed to load "
                    f"after {retries + 1} attempts ({type(err).__name__}: "
                    f"{err}) — skipping it (pinning the served version if "
                    f"nothing older verifies)")
            if model is None:
                return False              # every newer step is damaged
            if model.version == start.version:
                # already serving this exact artifact: adopt the store
                # step, report no swap
                with self._lock:
                    if self._state.gen == start.gen:
                        self._install(dataclasses.replace(self._state,
                                                          step=step))
                return False
            state = self._prepare(model, step)
            with self._lock:
                if self._state.gen != start.gen:
                    return False          # lost the race to another install
                self._install(state)
            span["swapped"] = True
            span["version"] = state.version
            return True

    # -- scoring -------------------------------------------------------
    def resolve(self, task_key: str) -> int:
        """Task id of a key in the CURRENTLY served version.
        Introspection only: a hot-swap between ``resolve`` and a later
        ``score`` can remap the id; route requests by key through
        :meth:`score_keyed`."""
        idx = self._state.key_index
        if idx is None:
            raise ValueError("model has no task_keys; pass integer ids")
        try:
            return idx[task_key]
        except KeyError:
            raise ValueError(f"unknown task key {task_key!r}") from None

    def score_keyed(self, task_keys: Sequence[str], X
                    ) -> Tuple[torch.Tensor, str]:
        """Key-routed scoring under ONE state snapshot: the keys are
        resolved and scored against the same model version.  Returns
        (margins, version id) like :meth:`score`."""
        st = self._state                       # the one atomic read
        if st.key_index is None:
            raise ValueError("model has no task_keys; use score()")
        try:
            ids = [st.key_index[k] for k in task_keys]
        except KeyError as e:
            raise ValueError(f"unknown task key {e.args[0]!r}") from None
        return self._score_with(st, ids, X), st.version

    def _score_with(self, st: _ServeState, task_ids, X) -> torch.Tensor:
        """Score a batch against ONE state snapshot (hot-swap safe)."""
        dev = st.model.device
        ids = torch.as_tensor(task_ids, device=dev).to(torch.int32)
        X = torch.as_tensor(X, device=dev)
        if X.dtype not in (torch.float32, torch.bfloat16):
            X = X.to(torch.float32)
        if ids.ndim != 1 or X.ndim != 2 or X.shape[0] != ids.shape[0]:
            raise ValueError(f"want ids (N,) and X (N, p); got "
                             f"{tuple(ids.shape)} and {tuple(X.shape)}")
        if X.shape[1] != st.model.p:
            raise ValueError(f"feature dim {X.shape[1]} != model p "
                             f"{st.model.p}")
        X = X.contiguous()
        n, B = ids.shape[0], self.B
        if n == 0:
            return torch.zeros((0,), dtype=torch.float32, device=dev)
        # SLO latency window: the launches + the one validity sync,
        # measured on the host around the device work
        t0 = time.perf_counter()
        outs: List[torch.Tensor] = []
        oks: List[torch.Tensor] = []
        for lo in range(0, n, B):
            wid, wX = ids[lo:lo + B], X[lo:lo + B]
            fill = B - wid.shape[0]
            if fill:                           # pad the last wave
                wid = torch.cat([wid, wid.new_zeros(fill)])
                wX = torch.cat([wX, wX.new_zeros((fill, wX.shape[1]))])
            if self.mesh is None:
                preds, ok = _score_batch_quant(st.U, st.C, st.S, wid, wX,
                                               st.model.m)
            else:
                preds, ok = self._score_sharded(st, wid, wX)
            outs.append(preds[:B - fill] if fill else preds)
            oks.append(ok)
        # ONE host round-trip validates every wave of the call
        ok_all = oks[0] if len(oks) == 1 else torch.all(torch.stack(oks))
        if not bool(ok_all):
            self._bad.inc()
            raise ValueError(f"task ids outside [0, {st.model.m}) in "
                             "this model version")
        self._lat.observe(time.perf_counter() - t0)
        self._req.inc(n)
        self._wav.inc(len(outs))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _score_sharded(self, st: _ServeState, ids: torch.Tensor,
                       X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One wave against this rank's block of code rows: the kernel
        scores the block's local ids (clamped into the block), a mask
        zeroes the ids other ranks hold, and a sum over the axis gives
        every rank each request's one nonzero term."""
        import torch.distributed as dist
        rows = st.C.shape[0]
        local = ids - st.row0
        mine = (local >= 0) & (local < rows)
        preds = mtl_score(st.U, st.C, st.S, torch.clamp(local, 0, rows - 1),
                          X)
        preds = torch.where(mine, preds, torch.zeros_like(preds))
        dist.all_reduce(preds, group=self._group)
        return preds, torch.all((ids >= 0) & (ids < st.model.m))

    def score(self, task_ids, X) -> Tuple[torch.Tensor, str]:
        """Score a mixed-task request batch: (N,) margins + the version
        id that served it.  ``task_ids (N,)`` int, ``X (N, p)`` f32 or
        bf16; the served state is read ONCE for the whole call."""
        st = self._state                       # the one atomic read
        return self._score_with(st, task_ids, X), st.version

    def predict(self, task_ids, X) -> Tuple[torch.Tensor, str]:
        """Margins mapped to predictions: identity for squared loss,
        P(y = +1) for logistic, under one state read."""
        st = self._state                       # the one atomic read
        margins = self._score_with(st, task_ids, X)
        if st.model.loss == "logistic":
            return torch.sigmoid(margins), st.version
        return margins, st.version

    # -- onboarding ----------------------------------------------------
    def onboard(self, task_key: Optional[str], X, y, l2: float = 1e-3,
                iters: int = 25) -> int:
        """Few-shot onboard an unseen task and serve it immediately;
        returns the new task's id.  Concurrent onboards serialize on the
        server lock so none is lost."""
        with trace_span("serve.onboard", task_key=task_key):
            with self._lock:
                model = self._state.model.onboard(task_key, X, y, l2=l2,
                                                  iters=iters)
                self._install(self._prepare(model, self._state.step))
        return model.m - 1
