"""AST-level lints of the port's own tree: the invariants ruff can't know.

The reference's four rules, applied to ``src_torch/repro_torch/`` with
the stdlib ``ast`` (nothing to install):

* LINT101 — ``torch.linalg.svd`` / ``svdvals`` (or ``torch.svd``)
  outside ``core/spectral.py`` and ``core/svd_ops.py``.  Full SVDs
  belong to the spectral engine's two audited places (DESIGN.md §9); a
  stray one silently brings back the O(p m min(p, m)) master cost the
  engine exists to avoid.
* LINT102 — host reads in hot paths: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()`` or ``torch.cuda.synchronize`` in
  ``core/worker_ops.py``, or in the request path of ``serve/mtl.py``
  (:data:`REQUEST_PATH`: scoring, prediction and key routing).  Each is
  a device->host round trip that serializes the launch queue.  The
  model's content hash (``FactoredModel._content_hash``) reads the
  factors back, but runs when a model is built or loaded, never per
  request.
* LINT103 — mutating a ``_ServeState`` snapshot after it is built, or a
  ``_ServeState`` that is not a frozen dataclass.  Readers score
  lock-free against an immutable snapshot.
* LINT104 — a kernel built or bound outside ``repro_torch/kernels/``:
  an ``nvcc`` command, a ``torch.utils.cpp_extension`` build, a
  ``ctypes`` library load or ``triton.jit``.  Every kernel lives in a
  package with its ``kernel.py`` (build and binding), ``ops.py``
  (launch on the card, plain version on the CPU, launch counter) and
  ``ref.py`` (the plain version its tests compare against).

``lint_repo()`` walks the port's tree and returns findings in the same
:class:`~repro_torch.analysis.report.Finding` currency as the collective
checks.
"""
from __future__ import annotations

import ast
import pathlib
from typing import List, Optional

from .report import Finding

PACKAGE = "src_torch/repro_torch/"
# files allowed to call a full SVD (repo-relative, posix)
SVD_ALLOWED = (PACKAGE + "core/spectral.py", PACKAGE + "core/svd_ops.py")
_SVD_CALLS = ("linalg.svd", "linalg.svdvals", "torch.svd")
# hot paths: the whole worker-ops module, and the serving request path
WORKER_FILE = PACKAGE + "core/worker_ops.py"
SERVE_FILE = PACKAGE + "serve/mtl.py"
REQUEST_PATH = frozenset({
    "MTLServer.score", "MTLServer.predict", "MTLServer.score_keyed",
    "MTLServer.resolve", "MTLServer._score_with", "MTLServer._score_sharded",
    "_score_batch", "_score_batch_quant"})
_HOST_READS = ("item", "tolist", "cpu", "numpy")
# the one directory allowed to build and bind kernels
KERNEL_DIR = PACKAGE + "kernels/"
_KERNEL_BUILDS = ("cpp_extension.load", "cpp_extension.load_inline",
                  "CDLL", "cdll.LoadLibrary", "triton.jit")


def _repo_root(start: Optional[pathlib.Path] = None) -> pathlib.Path:
    here = (start or pathlib.Path(__file__)).resolve()
    for parent in here.parents:
        if (parent / PACKAGE).is_dir():
            return parent
    raise RuntimeError("cannot locate the repo root above " + str(here))


def _dotted(node: ast.AST) -> str:
    """'torch.linalg.svd' for an Attribute/Name chain ('' when dynamic)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _names_nvcc(node: ast.AST) -> bool:
    """Whether a string constant under ``node`` names the nvcc binary."""
    return any(isinstance(n, ast.Constant) and isinstance(n.value, str)
               and n.value.split("/")[-1] == "nvcc" for n in ast.walk(node))


class _FileLint(ast.NodeVisitor):
    def __init__(self, rel: str, findings: List[Finding]):
        self.rel = rel
        self.findings = findings
        self.serve = rel == SERVE_FILE
        self.svd_ok = rel in SVD_ALLOWED
        self.kernels_ok = rel.startswith(KERNEL_DIR)
        self._scope: List[str] = []        # enclosing class/def names
        # names bound to a fresh _ServeState(...) in the current scope
        self._snapshots: List[set] = [set()]

    def _hot(self) -> bool:
        if self.rel == WORKER_FILE:
            return True
        return self.serve and any(
            ".".join(self._scope[:i + 1]) in REQUEST_PATH
            for i in range(len(self._scope)))

    # -- scope bookkeeping --------------------------------------------
    def visit_FunctionDef(self, node):
        if not self.kernels_ok and any(
                _dotted(d.func if isinstance(d, ast.Call) else d)
                .endswith("triton.jit") for d in node.decorator_list):
            self._kernel(node, "a triton.jit kernel")
        self._scope.append(node.name)
        self._snapshots.append(set())
        self.generic_visit(node)
        self._snapshots.pop()
        self._scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _where(self, node) -> str:
        return f"{self.rel}:{node.lineno}"

    def _kernel(self, node, what: str) -> None:
        self.findings.append(Finding(
            "LINT104",
            f"{what} outside {KERNEL_DIR} — package the kernel there "
            f"(kernel.py build and binding + ops.py launcher with its "
            f"plain CPU version + ref.py) and call it through its ops "
            f"wrapper", self._where(node)))

    # -- LINT101 / LINT102 / LINT104: calls ----------------------------
    def visit_Call(self, node):
        name = _dotted(node.func)
        if name.endswith(_SVD_CALLS) and not self.svd_ok:
            self.findings.append(Finding(
                "LINT101",
                f"{name} outside the audited spectral modules — route "
                f"through repro_torch.core.spectral (truncate_factors / "
                f"leading_sv) or core.svd_ops", self._where(node)))
        if self._hot():
            leaf = name.rsplit(".", 1)[-1]
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _HOST_READS) \
                    or name.endswith("cuda.synchronize"):
                self.findings.append(Finding(
                    "LINT102",
                    f"{leaf}() in a hot path is a device->host read that "
                    f"blocks on the launch queue — return tensors and "
                    f"convert at the edge", self._where(node)))
        if not self.kernels_ok:
            if name.endswith(_KERNEL_BUILDS):
                self._kernel(node, f"a kernel build or binding ({name})")
            elif name.split(".")[0] in ("subprocess", "os") \
                    and _names_nvcc(node):
                self._kernel(node, "an nvcc build")
        if self.serve and name == "object.__setattr__" \
                and "__post_init__" not in self._scope:
            self.findings.append(Finding(
                "LINT103",
                "object.__setattr__ outside __post_init__ mutates a "
                "frozen snapshot — build a new _ServeState and swap the "
                "reference instead", self._where(node)))
        self.generic_visit(node)

    # -- LINT103: snapshot mutation -----------------------------------
    def _track_snapshot_binding(self, target, value):
        if (isinstance(value, ast.Call)
                and _dotted(value.func).endswith("_ServeState")
                and isinstance(target, ast.Name)):
            self._snapshots[-1].add(target.id)

    def visit_Assign(self, node):
        for t in node.targets:
            self._track_snapshot_binding(t, node.value)
            self._check_snapshot_write(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._check_snapshot_write(node.target)
        self.generic_visit(node)

    def _check_snapshot_write(self, target):
        if not self.serve:
            return
        if isinstance(target, (ast.Attribute, ast.Subscript)):
            base = target.value
            while isinstance(base, (ast.Attribute, ast.Subscript)):
                base = base.value
            if isinstance(base, ast.Name) and any(
                    base.id in scope for scope in self._snapshots):
                self.findings.append(Finding(
                    "LINT103",
                    f"write into _ServeState snapshot {base.id!r} after "
                    f"construction — snapshots are immutable; readers "
                    f"score against them lock-free", self._where(target)))

    # -- class-level invariant: _ServeState stays frozen ---------------
    def visit_ClassDef(self, node):
        if self.serve and node.name == "_ServeState":
            frozen = any(
                isinstance(dec, ast.Call)
                and _dotted(dec.func).endswith("dataclass")
                and any(kw.arg == "frozen"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True
                        for kw in dec.keywords)
                for dec in node.decorator_list)
            if not frozen:
                self.findings.append(Finding(
                    "LINT103",
                    "_ServeState must be @dataclasses.dataclass("
                    "frozen=True) — the lock-free reader contract depends "
                    "on immutable snapshots", self._where(node)))
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()


def lint_file(path: pathlib.Path, rel: str) -> List[Finding]:
    findings: List[Finding] = []
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as e:
        findings.append(Finding("LINT100", f"syntax error: {e}", rel))
        return findings
    _FileLint(rel, findings).visit(tree)
    return findings


def lint_repo(root: Optional[pathlib.Path] = None) -> List[Finding]:
    """Run the AST lints over every source file of the port."""
    root = root or _repo_root()
    findings: List[Finding] = []
    for path in sorted((root / PACKAGE).rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        findings.extend(lint_file(path, rel))
    return findings
