"""The port stands alone: nothing under ``src_torch/`` and not
``chip_smoke.py`` imports JAX or the reference package, importing the
serving, solver, LM and Mamba paths leaves JAX unloaded, training leaves
``torch._dynamo`` unloaded and the environment unchanged, and the entry
points default to the card."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted((ROOT / "src_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_import_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 10
    bad = [(f.relative_to(ROOT).as_posix(), mod)
           for f in files for mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def _torch_calls(path):
    """Dotted names under ``torch`` that a file reads or imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            parts, cur = [node.attr], node.value
            while isinstance(cur, ast.Attribute):
                parts.append(cur.attr)
                cur = cur.value
            if isinstance(cur, ast.Name):
                yield ".".join([cur.id] + parts[::-1])
    yield from _imported_modules(path)


def test_port_modules_use_neither_torch_optim_nor_checkpoint():
    """``torch.optim``'s step and ``torch.utils.checkpoint`` import
    ``torch._dynamo``, which writes ``os.environ``: the training path
    has its own AdamW and recomputation.  (``chip_smoke.py`` compiles
    FlexAttention for a library timing, outside the port.)"""
    banned = ("torch.optim", "torch.utils.checkpoint", "torch._dynamo",
              "torch.compile")
    files = sorted((ROOT / "src_torch").rglob("*.py"))
    bad = [(f.relative_to(ROOT).as_posix(), name)
           for f in files for name in _torch_calls(f)
           if name and name.startswith(banned)]
    assert not bad, bad


def test_importing_the_serving_path_leaves_jax_unloaded():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src_torch')!r})\n"
        "import repro_torch.serve.mtl, repro_torch.kernels.mtl_score.ops\n"
        "import repro_torch.interop, repro_torch.api\n"
        "import repro_torch.core.methods.convex, repro_torch.core.methods.greedy\n"
        "import repro_torch.core.methods.baselines, repro_torch.runtime.sim\n"
        "import repro_torch.kernels.mtl_grad.ops\n"
        "from repro_torch import solve\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_the_stochastic_path_leaves_jax_unloaded():
    """The slice-3 modules import, and a stochastic solve on data from
    the port's own generator runs, without JAX or the reference."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src_torch')!r})\n"
        "import repro_torch.core.prng, repro_torch.data.synthetic\n"
        "import repro_torch.kernels.prox_step.ops\n"
        "from repro_torch import solve\n"
        "from repro_torch.core import prng\n"
        "from repro_torch.core.methods import MTLProblem\n"
        "from repro_torch.data.synthetic import SimSpec, generate\n"
        "Xs, ys, _, _ = generate(prng.PRNGKey(0, device='cpu'),\n"
        "                        SimSpec(p=8, m=4, r=2, n=16), device='cpu')\n"
        "prob = MTLProblem.make(Xs, ys, gram=False, device='cpu')\n"
        "res = solve(prob, method='admm', rounds=2, batch_size=4,\n"
        "            local_steps=2, device='cpu')\n"
        "assert res.extras['local_steps'] == 2\n"
        "solve(prob, method='altmin', rounds=2, device='cpu')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_the_mesh_path_leaves_jax_unloaded(tmp_path):
    """The mesh slice's modules import, and a mesh solve, a sharded-table
    wave and the sim's 2-D emulation run in a gloo group of one process,
    without JAX or the reference."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src_torch')!r})\n"
        "import numpy as np, torch\n"
        "import repro_torch.runtime.mesh, repro_torch.runtime.recovery\n"
        "import repro_torch.core.distributed\n"
        "import torch.distributed as dist\n"
        "from repro_torch import solve\n"
        "from repro_torch.core.distributed import dgsp_distributed\n"
        "from repro_torch.core.methods import MTLProblem\n"
        "from repro_torch.runtime import init_cluster, task_mesh\n"
        "from repro_torch.serve.mtl import FactoredModel, MTLServer\n"
        "rng = np.random.default_rng(0)\n"
        "X = rng.standard_normal((4, 16, 8)).astype(np.float32)\n"
        "y = rng.standard_normal((4, 16)).astype(np.float32)\n"
        "prob = MTLProblem.make(X, y, gram=False, device='cpu')\n"
        f"init_cluster('file://{tmp_path / 'store'}', 1, 0, device='cpu')\n"
        "mesh = task_mesh(device='cpu')\n"
        "res = dgsp_distributed(prob, rounds=2, mesh=mesh)\n"
        "assert res.collective_floats_per_chip > 0\n"
        "solve(prob, method='proxgd', rounds=2, data_shards=2, device='cpu')\n"
        "model = FactoredModel.from_W(torch.ones(8, 4), 2, device='cpu')\n"
        "MTLServer(model, mesh=mesh).score([0, 3], torch.ones(2, 8))\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_the_recovery_metrics_and_streaming_path_leaves_jax_unloaded(
        tmp_path):
    """The recovery, fault-harness, device-metrics and streaming modules
    import, and a checkpointed solve with metrics, its resume and one
    streaming refresh published to a server run, without JAX or the
    reference."""
    code = (
        "import os, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src_torch')!r})\n"
        "import repro_torch.runtime.recovery, repro_torch.faults\n"
        "import repro_torch.obs.device, repro_torch.obs.__main__\n"
        "import repro_torch.train.streaming\n"
        "from repro_torch import resume, solve\n"
        "from repro_torch.faults import demo_problem\n"
        "from repro_torch.serve.mtl import MTLServer\n"
        "from repro_torch.train.streaming import (SampleStream,\n"
        "                                         StreamingResolver)\n"
        f"d = {str(tmp_path)!r}\n"
        "prob = demo_problem('cpu')\n"
        "res = solve(prob, method='proxgd', rounds=5, lam=0.05,\n"
        "            metrics=True, checkpoint_every=2,\n"
        "            ckpt_dir=os.path.join(d, 'ckpt'), device='cpu')\n"
        "again = resume(os.path.join(d, 'ckpt'), device='cpu')\n"
        "assert (again.W == res.W).all()\n"
        "assert res.extras['metrics']['round'].tolist() == [1, 2, 3, 4, 5]\n"
        "store = os.path.join(d, 'models')\n"
        "model = res.factorize(3)\n"
        "model.save(store)\n"
        "server = MTLServer(model)\n"
        "stream = SampleStream(res.W, prob.gram_A.mean(0), device='cpu')\n"
        "rep = StreamingResolver(prob, server, store, rounds=2,\n"
        "                        batch_size=8, solver_hp={'lam': 0.05}\n"
        "                        ).step(stream, 4)\n"
        "assert rep['reloaded'] and rep['store_step'] == 1\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_the_static_checks_and_surrogates_leave_jax_unloaded(tmp_path):
    """The analysis package and the Fig-4 surrogates import, and a
    verified solve on the sim and the one-rank mesh, the repo lints and
    a surrogate with its task split and metric run, without JAX or the
    reference, and without writing the process's environment."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src_torch')!r})\n"
        "import repro_torch.analysis, repro_torch.analysis.__main__\n"
        "import repro_torch.data.realworld as rw\n"
        "import torch.distributed as dist\n"
        "from repro_torch import solve\n"
        "from repro_torch.analysis import build_problem, lint_repo\n"
        "from repro_torch.core import prng\n"
        "from repro_torch.core.methods import MTLProblem\n"
        "from repro_torch.runtime import init_cluster\n"
        "import os\n"
        "env = dict(os.environ)\n"
        "prob, _ = build_problem(device='cpu')\n"
        f"init_cluster('file://{tmp_path / 'store'}', 1, 0, device='cpu')\n"
        "for backend in ('sim', 'mesh'):\n"
        "    res = solve(prob, method='dgsp', rounds=2, backend=backend,\n"
        "                verify='static', device='cpu')\n"
        "    assert res.extras['static_verify'] == 'ok'\n"
        "dist.destroy_process_group()\n"
        "assert lint_repo() == []\n"
        "spec = rw.REAL_SPECS['landmine']\n"
        "Xs, ys, Xt, yt = rw.generate_surrogate(prng.PRNGKey(304, 'cpu'),\n"
        "                                       spec, device='cpu')\n"
        "train, _ = rw.split_tasks(spec.m, 4, device='cpu')\n"
        "Xs, ys = rw.take_tasks(train, Xs, ys)\n"
        "res = solve(MTLProblem.make(Xs, ys, 'logistic', device='cpu'),\n"
        "            method='dgsp', rounds=2, device='cpu')\n"
        "Xt, yt = rw.take_tasks(train, Xt, yt)\n"
        "assert 0 <= float(rw.test_metric(spec.task, res.W, Xt, yt)) <= 1\n"
        "assert dict(os.environ) == env, 'the run wrote the environment'\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_the_lm_serving_path_leaves_jax_unloaded():
    """The slice-4 modules import, and a seeded model serves a wave on
    the CPU, without JAX or the reference."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src_torch')!r})\n"
        "import numpy as np, torch\n"
        "import repro_torch.configs, repro_torch.models.model\n"
        "import repro_torch.serve.engine\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.models import init_params\n"
        "from repro_torch.serve.engine import Request, ServeEngine\n"
        "cfg = get_smoke_config('gemma2-2b')\n"
        "model = init_params(cfg, torch.Generator().manual_seed(0),\n"
        "                    device='cpu')\n"
        "eng = ServeEngine(model, cfg, batch_size=2, max_len=32,\n"
        "                  device='cpu')\n"
        "reqs = eng.generate([Request(np.arange(5), max_new_tokens=3)])\n"
        "assert len(reqs[0].out_tokens) == 3\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_the_mamba_serving_path_leaves_jax_unloaded():
    """The slice-5 modules import, and a seeded falcon-mamba model serves
    a wave on the CPU, without JAX or the reference."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src_torch')!r})\n"
        "import numpy as np, torch\n"
        "import repro_torch.models.ssm, repro_torch.kernels.ssm_scan.ops\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.models import init_params\n"
        "from repro_torch.serve.engine import Request, ServeEngine\n"
        "cfg = get_smoke_config('falcon-mamba-7b')\n"
        "model = init_params(cfg, torch.Generator().manual_seed(0),\n"
        "                    device='cpu')\n"
        "eng = ServeEngine(model, cfg, batch_size=2, max_len=32,\n"
        "                  device='cpu')\n"
        "reqs = eng.generate([Request(np.arange(5), max_new_tokens=3)])\n"
        "assert len(reqs[0].out_tokens) == 3\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_the_training_path_leaves_jax_and_dynamo_unloaded(tmp_path):
    """One TINY train step with remat on, a killed-and-resumed
    ``train_loop``, an ``MTLHead`` fit and the roofline run without JAX
    or the reference, without loading ``torch._dynamo`` and without
    writing the process's environment."""
    code = (
        "import os, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src_torch')!r})\n"
        "env = dict(os.environ)\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import repro_torch.launch.train, repro_torch.launch.roofline as rf\n"
        "from repro_torch.configs.base import ModelConfig\n"
        "from repro_torch.core.head import MTLHead, MTLHeadConfig\n"
        "from repro_torch.data.tokens import (SyntheticTokenStream,\n"
        "                                     TokenPipelineSpec)\n"
        "from repro_torch.train.loop import train_loop\n"
        "from repro_torch.train.steps import (TrainConfig, init_train_state,\n"
        "                                     make_train_step)\n"
        "cfg = ModelConfig(arch_id='tiny', n_layers=2, d_model=64,\n"
        "                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,\n"
        "                  dtype='float32', remat=True)\n"
        "tcfg = TrainConfig(total_steps=4, warmup_steps=1)\n"
        "stream = SyntheticTokenStream(TokenPipelineSpec(128, 16, 2))\n"
        "batches = [stream.batch(i) for i in range(4)]\n"
        "new = lambda: init_train_state(cfg, tcfg,\n"
        "    torch.Generator().manual_seed(0), device='cpu')\n"
        "step = make_train_step(cfg, tcfg)\n"
        "state, m = step(new(), {'tokens': torch.from_numpy(batches[0][0]),\n"
        "                        'targets': torch.from_numpy(batches[0][1])})\n"
        "assert torch.isfinite(m['loss']) and int(state['opt']['count']) == 1\n"
        f"d = {str(tmp_path / 'ck')!r}\n"
        "train_loop(step, new(), batches, 2, ckpt_dir=d, log_fn=print)\n"
        "train_loop(step, new(), batches, 4, ckpt_dir=d, log_fn=print)\n"
        "X = np.random.default_rng(0).standard_normal((3, 20, 8))\n"
        "head = MTLHead(MTLHeadConfig(rounds=2, rank=2)).fit_features(\n"
        "    X.astype(np.float32), X[..., 0].astype(np.float32),\n"
        "    device='cpu')\n"
        "from repro_torch.configs import INPUT_SHAPES\n"
        "assert head.W.shape == (8, 3)\n"
        "assert rf.model_flops(cfg, INPUT_SHAPES['train_4k']) > 0\n"
        "assert dict(os.environ) == env, 'the run wrote the environment'\n"
        "assert 'torch._dynamo' not in sys.modules, 'torch._dynamo loaded'\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "resume: restarting from checkpoint step 2" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "clean"


def test_the_train_launcher_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--arch", "gemma2-2b", "--steps", "3", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src_torch"),
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("arch=gemma2-2b layout=replicated (one "
                               "device)"), lines[0]
    assert lines[-1].startswith("final loss "), lines[-1]
    final = float(lines[-1].split()[2])
    assert 0 < final < 100


def test_a_grad_requiring_scan_refuses_a_carried_state():
    import torch
    sys.path.insert(0, str(ROOT / "src_torch"))
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    g = torch.Generator().manual_seed(0)
    B, S, I, N = 1, 4, 8, 4
    x, dt_lin, z = (torch.randn(B, S, I, generator=g) for _ in range(3))
    Bc, Cc = (torch.randn(B, S, N, generator=g) for _ in range(2))
    dt_bias, D = torch.zeros(I), torch.ones(I)
    A_log = torch.zeros(I, N)
    x.requires_grad_(True)
    h = torch.zeros(B, I, N)
    args = (x, dt_lin, dt_bias, Bc, Cc, A_log, D, z)
    for kw in ({"h0": h}, {"h_out": h}, {"h0": h, "h_out": h}):
        with pytest.raises(ValueError, match="carried state"):
            ssm_ops.mamba_scan(*args, **kw)
    out, _ = ssm_ops.mamba_scan(*args)            # no state: differentiable
    assert out.grad_fn is not None
    with torch.no_grad():                         # serving: the state is fine
        ssm_ops.mamba_scan(*args, h0=h, h_out=h)


def test_entry_points_default_to_the_card():
    """``device=None`` means CUDA; on a host without a card the problem
    constructor and the front door raise instead of using the CPU."""
    import numpy as np
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default is legitimate here")
    sys.path.insert(0, str(ROOT / "src_torch"))
    import repro_torch
    from repro_torch.core.methods import MTLProblem
    X = np.zeros((2, 4, 3), np.float32)
    y = np.zeros((2, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        MTLProblem.make(X, y)
    prob = MTLProblem.make(X, y, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.solve(prob, method="local")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve.engine import ServeEngine
    cfg = get_smoke_config("gemma2-2b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
    model = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, cfg, batch_size=1, max_len=8, device=None)
    from repro_torch.runtime import init_cluster, task_data_mesh, task_mesh
    with pytest.raises(RuntimeError, match="CUDA"):
        task_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        task_data_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cluster("file:///unused", 1, 0)
    from repro_torch.analysis import build_problem, run_analysis
    with pytest.raises(RuntimeError, match="CUDA"):
        build_problem()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_analysis(layouts=("sim",), lint_paths=False)
    from repro_torch.analysis.__main__ import main as analysis_cli
    with pytest.raises(RuntimeError, match="CUDA"):
        analysis_cli(["--layouts", "sim", "--no-lint"])
    from repro_torch.launch.train import main as train_cli
    from repro_torch.train.steps import TrainConfig, init_train_state
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli(["--smoke", "--steps", "1"])
