"""The port stands alone: it imports torch and numpy, never JAX and never
the JAX package, not even the JAX package's pure-numpy modules.

Checked twice: by importing every module of ``mano_hand_tpu_torch`` in a
fresh interpreter and reading ``sys.modules``, and by an AST scan of every
source file of the package, of ``chip_smoke.py`` and of the port's timing
scripts.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "mano_hand_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "mano_hand_tpu")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = (
        "import json, pkgutil, importlib, sys\n"
        "before = set(sys.modules)\n"
        "import mano_hand_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(json.dumps({'names': names, 'before': sorted(before), "
        "'after': sorted(sys.modules)}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in got["before"] if _forbidden(m)], (
        "the interpreter preloaded JAX before the port was imported")
    assert len(got["names"]) >= 15            # every submodule was imported
    leaked = [m for m in got["after"] if _forbidden(m)]
    assert leaked == []


# The port's own timing scripts (the rest of ``scripts/`` is the JAX
# package's).
PORT_SCRIPTS = ("time_fused_forward.py", "time_store_promotion.py")


def _sources():
    files = sorted(PKG.rglob("*.py"))
    smoke = ROOT / "chip_smoke.py"
    if smoke.exists():
        files.append(smoke)
    files += [ROOT / "scripts" / name for name in PORT_SCRIPTS]
    # The rank processes of the parallel tests run the port alone.
    files.append(ROOT / "tests" / "torch_parallel_ranks.py")
    return files


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert bad == []


@pytest.mark.parametrize("module", ["mano_hand_tpu_torch.edge.proxy",
                                    "mano_hand_tpu_torch.edge.fleet"])
def test_fleet_modules_and_their_processes_stay_in_the_port(module):
    """The fleet's modules load no JAX in a fresh interpreter, and the
    processes they spawn (``serve`` workers, ``proxy`` pair members) run
    the port's command line, never the JAX package's."""
    code = (
        "import json, sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "from mano_hand_tpu_torch.edge import ProxySpec, WorkerSpec\n"
        "argv = [WorkerSpec(device='cuda').argv(), ProxySpec(port=1, "
        "lock_path='l', backends=[('w0', 'h', 2)]).argv()]\n"
        "print(json.dumps({'after': sorted(sys.modules), 'argv': argv}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in got["after"] if _forbidden(m)] == []
    for argv in got["argv"]:
        assert argv[1:3] == ["-m", "mano_hand_tpu_torch.cli"]
        assert not [a for a in argv if _forbidden(a)]
    assert got["argv"][0][3:5] == ["--device", "cuda"]


@pytest.mark.parametrize("module", ["mano_hand_tpu_torch.serving.traffic",
                                    "mano_hand_tpu_torch.serving.control"])
def test_control_modules_run_without_jax(module):
    """The closed-loop controller and its traces load no JAX in a fresh
    interpreter, also when they run: a trace is made and a controller
    ticks once over a CPU engine, its signals swept from the engine's own
    ``load()``, counters and ``slo_report``."""
    code = (
        "import json, sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "from mano_hand_tpu_torch.assets import synthetic_params\n"
        "from mano_hand_tpu_torch.serving import ServingEngine, traffic\n"
        "from mano_hand_tpu_torch.serving.control import Controller\n"
        "tr = traffic.make_trace('flash_crowd', seed=1, duration_s=1.0, "
        "base_hz=10.0, peak_hz=50.0)\n"
        "eng = ServingEngine(synthetic_params(seed=0, device='cpu'), "
        "device='cpu', max_bucket=2, max_queued=4)\n"
        "ctl = Controller(eng)\n"
        "ctl.tick()\n"
        "print(json.dumps({'after': sorted(sys.modules), "
        "'arrivals': len(tr), 'ticks': eng.counters.control_ticks}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in got["after"] if _forbidden(m)] == []
    assert got["arrivals"] > 0 and got["ticks"] == 1


def test_parallel_utils_and_analysis_run_without_jax():
    """The parallel package, the utilities and the static analysis load no
    JAX in a fresh interpreter, also when they run: a one-rank CPU mesh
    (its own gloo group) runs K1's data-parallel forward, the sharded
    forwards and a fit step, a prefetch lands on it, and ``analyze``'s
    AST checkers pass."""
    code = (
        "import json, sys, torch\n"
        "from mano_hand_tpu_torch import parallel\n"
        "from mano_hand_tpu_torch.analysis.run import run_analysis\n"
        "from mano_hand_tpu_torch.assets import synthetic_params\n"
        "from mano_hand_tpu_torch.fitting import solvers\n"
        "from mano_hand_tpu_torch.utils import ManoConfig, batches, "
        "prefetch_to_device\n"
        "p = synthetic_params(seed=0, dtype=torch.float32, device='cpu')\n"
        "mesh = ManoConfig().build_mesh(devices=['cpu'])\n"
        "pose, shape = torch.zeros(4, 16, 3), torch.zeros(4, 10)\n"
        "sp = parallel.shard_params(p, mesh)\n"
        "outs = [f(pose, shape).full_tensor() for f in ("
        "parallel.pallas_forward_dp(p, mesh, full=True), "
        "parallel.shard_map_forward(sp, mesh), "
        "parallel.gspmd_forward(sp, mesh))]\n"
        "opt = solvers.adam(0.05)\n"
        "st = parallel.init_state(p, 4, opt, mesh=mesh)\n"
        "st, loss = parallel.make_fit_step(sp, mesh, opt)(st, outs[0])\n"
        "b = next(prefetch_to_device(batches({'x': pose.numpy()}, 2), "
        "mesh=mesh))\n"
        "rc = run_analysis(skip_fx=True, log=lambda *a: None)\n"
        "print(json.dumps({'after': sorted(sys.modules), 'rc': rc, "
        "'loss': float(loss), 'shapes': [list(o.shape) for o in outs], "
        "'batch': list(b['x'].shape)}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in got["after"] if _forbidden(m)] == []
    assert got["rc"] == 0 and 0.0 <= got["loss"] < 1e-12
    assert got["shapes"] == [[4, 778, 3]] * 3 and got["batch"] == [2, 16, 3]
