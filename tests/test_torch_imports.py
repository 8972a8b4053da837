"""The port imports neither JAX nor the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _absolute_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_or_repro():
    files = _sources()
    assert len(files) > 10 and files[-1].exists()
    obs = {f.name for f in files if f.parent.name == "obs"}
    assert obs == {"__init__.py", "tracer.py", "schema.py", "summary.py",
                   "recorder.py", "compile_watch.py"}
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _absolute_imports(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import repro_torch.api, repro_torch.models, repro_torch.kernels.ops\n"
            "import repro_torch.distributed, repro_torch.distributed.async_trainer\n"
            "import repro_torch.core, repro_torch.data, repro_torch.optim\n"
            "import repro_torch.runtime, repro_torch.launch.profile_train\n"
            "import repro_torch.launch.profile_serve\n"
            "import repro_torch.kernels.ssd_chunk, repro_torch.models.layers\n"
            "import repro_torch.objectives, repro_torch.scenarios\n"
            "import repro_torch.faults, repro_torch.core.simulator\n"
            "import repro_torch.launch.profile_sim, repro_torch.checkpoint\n"
            "from repro_torch.checkpoint import AsyncSnapshotter, restore\n"
            "from repro_torch.distributed import RetryPolicy, ServePreempted\n"
            "from repro_torch.api import SimulatorBackend, grid\n"
            "from repro_torch.scenarios import TRANSFORMS\n"
            "import repro_torch.obs, repro_torch.obs.schema\n"
            "from repro_torch.obs import Recorder, CompileWatch, Tracer\n"
            "from repro_torch.obs import validate_chrome_trace\n"
            "from repro_torch.runtime import quantize_zipf_trajectory\n"
            "from repro_torch.distributed.async_trainer import sparsify\n"
            "from repro_torch.faults import GuardConfig\n"
            "assert 'nan_grad' in TRANSFORMS   # faults registered\n"
            "from repro_torch.kernels.ops import ssd_chunk, sgd_momentum_step\n"
            "from repro_torch.kernels.ops import sgd_momentum_delayed\n"
            "from repro_torch.models.model import FAMILIES\n"
            "assert FAMILIES == ('dense', 'ssm', 'hybrid', 'moe', 'audio',"
            " 'vlm')\n"
            "import repro_torch.launch.train\n"
            "from repro_torch.launch.train import main, MESH_FLAGS\n"
            "from repro_torch.models.layers import moe_ffn, moe_router\n"
            "import repro_torch.launch.mesh, repro_torch.launch.op_cost\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
            "import repro_torch.launch.hillclimb\n"
            "import repro_torch.distributed.sharding\n"
            "from repro_torch.distributed.sharding import PSpec, Rules\n"
            "from repro_torch.distributed.sharding import (NamedSharding,\n"
            "    activation_sharding, data_context, tree_shardings)\n"
            "from repro_torch.distributed.collectives import all_gather_rows\n"
            "from repro_torch.launch.mesh import ProcessMesh\n"
            "from repro_torch.launch.train import choose_mesh\n"
            "from repro_torch.models.convert import state_from_numpy\n"
            "from repro_torch.models.specs import meta_tree\n"
            "import repro_torch.models.tp\n"
            "from repro_torch.models.tp import (TP, ThreadRanks, attn_local,\n"
            "    decode_local, plan)\n"
            "from repro_torch.models.convert import params_blocks\n"
            "from repro_torch.distributed.collectives import (\n"
            "    copy_to_model, reduce_from_model, gather_from_model)\n"
            "from repro_torch.distributed.sharding import (model_context,\n"
            "    check_model_axis, TP_FAMILIES)\n"
            "from repro_torch.models.layers import (vocab_parallel_xent,\n"
            "    decode_attention_ctx)\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
