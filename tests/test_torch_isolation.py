"""The port stands alone: no module of `src/repro_torch/` and not
`chip_smoke.py` imports JAX, the JAX package or msgpack (the card's
machine has none of them), the serving, training, checkpoint and model
zoo modules import with them blocked, and an entry point given no device
on a machine without CUDA raises instead of running on the CPU."""
from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_serving_imports_with_jax_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch.serve.engine, repro_torch.launch.serve\n"
            "import repro_torch.kernels.ops, repro_torch.kernels.autodiff\n"
            "import repro_torch.launch.train, repro_torch.train.loop\n"
            "import repro_torch.optim, repro_torch.graph.negatives\n"
            "import repro_torch.core.coherence, repro_torch.bridge\n"
            "import repro_torch.core.theory, repro_torch.core.pres\n"
            "import repro_torch.train.pipeline, repro_torch.models.embeddings\n"
            "import repro_torch.archs.api, repro_torch.nn.attention\n"
            "import repro_torch.nn.xlstm, repro_torch.configs\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_main_path_imports_with_jax_and_msgpack_blocked():
    """The modules of the train -> checkpoint -> serve path import, and a
    checkpoint round-trips, with JAX and msgpack blocked."""
    code = ("import sys, tempfile, os\n"
            "for name in ('jax', 'jaxlib', 'repro', 'msgpack'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch.checkpoint.io as io\n"
            "import repro_torch.serve.parity, repro_torch.configs.tgn_pres\n"
            "import repro_torch.launch.train, repro_torch.launch.serve\n"
            "import numpy as np\n"
            "path = os.path.join(tempfile.mkdtemp(), 'a.ckpt')\n"
            "io.save_checkpoint(path, {'a': np.arange(3), 'b': {'c': 1.0}})\n"
            "got = io.read_checkpoint(path, {'a': np.zeros(3, np.int64),\n"
            "                                'b': {'c': np.float64(0)}})\n"
            "assert got['a'].tolist() == [0, 1, 2] and got['b']['c'] == 1.0\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_device_without_cuda_raises(tiny_stream):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is valid")
    from repro_torch.models import mdgnn
    from repro_torch.serve import ServeEngine
    cfg = mdgnn.MDGNNConfig(variant="tgn", n_nodes=tiny_stream.num_nodes,
                            d_edge=tiny_stream.feat_dim, d_mem=8, d_msg=8,
                            d_time=4, d_embed=8, n_neighbors=2,
                            use_pres=True, use_kernels=True)
    params = mdgnn.init_params(cfg, device="cpu")
    state = mdgnn.init_state(cfg, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params, state)
    with pytest.raises(RuntimeError, match="CUDA"):
        mdgnn.init_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        mdgnn.init_params(cfg)
    from repro_torch.launch import serve as tserve
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--pres", "--use-kernels", "--max-events", "10"])
