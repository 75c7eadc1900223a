"""The port stands alone: it imports neither JAX nor ``paddle_tpu``, and
its entry points never fall back to the CPU unasked."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_import_and_cpu_model_pull_in_no_jax():
    code = (
        "import sys\n"
        "import paddle_tpu_torch as pt\n"
        "m = pt.LlamaForCausalLM(pt.llama_tiny(), device='cpu')\n"
        "m([[1, 2, 3]])\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib')) or k == 'paddle_tpu' or "
        "k.startswith('paddle_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("module", ["paddle_tpu_torch.amp",
                                    "paddle_tpu_torch.amp.debugging"])
def test_amp_modules_pull_in_no_jax(module):
    """The AMP modules alone, and a CPU model's O2 step under them."""
    code = (
        "import sys, importlib\n"
        f"amp = importlib.import_module({module!r})\n"
        "from paddle_tpu_torch import amp, llama_tiny, LlamaForCausalLM\n"
        "m = amp.decorate(LlamaForCausalLM(llama_tiny(), device='cpu'),\n"
        "                 level='O2', dtype='bfloat16')\n"
        "with amp.auto_cast(level='O2', dtype='bfloat16'):\n"
        "    loss, _ = m([[1, 2, 3]], labels=[[2, 3, 4]])\n"
        "amp.GradScaler().scale(loss).backward()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib')) or k == 'paddle_tpu' or "
        "k.startswith('paddle_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_reference(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "paddle_tpu"), (path, name)


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.framework.core", "paddle_tpu_torch.framework.dtype",
    "paddle_tpu_torch.framework.random", "paddle_tpu_torch.ops.logic",
    "paddle_tpu_torch.ops.creation", "paddle_tpu_torch.ops.math",
    "paddle_tpu_torch.ops.manipulation", "paddle_tpu_torch.ops.linalg",
    "paddle_tpu_torch.tensor"])
def test_ops_modules_pull_in_no_jax(module):
    """The ops layer alone, and a few of its calls on the CPU."""
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "import paddle_tpu_torch as paddle\n"
        "paddle.set_device('cpu')\n"
        "x = paddle.randn([3, 4])\n"
        "paddle.linalg.norm(paddle.matmul(x, x, transpose_y=True))\n"
        "paddle.concat(paddle.split(x, [1, -1], axis=1), axis=1)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib')) or k == 'paddle_tpu' or "
        "k.startswith('paddle_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_refuse_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    import paddle_tpu_torch as pt
    with pytest.raises(RuntimeError):
        pt.LlamaForCausalLM(pt.llama_tiny())
    model = pt.LlamaForCausalLM(pt.llama_tiny(), device="cpu")
    with pytest.raises(RuntimeError):
        pt.ContinuousServingEngine(model)
    with pytest.raises(RuntimeError):
        pt.ContinuousServingEngine(model, enable_ragged=False)
    with pytest.raises(RuntimeError):
        pt.ServingEngine(model)


_LOOP_SURFACE = (
    "import numpy as np, torch\n"
    "import paddle_tpu_torch as paddle\n"
    "paddle.set_device('cpu')\n"
    "x = paddle.to_tensor(np.ones(3, np.float32), stop_gradient=False)\n"
    "(g,) = paddle.grad((x * x).sum(), x)\n"
    "class Twice(paddle.autograd.PyLayer):\n"
    "    @staticmethod\n"
    "    def forward(ctx, t):\n"
    "        return t * 2\n"
    "    @staticmethod\n"
    "    def backward(ctx, d):\n"
    "        return d * 2\n"
    "Twice.apply(x).sum().backward()\n"
    "data = [(np.ones(4, np.float32), np.int64(1))] * 6\n"
    "net = paddle.nn.Linear(4, 2)\n"
    "model = paddle.Model(net)\n"
    "model.prepare(paddle.optimizer.RAdam(parameters=net.parameters()),\n"
    "              paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())\n"
    "model.fit(paddle.io.DataLoader(data, batch_size=2, num_workers=1),\n"
    "          epochs=1, verbose=0, callbacks=[paddle.callbacks.Callback()])\n"
    "f = paddle.jit.to_static(lambda t: t * 3 + 1, backend='eager')\n"
    "assert float(f(torch.ones(2)).sum()) == 8.0\n"
    "bad = sorted(k for k in sys.modules if k == 'jax' or "
    "k.startswith(('jax.', 'jaxlib')) or k == 'paddle_tpu' or "
    "k.startswith('paddle_tpu.'))\n"
    "assert not bad, bad\n"
    "print('ok')\n")


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.autograd", "paddle_tpu_torch.io",
    "paddle_tpu_torch.metric", "paddle_tpu_torch.callbacks",
    "paddle_tpu_torch.hapi", "paddle_tpu_torch.jit",
    "paddle_tpu_torch.framework.tensor_patch",
    "paddle_tpu_torch.optimizer.extras"])
def test_training_loop_modules_pull_in_no_jax(module):
    """Each module of the training-loop surface alone, then a
    ``paddle.grad``, a ``PyLayer``, a ``Model.fit`` over a ``DataLoader``
    with a worker, and a ``to_static`` function on the CPU."""
    code = ("import sys, importlib\n"
            f"importlib.import_module({module!r})\n" + _LOOP_SURFACE)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_loader_refuses_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    dev = core.get_device()
    pt.set_device("gpu")
    try:
        loader = pt.io.DataLoader([(1.0,)] * 4, batch_size=2)
        with pytest.raises(RuntimeError):
            iter(loader)
        with pytest.raises(RuntimeError):
            pt.Model(pt.nn.Linear(2, 2))
    finally:
        pt.set_device(dev)


_ZOO = {
    "gpt": "from paddle_tpu_torch.models import gpt as m\n"
           "net = m.GPTForCausalLM(m.gpt_tiny(), device='cpu')\n"
           "net.generate([[1, 2, 3]], max_new_tokens=2,\n"
           "             use_paged_cache=True)\n",
    "bert": "from paddle_tpu_torch.models import bert as m\n"
            "net = m.ErnieForSequenceClassification(m.bert_tiny(), "
            "device='cpu')\n"
            "net([[1, 2, 3]], attention_mask=[[1, 1, 0]], labels=[1])\n",
    "t5": "from paddle_tpu_torch.models import t5 as m\n"
          "net = m.T5ForConditionalGeneration(m.t5_tiny(), device='cpu')\n"
          "net.generate([[5, 6, 7]], max_new_tokens=2)\n",
    "mixtral": "from paddle_tpu_torch.models import mixtral as m\n"
               "net = m.MixtralForCausalLM(m.mixtral_tiny(), device='cpu')\n"
               "net([[1, 2, 3]], labels=[[2, 3, 4]])[0].backward()\n",
    "transformer": "import paddle_tpu_torch as p\n"
                   "p.set_device('cpu')\n"
                   "import torch\n"
                   "net = p.nn.Transformer(16, 2, 1, 1, 32)\n"
                   "net(torch.ones(1, 3, 16), torch.ones(1, 2, 16))\n",
    "moe": "import paddle_tpu_torch as p\n"
           "p.set_device('cpu')\n"
           "import torch\n"
           "from paddle_tpu_torch.incubate.distributed.models import moe\n"
           "moe.MoELayer(8, num_experts=4, d_hidden=16)(torch.ones(2, 8))\n",
}


@pytest.mark.parametrize("family", sorted(_ZOO))
def test_zoo_pulls_in_no_jax(family):
    """Each model family of the zoo, the transformer layers and the MoE
    layer alone: built on the CPU and run (generate, a loss, a backward)
    with neither JAX nor the reference imported."""
    code = ("import sys\n" + _ZOO[family]
            + "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'jaxlib')) or k == 'paddle_tpu' or "
            "k.startswith('paddle_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_zoo_refuses_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    from paddle_tpu_torch import models
    for cls, cfg in ((models.GPTForCausalLM, models.gpt_tiny()),
                     (models.BertModel, models.bert_tiny()),
                     (models.T5ForConditionalGeneration, models.t5_tiny()),
                     (models.MixtralForCausalLM, models.mixtral_tiny())):
        with pytest.raises(RuntimeError):
            cls(cfg)
