"""The port stands alone: it imports neither JAX nor ``paddle_tpu``, and
its entry points never fall back to the CPU unasked."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_workers.py"]


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
    "vision_ops": "import paddle_tpu_torch as p\n"
                  "p.set_device('cpu')\n"
                  "import torch\n"
                  "from paddle_tpu_torch.vision import ops\n"
                  "b = torch.tensor([[0., 0, 4, 4], [1, 1, 5, 5]])\n"
                  "ops.nms(b, 0.1, scores=torch.tensor([1., 2]))\n"
                  "ops.roi_align(torch.ones(1, 2, 8, 8), b,\n"
                  "              torch.tensor([2]), 2)\n",
    "ppyoloe": "import paddle_tpu_torch as p\n"
               "p.set_device('cpu')\n"
               "import torch\n"
               "from paddle_tpu_torch.models import ppyoloe as m\n"
               "net = m.ppyoloe_lite(num_classes=4)\n"
               "net.predict(torch.ones(1, 3, 64, 64), score_thresh=0.3)\n",
    "vision_zoo": "import paddle_tpu_torch as p\n"
                  "p.set_device('cpu')\n"
                  "import torch\n"
                  "from paddle_tpu_torch.vision.models import (lenet, vit,\n"
                  "    vgg, mobilenet, extras, inception)\n"
                  "lenet.LeNet()(torch.ones(1, 1, 28, 28))\n"
                  "vit.VisionTransformer(img_size=32, patch_size=8,\n"
                  "    embed_dim=64, depth=1, num_heads=1)(\n"
                  "    torch.ones(1, 3, 32, 32)).sum().backward()\n",
    "rnn_extras": "import paddle_tpu_torch as p\n"
                  "p.set_device('cpu')\n"
                  "import torch\n"
                  "from paddle_tpu_torch.nn.layers import rnn, extras\n"
                  "rnn.LSTM(4, 8, 2, direction='bidirect')(\n"
                  "    torch.ones(2, 3, 4))[0].sum().backward()\n"
                  "extras.MaxPool3D(2)(torch.ones(1, 1, 4, 4, 4))\n",
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


def test_vision_and_rnn_refuse_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    dev = core.get_device()
    pt.set_device("gpu")
    try:
        for build in (lambda: pt.models.ppyoloe_lite(),
                      lambda: pt.vision.models.vit_base_patch16_224(),
                      lambda: pt.nn.LSTM(16, 32)):
            with pytest.raises(RuntimeError):
                build()
    finally:
        pt.set_device(dev)


_RNG = np.random.default_rng(22)
_BOXES = np.array([[0., 0, 4, 4], [1, 1, 5, 5]], np.float32)
_ARRAY_CALLS = {
    "box_area": lambda ops: ops.box_area(_BOXES),
    "box_iou": lambda ops: ops.box_iou(_BOXES, _BOXES),
    "nms": lambda ops: ops.nms(_BOXES, 0.1, scores=np.array([1., 2.])),
    "distance2bbox": lambda ops: ops.distance2bbox(_BOXES[:, :2], _BOXES),
    "roi_align": lambda ops: ops.roi_align(
        np.ones((1, 2, 8, 8), np.float32), _BOXES, np.array([2]), 2),
    "roi_pool": lambda ops: ops.roi_pool(
        np.ones((1, 2, 8, 8), np.float32), _BOXES, np.array([2]), 2),
    "ps_roi_pool": lambda ops: ops.ps_roi_pool(
        np.ones((1, 8, 8, 8), np.float32), _BOXES, np.array([2]), 2),
    "yolo_box": lambda ops: ops.yolo_box(
        _RNG.standard_normal((1, 14, 2, 2)).astype(np.float32),
        np.array([[64, 64]]), [10, 13, 16, 30], 2),
    "deform_conv2d": lambda ops: ops.deform_conv2d(
        np.ones((1, 2, 4, 4), np.float32),
        np.zeros((1, 18, 2, 2), np.float32),
        np.ones((3, 2, 3, 3), np.float32)),
    "matrix_nms": lambda ops: ops.matrix_nms(
        _BOXES, np.array([[0.9, 0.8]], np.float32), 0.1, 0.1, 2, 2),
    "prior_box": lambda ops: ops.prior_box(
        np.ones((1, 2, 4, 4), np.float32), np.ones((1, 3, 32, 32)), [8.]),
    "distribute_fpn_proposals": lambda ops: ops.distribute_fpn_proposals(
        _BOXES * 40, 2, 5, 4, 224),
}


@pytest.mark.parametrize("name", sorted(_ARRAY_CALLS))
def test_vision_ops_put_arrays_on_the_current_device(name):
    """A numpy input lands on the current device, as ``to_tensor`` puts
    it: the CPU when asked, else the card, which is refused without
    CUDA rather than run on the CPU."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.vision import ops
    dev = core.get_device()
    try:
        pt.set_device("cpu")
        out = _ARRAY_CALLS[name](ops)
        first = out[0] if isinstance(out, (tuple, list)) else out
        first = first[0] if isinstance(first, list) else first
        assert first.device.type == "cpu"
        if not torch.cuda.is_available():
            pt.set_device("gpu")
            with pytest.raises(RuntimeError):
                _ARRAY_CALLS[name](ops)
    finally:
        pt.set_device(dev)


def test_chip_smoke_defines_each_top_level_name_once():
    """A second ``def`` of a name in ``chip_smoke.py`` would silently
    replace the first for every phase that calls it."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert sorted(n for n in set(names) if names.count(n) > 1) == []


_DATA_LIBS = {
    "pretrained": "import json, os, tempfile, torch\n"
                  "from paddle_tpu_torch.models import pretrained, llama\n"
                  "d = tempfile.mkdtemp()\n"
                  "m = llama.LlamaForCausalLM(llama.llama_tiny(), "
                  "device='cpu')\n"
                  "torch.save({('model.' + k[6:] if k.startswith('llama.')"
                  " else k): v for k, v in m.state_dict().items()},\n"
                  "           os.path.join(d, 'pytorch_model.bin'))\n"
                  "json.dump(dict(vocab_size=128, hidden_size=64,\n"
                  "    intermediate_size=176, num_hidden_layers=2,\n"
                  "    num_attention_heads=4, num_key_value_heads=2),\n"
                  "    open(os.path.join(d, 'config.json'), 'w'))\n"
                  "n = llama.LlamaForCausalLM.from_pretrained(d, "
                  "device='cpu')\n"
                  "assert torch.equal(n([[1, 2]]), m([[1, 2]]))\n",
    "fft_signal": "import torch\n"
                  "from paddle_tpu_torch import fft, signal\n"
                  "x = torch.randn(2, 256)\n"
                  "fft.hfftn(fft.rfft2(x))\n"
                  "signal.istft(signal.stft(x, 64), 64)\n",
    "audio": "import torch\n"
             "from paddle_tpu_torch import audio\n"
             "audio.MFCC(sr=16000)(torch.randn(1, 4000))\n",
    "text": "import torch\n"
            "from paddle_tpu_torch import text\n"
            "text.viterbi_decode(torch.randn(2, 5, 3), torch.randn(5, 5))\n"
            "text.UCIHousing(synthetic=4)[0]\n",
    "vision_data": "import numpy as np\n"
                   "from paddle_tpu_torch.vision import datasets, "
                   "transforms as T\n"
                   "ds = datasets.FakeData(size=2, transform=T.Compose([\n"
                   "    T.RandomResizedCrop(16), T.ToTensor()]))\n"
                   "ds[0]\n",
}


@pytest.mark.parametrize("lib", sorted(_DATA_LIBS))
def test_data_libraries_pull_in_no_jax(lib):
    """``models.pretrained``, ``fft``, ``signal``, ``audio``, ``text``,
    ``vision.datasets`` and ``vision.transforms`` alone, each run on the
    CPU with neither JAX nor the reference imported."""
    code = ("import sys\n" + _DATA_LIBS[lib]
            + "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'jaxlib')) or k == 'paddle_tpu' or "
            "k.startswith('paddle_tpu.') or k == 'safetensors' or "
            "k.startswith('safetensors.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_from_pretrained_refuses_cpu_without_being_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    import paddle_tpu_torch as pt
    with pytest.raises(RuntimeError):
        pt.LlamaForCausalLM.from_pretrained(str(tmp_path))
    with pytest.raises(RuntimeError):
        pt.models.T5ForConditionalGeneration.from_pretrained(str(tmp_path))


def test_transforms_and_datasets_leave_cuda_uninitialised(tmp_path):
    """The data pipeline runs in ``DataLoader`` workers, which must not
    touch CUDA: every transform and a dataset through a worker, then
    ``torch.cuda.is_initialized()`` is still False."""
    code = (
        "import numpy as np, torch\n"
        "import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch import audio, text\n"
        "from paddle_tpu_torch.vision import datasets, transforms as T\n"
        "pt.set_device('cpu')\n"
        "img = (np.random.rand(20, 18, 3) * 255).astype(np.uint8)\n"
        "for t in [T.RandomCrop(12, padding=2), T.CenterCrop(8),\n"
        "          T.RandomHorizontalFlip(1.0), T.RandomVerticalFlip(1.0),\n"
        "          T.RandomResizedCrop(10), T.Resize(7), T.Transpose(),\n"
        "          T.BrightnessTransform(0.2), T.ContrastTransform(0.2),\n"
        "          T.SaturationTransform(0.2), T.HueTransform(0.1),\n"
        "          T.ColorJitter(0.1, 0.1, 0.1, 0.1), T.Grayscale(),\n"
        "          T.Pad(2), T.RandomRotation(10), T.RandomErasing(1.0),\n"
        "          T.GaussianBlur(3), T.RandomAffine(5),\n"
        "          T.RandomPerspective(1.0), T.ToTensor(),\n"
        "          T.Compose([T.ToTensor(), T.Normalize(0.5, 0.5)])]:\n"
        "    t(img)\n"
        "ds = datasets.FakeData(size=8, transform=T.Compose([\n"
        "    T.RandomCrop(32, padding=4), T.ToTensor()]))\n"
        "for x, y in pt.io.DataLoader(ds, batch_size=4, num_workers=2):\n"
        "    assert x.shape == (4, 3, 32, 32)\n"
        "text.UCIHousing(synthetic=3)[0]\n"
        "audio.Spectrogram(n_fft=64)(torch.randn(1, 400))\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _binds_mesh_fixture(tree):
    """Whether the file defines ``_no_reference_mesh`` or imports it at
    its top level: the fixture is autouse, so bound in a module it runs
    before every test there (and fixtures that request it by name run
    after it)."""
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and \
                node.name == "_no_reference_mesh":
            return True
        if isinstance(node, ast.ImportFrom) and any(
                a.name == "_no_reference_mesh" for a in node.names):
            return True
    return False


def test_reference_model_files_clear_the_reference_mesh():
    """Every port test file that imports the reference's models or its
    distributed package runs them without the global mesh a JAX test
    earlier in its worker may leave installed (ROADMAP C28, C48): the
    file binds the autouse fixture ``_no_reference_mesh`` of
    ``tests/test_torch_llama.py``."""
    trees = {f.name: ast.parse(f.read_text())
             for f in sorted((ROOT / "tests").glob("test_torch_*.py"))}
    users = [n for n, t in trees.items() if _imports_reference_models(t)]
    assert len(users) >= 30
    assert [n for n in users if not _binds_mesh_fixture(trees[n])] == []


def _imports_reference_models(tree):
    """Whether the file imports the reference's ``models`` or
    ``distributed`` (whose ``fleet.init`` installs a global mesh)."""
    mods = ("paddle_tpu.models", "paddle_tpu.distributed")
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module.startswith(mods)
                or (node.module == "paddle_tpu"
                    and any(a.name in ("models", "distributed")
                            for a in node.names))):
            return True
        if isinstance(node, ast.Import) and any(
                a.name.startswith(mods) for a in node.names):
            return True
    return False


_SLICE_7B = {
    "paddle_tpu_torch.geometric":
        "from paddle_tpu_torch import geometric as G\n"
        "x = torch.randn(4, 3, requires_grad=True)\n"
        "G.send_u_recv(x, [0, 1, 2], [1, 1, 3], 'max').sum().backward()\n"
        "G.segment_mean(x, torch.tensor([0, 0, 2, 2]))\n",
    "paddle_tpu_torch.sparse":
        "from paddle_tpu_torch import sparse as S\n"
        "a = S.sparse_coo_tensor([[0, 1], [1, 0]], [1.0, 2.0], [2, 2])\n"
        "S.matmul(a.to_sparse_csr(), torch.ones(2, 3))\n"
        "S.softmax(S.add(a, a))\n"
        "S.nn.SubmConv3D(1, 2, 3, padding=1)(S.sparse_coo_tensor(\n"
        "    [[0], [1], [1], [1], [0]], [1.0], [1, 3, 3, 3, 1]))\n",
    "paddle_tpu_torch.distribution":
        "from paddle_tpu_torch import distribution as D\n"
        "n = D.Normal(torch.zeros(3), torch.ones(3))\n"
        "D.kl_divergence(n, D.Normal(1.0, 2.0))\n"
        "D.TransformedDistribution(n, [D.TanhTransform()]).rsample((2,))\n"
        "D.Gamma(2.0, 1.0).rsample((4,))\n",
    "paddle_tpu_torch.incubate":
        "from paddle_tpu_torch import incubate as I\n"
        "I.softmax_mask_fuse_upper_triangle(torch.randn(1, 2, 4, 4))\n"
        "I.graph_send_recv(torch.randn(3, 2), [0, 1], [1, 2])\n",
}


@pytest.mark.parametrize("module", sorted(_SLICE_7B))
def test_slice_7b_modules_pull_in_no_jax_and_leave_cuda_alone(module):
    """``geometric``, ``sparse``, ``distribution`` and ``incubate``'s
    functions alone: importing one initialises no CUDA, and a few of its
    calls on the CPU pull in neither JAX nor the reference."""
    code = ("import sys, importlib, torch\n"
            f"importlib.import_module({module!r})\n"
            "assert not torch.cuda.is_initialized()\n"
            "import paddle_tpu_torch as pt\n"
            "pt.set_device('cpu')\n" + _SLICE_7B[module]
            + "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'jaxlib')) or k == 'paddle_tpu' or "
            "k.startswith('paddle_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_SLICE_8A = {
    "paddle_tpu_torch.distributed":
        "import paddle_tpu_torch.distributed as dist\n"
        "t = torch.ones(3)\n"
        "dist.all_reduce(t)\n"
        "dist.fleet.DistributedStrategy().to_dict()\n"
        "dist.comm.quantize_blockwise(torch.randn(300), 64)\n",
    "paddle_tpu_torch.distributed.fleet":
        "from paddle_tpu_torch.distributed import fleet\n"
        "fleet.CommunicateTopology(dims=[2, 1, 1, 1, 2]).get_comm_list("
        "'model')\n",
    "paddle_tpu_torch.autograd.callbacks":
        "from paddle_tpu_torch.autograd import callbacks\n"
        "w = torch.nn.Parameter(torch.ones(2))\n"
        "callbacks.register_grad_ready_callback(print, [w])\n"
        "(w * 2).sum().backward()\n",
    "torch_dist_workers":
        "sys.path.insert(0, 'tests')\n"
        "import torch_dist_workers\n",
}


@pytest.mark.parametrize("module", sorted(_SLICE_8A))
def test_slice_8a_modules_pull_in_no_jax_and_leave_cuda_alone(module):
    """``distributed``, its ``fleet``, the autograd callbacks and the
    distributed tests' rank functions alone: no CUDA initialised, and
    neither JAX nor the reference imported (a spawned rank imports the
    module of its function)."""
    code = ("import sys, torch\n" + _SLICE_8A[module]
            + "assert not torch.cuda.is_initialized()\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'jaxlib')) or k == 'paddle_tpu' or "
            "k.startswith('paddle_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
