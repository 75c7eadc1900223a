"""The port's ``vision.transforms`` (``paddle_tpu_torch/vision/transforms``)
against the reference's (``paddle_tpu/vision/transforms``) on the CPU:
every transform under the same numpy seed (``np.random.seed`` right
before each side) gives the reference's output, and ``Resize`` is
``jax.image.resize`` at up- and downscale for each interpolation.

``Resize``'s rule: float images within 1e-5 of the largest magnitude
(the separable weights are summed in another order than XLA's einsum);
uint8 images equal, but where the reference's float value lies within
1e-3 of an integer, where truncation may fall either side (one level)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.vision import transforms as J

from paddle_tpu_torch.vision import transforms as T
from torch_zoo_common import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _setup(one_torch_thread):  # noqa: F811
    yield


def _img(seed, shape=(24, 20, 3), dtype=np.uint8):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * 255).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else np.asarray(x)


def both(make, img, seed=7):
    """``make(module)`` applied by each package after the same seed."""
    np.random.seed(seed)
    got = make(T)(img)
    np.random.seed(seed)
    want = make(J)(img)
    return got, want


def same(got, want, what):
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype,
                                                       w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


SEEDED = {
    "RandomCrop": lambda m: m.RandomCrop(16, padding=4),
    "RandomCrop-pad2": lambda m: m.RandomCrop((18, 14), padding=(2, 3)),
    "CenterCrop": lambda m: m.CenterCrop(12),
    "RandomHorizontalFlip": lambda m: m.RandomHorizontalFlip(0.5),
    "RandomVerticalFlip": lambda m: m.RandomVerticalFlip(0.5),
    "RandomResizedCrop": lambda m: m.RandomResizedCrop(16),
    "Transpose": lambda m: m.Transpose(),
    "BrightnessTransform": lambda m: m.BrightnessTransform(0.4),
    "ContrastTransform": lambda m: m.ContrastTransform(0.4),
    "SaturationTransform": lambda m: m.SaturationTransform(0.5),
    "HueTransform": lambda m: m.HueTransform(0.3),
    "ColorJitter": lambda m: m.ColorJitter(0.3, 0.3, 0.3, 0.1),
    "Grayscale": lambda m: m.Grayscale(3),
    "Pad": lambda m: m.Pad((1, 2, 3, 4), fill=9),
    "RandomRotation": lambda m: m.RandomRotation(30),
    "RandomRotation-bilinear": lambda m: m.RandomRotation(
        45, "bilinear", expand=True, fill=3),
    "RandomErasing": lambda m: m.RandomErasing(1.0, value="random"),
    "GaussianBlur": lambda m: m.GaussianBlur(5, (0.5, 1.5)),
    "RandomAffine": lambda m: m.RandomAffine(
        20, translate=(0.1, 0.2), scale=(0.8, 1.2), shear=(-5, 5, -3, 3),
        interpolation="bilinear"),
    "RandomPerspective": lambda m: m.RandomPerspective(1.0, 0.4),
    "Normalize-HWC": lambda m: m.Normalize([10, 20, 30], [2, 3, 4],
                                           data_format="HWC"),
}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_transform_matches_reference(name):
    for draw in range(3):
        if name == "RandomResizedCrop":
            # the crop's draws equal; its Resize on a float image by
            # Resize's rule (test_resize_is_jax_image_resize)
            img = _img(draw, dtype=np.float32)
            got, want = both(SEEDED[name], img, seed=11 + draw)
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
            continue
        img = _img(draw)
        got, want = both(SEEDED[name], img, seed=11 + draw)
        same(got, want, f"{name} draw {draw}")


def test_to_tensor_normalize_and_functional_forms():
    img = _img(3)
    t = T.ToTensor()(img)
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    same(t, J.ToTensor()(img), "ToTensor")
    norm = T.Normalize([0.5, 0.4, 0.3], [0.2, 0.25, 0.3])(t)
    assert isinstance(norm, torch.Tensor)
    same(norm, J.Normalize([0.5, 0.4, 0.3], [0.2, 0.25, 0.3])(
        J.ToTensor()(img)), "Normalize of a tensor")
    for name, args in (("hflip", ()), ("vflip", ()), ("crop", (2, 3, 9, 7)),
                       ("center_crop", (10,)), ("pad", (2,)),
                       ("to_tensor", ()), ("resize", ((12, 9),))):
        same(getattr(T, name)(img, *args), getattr(J, name)(img, *args),
             name)
    gray = _img(4, (10, 8))
    same(T.ToTensor()(gray), J.ToTensor()(gray), "ToTensor of HW")
    got, want = both(lambda m: m.Compose([
        m.RandomCrop(6), m.RandomHorizontalFlip(), m.ToTensor(),
        m.Normalize(0.5, 0.5)]), gray[..., None])
    same(got, want, "Compose")


@pytest.mark.parametrize("interp,method", [("bilinear", "linear"),
                                           ("nearest", "nearest"),
                                           ("bicubic", "cubic")])
@pytest.mark.parametrize("size", [(11, 8), (53, 37), (24, 41), (9, 20)],
                         ids=["down", "up", "mixed-a", "mixed-b"])
def test_resize_is_jax_image_resize(interp, method, size):
    for dtype in (np.float32, np.uint8):
        img = _img(5, dtype=dtype)
        got = T.Resize(size, interp)(img)
        want = J.Resize(size, interp)(img)
        assert got.dtype == want.dtype == dtype and got.shape == want.shape
        exact = np.asarray(jax.image.resize(
            jnp.asarray(img, jnp.float32), size + (3,), method))
        if dtype == np.float32:
            err = np.abs(got - want).max() / np.abs(want).max()
            print(f"Resize {interp} {size}: worst error {err:.3g}")
            assert err <= 1e-5
        else:
            diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
            near = np.abs(exact - np.round(exact)) < 1e-3
            assert diff.max() <= 1 and not (diff.astype(bool) & ~near).any()
    gray = _img(6, (16, 13))
    assert T.Resize(size, interp)(gray).shape == size
    np.testing.assert_allclose(
        T._resize_array(_img(7, dtype=np.float32), size, method),
        np.asarray(jax.image.resize(jnp.asarray(_img(7, dtype=np.float32)),
                                    size + (3,), method)),
        rtol=0, atol=1e-5 * 255)
