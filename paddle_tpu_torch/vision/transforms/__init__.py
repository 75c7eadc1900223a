"""``paddle.vision.transforms`` (port of
``paddle_tpu/vision/transforms/__init__.py``): HWC numpy preprocessing,
every class and function of the reference from ``Compose`` to
``RandomPerspective``.

The transforms are host code, as Paddle's are: numpy in and out, and
``ToTensor`` / ``Normalize`` of a tensor give CPU tensors. They run in
``DataLoader`` workers and never touch CUDA (a forked worker that
initialised CUDA would fail); the loader places the batches on the card.
The random transforms draw from numpy's global state in the reference's
order (``np.random.randint``, ``rand``, ``uniform``), so under one
``np.random.seed`` a crop or flip is the reference's.

``Resize`` is the reference's ``jax.image.resize`` in numpy
(:func:`_resize_array`): half-pixel centres, separable weights, the
kernel widened by the scale when downsampling (antialiasing), Keys'
cubic with ``a = -0.5``; nearest takes ``floor((i + 0.5) in / out)``.
Neither ``torch.nn.functional.interpolate``'s bilinear nor its bicubic
(``a = -0.75``) is that function.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


def _inverse_warp(arr, ys, xs, interpolation="nearest", fill=0,
                  out_shape=None):
    """Sample ``arr`` (HWC or HW numpy) at source coordinates (ys, xs) —
    the shared inverse-map warp behind RandomRotation / RandomAffine /
    RandomPerspective. Out-of-bounds pixels get ``fill``."""
    h, w = arr.shape[:2]
    shape = ((out_shape or ys.shape) + arr.shape[2:])

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        src = arr.astype(np.float32)[np.clip(yi, 0, h - 1),
                                     np.clip(xi, 0, w - 1)]
        m = inb[..., None] if arr.ndim == 3 else inb
        return np.where(m, src, float(fill))

    if interpolation == "nearest":
        out = gather(np.round(ys).astype(np.int64),
                     np.round(xs).astype(np.int64))
    else:
        y0 = np.floor(ys).astype(np.int64)
        x0 = np.floor(xs).astype(np.int64)
        wy = (ys - y0)[..., None] if arr.ndim == 3 else ys - y0
        wx = (xs - x0)[..., None] if arr.ndim == 3 else xs - x0
        out = (gather(y0, x0) * (1 - wy) * (1 - wx)
               + gather(y0, x0 + 1) * (1 - wy) * wx
               + gather(y0 + 1, x0) * wy * (1 - wx)
               + gather(y0 + 1, x0 + 1) * wy * wx)
    out = out.reshape(shape)
    if arr.dtype == np.uint8:
        out = np.clip(out, 0, 255).astype(np.uint8)
    return out


def _to_hwc_array(img):
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


class ToTensor(BaseTransform):
    """HWC uint8 [0, 255] -> a CHW float32 [0, 1] CPU tensor."""

    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        arr = arr.astype(np.float32)
        if arr.max() > 1.0 + 1e-6 or arr.dtype == np.uint8:
            arr = arr / 255.0
        if self.data_format == "CHW":
            arr = np.transpose(arr, (2, 0, 1))
        return torch.from_numpy(np.ascontiguousarray(arr))


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        super().__init__(keys)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        is_tensor = isinstance(img, torch.Tensor)
        arr = _to_hwc_array(img) if is_tensor else np.asarray(img, np.float32)
        shape = [-1, 1, 1] if self.data_format == "CHW" else [1, 1, -1]
        arr = (arr - self.mean.reshape(shape)) / self.std.reshape(shape)
        arr = arr.astype(np.float32)
        return torch.from_numpy(arr) if is_tensor else arr


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _triangle(x):
    return np.maximum(np.float32(0), 1 - np.abs(x)).astype(np.float32)


def _weight_mat(in_size, out_size, kernel):
    """``[in_size, out_size]`` float32 weights of the separable resize
    (``jax.image.resize``'s ``compute_weight_mat`` with scale ``out / in``
    and no translation, antialiased)."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[
        :, None]) / kernel_scale
    w = kernel(x)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1)),
                 np.float32(0)).astype(np.float32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0)).astype(np.float32)


def _resize_array(arr, size, method="linear"):
    """``arr`` ([H, W, C], any dtype) resized to ``size`` (H, W) in
    float32, as ``jax.image.resize(arr, (H, W, C), method)`` computes it:
    ``method`` ``"linear"``, ``"cubic"`` or ``"nearest"``."""
    out = np.asarray(arr, np.float32)
    for axis, n in enumerate(size):
        m = out.shape[axis]
        if m == n:
            continue
        if method == "nearest":
            idx = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                           * np.float32(m) / np.float32(n)).astype(np.int32)
            out = np.take(out, idx, axis=axis)
            continue
        kernel = _keys_cubic if method == "cubic" else _triangle
        w = _weight_mat(m, n, kernel)
        out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1,
                          axis).astype(np.float32)
    return out


class Resize(BaseTransform):
    """Resize to ``size`` (an int for a square): ``"bilinear"``,
    ``"nearest"`` or ``"bicubic"`` (:func:`_resize_array`); a uint8 image
    is clipped and truncated back to uint8."""

    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        squeeze = arr.ndim == 2
        if squeeze:
            arr = arr[:, :, None]
        method = {"bilinear": "linear", "nearest": "nearest",
                  "bicubic": "cubic"}.get(self.interpolation, "linear")
        out = _resize_array(arr, self.size, method)
        if arr.dtype == np.uint8:
            out = np.clip(out, 0, 255).astype(np.uint8)
        return out[:, :, 0] if squeeze else out


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        if self.padding:
            p = self.padding if isinstance(self.padding, (list, tuple)) \
                else (self.padding,) * 4
            if len(p) == 2:
                p = (p[0], p[1], p[0], p[1])
            pads = [(p[1], p[3]), (p[0], p[2])] + [(0, 0)] * (arr.ndim - 2)
            arr = np.pad(arr, pads)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return arr[i:i + th, j:j + tw]


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return arr[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return np.ascontiguousarray(_to_hwc_array(img)[:, ::-1])
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return np.ascontiguousarray(_to_hwc_array(img)[::-1])
        return img


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self._resize = Resize(self.size, interpolation)

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            tw = int(round(np.sqrt(target * ar)))
            th = int(round(np.sqrt(target / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = np.random.randint(0, h - th + 1)
                j = np.random.randint(0, w - tw + 1)
                return self._resize(arr[i:i + th, j:j + tw])
        return self._resize(CenterCrop(min(h, w))(arr))


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return np.transpose(arr, self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        arr = _to_hwc_array(img).astype(np.float32)
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return np.clip(arr * f, 0, 255).astype(np.uint8)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, keys=None):
        super().__init__(keys)
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def _apply_image(self, img):
        arr = _to_hwc_array(img).astype(np.float32)
        if self.brightness:
            arr = arr * np.random.uniform(max(0, 1 - self.brightness),
                                          1 + self.brightness)
        if self.contrast:
            mean = arr.mean()
            arr = (arr - mean) * np.random.uniform(max(0, 1 - self.contrast),
                                                   1 + self.contrast) + mean
        if (self.saturation or self.hue) and arr.ndim == 3 \
                and arr.shape[-1] == 3:
            hsv = _rgb_to_hsv(np.clip(arr, 0, 255) / 255.0)
            if self.saturation:
                f = np.random.uniform(max(0, 1 - self.saturation),
                                      1 + self.saturation)
                hsv[..., 1] = np.clip(hsv[..., 1] * f, 0, 1)
            if self.hue:
                hsv[..., 0] = (hsv[..., 0]
                               + np.random.uniform(-self.hue, self.hue)) % 1.0
            arr = _hsv_to_rgb(hsv) * 255.0
        return np.clip(arr, 0, 255).astype(np.uint8)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        p = padding if isinstance(padding, (list, tuple)) else (padding,) * 4
        if len(p) == 2:
            p = (p[0], p[1], p[0], p[1])
        self.p = p
        self.fill = fill

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        pads = [(self.p[1], self.p[3]), (self.p[0], self.p[2])] + \
            [(0, 0)] * (arr.ndim - 2)
        return np.pad(arr, pads, constant_values=self.fill)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return np.ascontiguousarray(_to_hwc_array(img)[:, ::-1])


def vflip(img):
    return np.ascontiguousarray(_to_hwc_array(img)[::-1])


def crop(img, top, left, height, width):
    return _to_hwc_array(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


def pad(img, padding, fill=0, padding_mode="constant"):
    return Pad(padding, fill, padding_mode)(img)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        arr = _to_hwc_array(img).astype(np.float32)
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        mean = arr.mean()
        return np.clip((arr - mean) * f + mean, 0, 255).astype(np.uint8)


def _rgb_to_hsv(arr):
    """arr float [H, W, 3] in [0, 1] -> hsv same shape."""
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    mx = arr.max(-1)
    mn = arr.min(-1)
    diff = mx - mn + 1e-12
    h = np.zeros_like(mx)
    h = np.where(mx == r, (g - b) / diff % 6.0, h)
    h = np.where(mx == g, (b - r) / diff + 2.0, h)
    h = np.where(mx == b, (r - g) / diff + 4.0, h)
    h = h / 6.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    return np.stack([h, s, mx], -1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = np.floor(h).astype(np.int32) % 6
    f = h - np.floor(h)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    out = np.select(
        [(i == 0)[..., None], (i == 1)[..., None], (i == 2)[..., None],
         (i == 3)[..., None], (i == 4)[..., None], (i == 5)[..., None]],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return out


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            return arr            # grayscale has no saturation
        arr = arr.astype(np.float32) / 255.0
        hsv = _rgb_to_hsv(arr)
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        hsv[..., 1] = np.clip(hsv[..., 1] * f, 0, 1)
        return np.clip(_hsv_to_rgb(hsv) * 255.0, 0, 255).astype(np.uint8)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value          # in [0, 0.5]

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            return arr            # grayscale has no hue
        arr = arr.astype(np.float32) / 255.0
        hsv = _rgb_to_hsv(arr)
        shift = np.random.uniform(-self.value, self.value)
        hsv[..., 0] = (hsv[..., 0] + shift) % 1.0
        return np.clip(_hsv_to_rgb(hsv) * 255.0, 0, 255).astype(np.uint8)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.n = num_output_channels

    def _apply_image(self, img):
        arr = _to_hwc_array(img).astype(np.float32)
        if arr.ndim == 2:
            g = arr               # already single-channel
        elif arr.shape[-1] == 1:
            g = arr[..., 0]
        else:
            g = (0.299 * arr[..., 0] + 0.587 * arr[..., 1]
                 + 0.114 * arr[..., 2])
        out = np.repeat(g[..., None], self.n, axis=-1)
        return np.clip(out, 0, 255).astype(np.uint8)


class RandomRotation(BaseTransform):
    """Rotation by a uniform angle in ``degrees`` — supports nearest and
    bilinear interpolation, custom ``center``, and ``expand`` (canvas
    grows to fit the rotated image); no scipy dependency."""

    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, (int, float)):
            degrees = (-float(degrees), float(degrees))
        if interpolation not in ("nearest", "bilinear"):
            raise NotImplementedError(
                f"RandomRotation: interpolation {interpolation!r} "
                "unsupported (nearest/bilinear)")
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        h, w = arr.shape[:2]
        ang = np.deg2rad(np.random.uniform(*self.degrees))
        if self.center is not None:
            cx, cy = float(self.center[0]), float(self.center[1])
        else:
            cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        if self.expand:
            # output canvas bounding the rotated input rectangle
            oh = int(np.ceil(abs(h * np.cos(ang)) + abs(w * np.sin(ang))))
            ow = int(np.ceil(abs(h * np.sin(ang)) + abs(w * np.cos(ang))))
            ocy, ocx = (oh - 1) / 2.0, (ow - 1) / 2.0
        else:
            oh, ow, ocy, ocx = h, w, cy, cx
        yy, xx = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
        # inverse map: output pixel -> source coordinate
        ys = cy + (yy - ocy) * np.cos(ang) - (xx - ocx) * np.sin(ang)
        xs = cx + (yy - ocy) * np.sin(ang) + (xx - ocx) * np.cos(ang)
        return _inverse_warp(arr, ys, xs, self.interpolation, self.fill,
                             out_shape=(oh, ow))


class RandomErasing(BaseTransform):
    """Randomly erase a rectangle (reference:
    ``paddle.vision.transforms.RandomErasing``). Operates on tensors or
    HWC arrays; ``value`` may be a float, per-channel sequence, or
    'random'."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace

    def _apply_image(self, img):
        if np.random.uniform() >= self.prob:
            return img
        arr = _to_hwc_array(img)
        if not (self.inplace and isinstance(img, np.ndarray)):
            arr = arr.copy()
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = np.random.uniform(*self.scale) * area
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w and eh > 0 and ew > 0:
                y = np.random.randint(0, h - eh + 1)
                x = np.random.randint(0, w - ew + 1)
                c = arr.shape[2] if arr.ndim == 3 else 1
                if isinstance(self.value, str) and self.value == "random":
                    patch = np.random.standard_normal((eh, ew, c))
                else:
                    patch = np.broadcast_to(
                        np.asarray(self.value, np.float32), (eh, ew, c))
                patch = patch.reshape((eh, ew, c) if arr.ndim == 3
                                      else (eh, ew))
                if arr.dtype == np.uint8:
                    patch = np.clip(patch, 0, 255).astype(np.uint8)
                arr[y:y + eh, x:x + ew] = patch
                break
        return arr


class GaussianBlur(BaseTransform):
    """Separable Gaussian blur (reference:
    ``paddle.vision.transforms.GaussianBlur``); sigma drawn uniformly
    from the given range per call."""

    def __init__(self, kernel_size=3, sigma=(0.1, 2.0), keys=None):
        super().__init__(keys)
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size, kernel_size)
        if isinstance(sigma, (int, float)):
            sigma = (float(sigma), float(sigma))
        self.kernel_size = kernel_size
        self.sigma = sigma

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        dtype = arr.dtype
        out = arr.astype(np.float32)
        sig = np.random.uniform(*self.sigma)

        def kernel(k):
            r = np.arange(k) - (k - 1) / 2.0
            g = np.exp(-(r ** 2) / (2 * sig * sig))
            return g / g.sum()

        kx, ky = kernel(self.kernel_size[0]), kernel(self.kernel_size[1])
        # reflect-pad + correlate along each axis
        py, px = len(ky) // 2, len(kx) // 2
        if out.ndim == 2:
            out = out[..., None]
        pad = np.pad(out, ((py, py), (0, 0), (0, 0)), mode="reflect")
        out = sum(pad[i:i + out.shape[0]] * ky[i]
                  for i in range(len(ky)))
        pad = np.pad(out, ((0, 0), (px, px), (0, 0)), mode="reflect")
        out = sum(pad[:, i:i + out.shape[1]] * kx[i]
                  for i in range(len(kx)))
        out = out.reshape(arr.shape)
        if dtype == np.uint8:
            out = np.clip(np.round(out), 0, 255).astype(np.uint8)
        return out


class RandomAffine(BaseTransform):
    """Random affine (rotation, translation, scale, shear) via the shared
    inverse-map warp (reference: ``paddle.vision.transforms.RandomAffine``)."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        if isinstance(degrees, (int, float)):
            degrees = (-float(degrees), float(degrees))
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.interpolation = interpolation
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        h, w = arr.shape[:2]
        ang = np.deg2rad(np.random.uniform(*self.degrees))
        tx = ty = 0.0
        if self.translate is not None:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * w
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * h
        sc = np.random.uniform(*self.scale) if self.scale else 1.0
        shx = shy = 0.0
        if self.shear is not None:
            sh = self.shear
            if isinstance(sh, (int, float)):
                sh = (-float(sh), float(sh))
            shx = np.deg2rad(np.random.uniform(sh[0], sh[1]))
            if len(sh) == 4:
                shy = np.deg2rad(np.random.uniform(sh[2], sh[3]))
        if self.center is not None:
            cx, cy = float(self.center[0]), float(self.center[1])
        else:
            cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        # forward matrix M = T(center+t) @ R(ang) @ Shear @ S(sc) @ T(-center)
        cos, sin = np.cos(ang), np.sin(ang)
        rs = np.array([[cos, -sin], [sin, cos]]) @ \
            np.array([[1.0, np.tan(shx)], [np.tan(shy), 1.0]]) * sc
        inv = np.linalg.inv(rs)
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        dx = xx - cx - tx
        dy = yy - cy - ty
        xs = cx + inv[0, 0] * dx + inv[0, 1] * dy
        ys = cy + inv[1, 0] * dx + inv[1, 1] * dy
        return _inverse_warp(arr, ys, xs, self.interpolation, self.fill)


class RandomPerspective(BaseTransform):
    """Random four-point perspective warp (reference:
    ``paddle.vision.transforms.RandomPerspective``)."""

    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.interpolation = interpolation
        self.fill = fill

    def _apply_image(self, img):
        if np.random.uniform() >= self.prob:
            return img
        arr = _to_hwc_array(img)
        h, w = arr.shape[:2]
        d = self.distortion_scale
        dx, dy = w * d / 2, h * d / 2
        src = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                       np.float64)
        # inward-only corner jitter (reference semantics): the warped
        # quad stays convex, so the homography is always well-posed
        ox = np.random.uniform(0, max(dx, 1e-9), 4)
        oy = np.random.uniform(0, max(dy, 1e-9), 4)
        if d == 0:
            ox = oy = np.zeros(4)
        inward = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float64)
        dst = src + inward * np.stack([ox, oy], axis=1)
        # homography mapping dst -> src (inverse map for output sampling)
        A, b = [], []
        for (xd, yd), (xs_, ys_) in zip(dst, src):
            A.append([xd, yd, 1, 0, 0, 0, -xs_ * xd, -xs_ * yd])
            A.append([0, 0, 0, xd, yd, 1, -ys_ * xd, -ys_ * yd])
            b.extend([xs_, ys_])
        hcoef = np.linalg.solve(np.asarray(A, np.float64),
                                np.asarray(b, np.float64))
        H = np.append(hcoef, 1.0).reshape(3, 3)
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        den = H[2, 0] * xx + H[2, 1] * yy + H[2, 2]
        xs = (H[0, 0] * xx + H[0, 1] * yy + H[0, 2]) / den
        ys = (H[1, 0] * xx + H[1, 1] * yy + H[1, 2]) / den
        return _inverse_warp(arr, ys, xs, self.interpolation, self.fill)
