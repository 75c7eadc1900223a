"""``paddle.vision`` (port of ``paddle_tpu/vision/``): ``models``,
``ops``, ``set_image_backend`` / ``get_image_backend`` and
``image_load``. The reference's datasets and transforms are not ported
yet."""
from . import models, ops  # noqa: F401


def set_image_backend(backend):
    pass


def get_image_backend():
    return "numpy"


def image_load(path, backend=None):
    """``path`` as an HWC uint8 array: through PIL where it is installed,
    else the standard library's PNG reader (8-bit, non-interlaced RGB or
    RGBA, alpha dropped)."""
    import numpy as np
    try:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"))
    except ImportError:
        pass
    import struct
    import zlib
    data = open(path, "rb").read()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        pos, w = 8, None
        idat = b""
        while pos < len(data):
            ln, typ = struct.unpack(">I4s", data[pos:pos + 8])
            chunk = data[pos + 8:pos + 8 + ln]
            if typ == b"IHDR":
                w, h, depth, color = struct.unpack(">IIBB", chunk[:10])
                interlace = chunk[12]
                if depth != 8 or color not in (2, 6) or interlace != 0:
                    raise ValueError("stdlib PNG path supports 8-bit "
                                     "non-interlaced RGB/RGBA only")
                nch = 3 if color == 2 else 4
            elif typ == b"IDAT":
                idat += chunk
            pos += 12 + ln
        raw = zlib.decompress(idat)
        stride = w * nch
        out = np.empty((h, stride), np.uint8)
        prev = np.zeros(stride, np.uint8)
        p = 0
        for row in range(h):
            f = raw[p]
            line = np.frombuffer(raw[p + 1:p + 1 + stride],
                                 np.uint8).astype(np.int32)
            p += 1 + stride
            if f == 0:
                rec = line
            elif f == 2:               # up
                rec = (line + prev) % 256
            elif f == 1:               # sub: per-channel cumulative sum
                cols = line.reshape(w, nch)
                rec = np.cumsum(cols, axis=0, dtype=np.int64) % 256
                rec = rec.reshape(stride).astype(np.int32)
            else:                      # average / paeth need the scalar loop
                rec = np.zeros(stride, np.int32)
                for i in range(stride):
                    a = rec[i - nch] if i >= nch else 0
                    b = int(prev[i])
                    if f == 3:
                        rec[i] = (line[i] + (a + b) // 2) % 256
                    else:                       # paeth
                        c = int(prev[i - nch]) if i >= nch else 0
                        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                        pred = a if pa <= pb and pa <= pc else \
                            (b if pb <= pc else c)
                        rec[i] = (line[i] + pred) % 256
            out[row] = rec.astype(np.uint8)
            prev = out[row]
        img = out.reshape(h, w, nch)
        return img[:, :, :3]
    raise ValueError(f"image_load: unsupported format for {path!r} "
                     "(stdlib path reads PNG; install PIL for more)")
