"""Image decoding and the keep-ratio resize of the data pipeline, without
OpenCV where the data allow it.

Counterpart of ``imvoxelnet_tpu/data/pipeline.py:27-49`` (``load_image``,
``imresize``), which call ``cv2``.  Here:

- :func:`load_image` decodes 8-bit, non-interlaced gray, gray + alpha, RGB
  and RGBA PNG files by their content (whatever the file's name) through
  ``zlib`` and the native row unfilter (``native/image_ops.cc``), as
  ``cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]`` does: gray replicated
  to three channels, alpha dropped.  Anything else (JPEG, 16-bit or palette
  PNG) goes through ``cv2``, imported at that call, which raises naming the
  file where ``cv2`` is not installed.
- :func:`imresize` reproduces ``cv2.resize(..., INTER_LINEAR)`` of uint8
  images bit for bit (OpenCV's fixed-point path, below), in native code
  (``native/image_ops.cc``) with a numpy plain version.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import native

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# PNG color type -> samples per pixel (8-bit gray, RGB, gray + alpha, RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def load_image(path: str) -> np.ndarray:
    """Load an image as ``(h, w, 3)`` RGB uint8."""
    with open(path, 'rb') as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        img = decode_png(data, path)
        if img is not None:
            return img
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f'{path}: decoding this image needs cv2, which '
                           f'is not installed (the port decodes 8-bit PNG '
                           f'alone)') from e
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f'{path}: cv2 cannot decode this image')
    return img[:, :, ::-1].copy()


def image_shape(path: str) -> tuple:
    """``(h, w)`` of an image file as ``cv2.imread(path).shape[:2]`` gives
    it, read from its header: a PNG's IHDR, a baseline or progressive
    JPEG's SOF marker, with the EXIF orientation that ``cv2.imread``
    applies (tags 5-8 swap the axes).  Other files go through ``cv2``."""
    with open(path, 'rb') as f:
        head = f.read(33)
        if head.startswith(PNG_SIGNATURE):
            w, h = struct.unpack('>II', head[16:24])
            return int(h), int(w)
        if head.startswith(b'\xff\xd8'):
            f.seek(0)
            shape = _jpeg_shape(f.read(), path)
            if shape is not None:
                return shape
    img = load_image(path)
    return img.shape[:2]


# start-of-frame markers: 0xC0-0xCF but DHT (C4), JPG (C8) and DAC (CC)
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def _jpeg_shape(data: bytes, path: str):
    pos, swap, shape = 2, False, None
    while pos + 4 <= len(data) and shape is None:
        if data[pos] != 0xFF:
            raise ValueError(f'{path}: JPEG marker expected at byte {pos}')
        marker = data[pos + 1]
        if marker == 0xFF:                      # fill byte
            pos += 1
            continue
        length = struct.unpack('>H', data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and body.startswith(b'Exif\0\0'):
            swap = _exif_orientation(body[6:]) in (5, 6, 7, 8)
        elif marker in _SOF:
            h, w = struct.unpack('>HH', body[1:5])
            shape = (int(h), int(w))
        elif marker == 0xDA:                    # scan data before any SOF
            return None
        pos += 2 + length
    if shape is None:
        return None
    return shape[::-1] if swap else shape


def _exif_orientation(tiff: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 of a TIFF block, 1 if absent."""
    if len(tiff) < 8 or tiff[:2] not in (b'II', b'MM'):
        return 1
    e = '<' if tiff[:2] == b'II' else '>'
    ifd = struct.unpack(e + 'I', tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    n = struct.unpack(e + 'H', tiff[ifd:ifd + 2])[0]
    for i in range(n):
        entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, _, _ = struct.unpack(e + 'HHI', entry[:8])
        if tag == 0x0112:
            return struct.unpack(e + 'H', entry[8:10])[0]
    return 1


def _png_chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f'{path}: truncated PNG chunk {kind!r}')
        yield kind, body
        if kind == b'IEND':
            return
        pos += 12 + length
    raise ValueError(f'{path}: PNG without IEND')


def decode_png(data: bytes, path: str = '<bytes>'):
    """``(h, w, 3)`` RGB uint8 of an 8-bit non-interlaced gray, gray +
    alpha, RGB or RGBA PNG; ``None`` for another kind of PNG."""
    header, idat = None, []
    for kind, body in _png_chunks(data, path):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None:
        raise ValueError(f'{path}: PNG without IHDR')
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _PNG_CHANNELS:
        return None
    channels = _PNG_CHANNELS[color]
    try:
        raw = zlib.decompress(b''.join(idat))
    except zlib.error as e:
        raise ValueError(f'{path}: corrupt PNG data ({e})') from e
    px = native.png_unfilter(raw, h, w * channels, channels).reshape(
        h, w, channels)
    if channels <= 2:                       # gray (+ alpha) -> RGB
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def png_unfilter_plain(filtered, h: int, row_bytes: int, bpp: int):
    """Plain version of ``native.png_unfilter``: the PNG spec's
    reconstruction (section 9.2), row by row in numpy."""
    src = np.frombuffer(filtered, np.uint8).reshape(h, row_bytes + 1)
    out = np.zeros((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int32)
    for y in range(h):
        kind, x = src[y, 0], src[y, 1:].astype(np.int32)
        if kind not in (0, 1, 2, 3, 4):
            raise ValueError(f'PNG row {y}: filter type {kind} is not 0-4')
        if kind == 2:
            x = x + prev
        elif kind in (1, 3, 4):
            row = np.zeros(row_bytes + bpp, np.int32)       # bpp zeros left
            up = np.concatenate([np.zeros(bpp, np.int32), prev])
            for i in range(row_bytes):
                a, b, c = row[i], up[i + bpp], up[i]
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                row[i + bpp] = (x[i] + pred) & 255
            x = row[bpp:]
        x = x & 255
        out[y] = x
        prev = x
    return out


# --------------------------------------------------------------------------
# cv2.resize(INTER_LINEAR) of uint8, bit for bit
# --------------------------------------------------------------------------

COEF_BITS = 11                     # INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS


def _taps(src: int, dst: int, clamp_weights: bool):
    """Source index and fixed-point weights of each output coordinate.

    As OpenCV computes them: ``scale = 1 / (dst / src)`` in double,
    ``f = float32((d + 0.5) * scale - 0.5)``, ``s = floor(f)``, ``f -= s``
    in float32, weights ``round_half_even((1 - f) * 2048)`` and
    ``round_half_even(f * 2048)``.  A column (``clamp_weights``) whose taps
    leave the image is clamped to the edge with ``f = 0``; a row keeps its
    fractional weights and only its two taps are clamped, so a border row
    blends the edge row with itself."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_weights:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0
        s = np.where(low, 0, np.where(high, src - 1, s))
    w0 = np.rint((np.float32(1) - f) * np.float32(COEF_SCALE)).astype(
        np.int32)
    w1 = np.rint(f * np.float32(COEF_SCALE)).astype(np.int32)
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1)


def _check_resize(img, out_hw):
    if img.dtype != np.uint8:
        raise ValueError(f'the resize takes uint8, got {img.dtype}')
    h, w = img.shape[:2]
    out_h, out_w = out_hw
    if w == 2 * out_w and h == 2 * out_h:
        raise NotImplementedError(
            f'{(h, w)} -> {(out_h, out_w)} is an exact 2x downscale, which '
            f'cv2 computes with INTER_AREA')
    return h, w, out_h, out_w


def resize_linear_u8(img: np.ndarray, out_hw) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)``
    of an ``(h, w)`` or ``(h, w, c)`` uint8 image, bit for bit, through the
    native resize (``native/image_ops.cc``).

    OpenCV's fixed-point path: the horizontal pass sums two taps with
    11-bit weights in int32; the vertical pass is its SIMD rounding,
    ``((h0 >> 4) * b0 >> 16) + ((h1 >> 4) * b1 >> 16) + 2 >> 2``, saturated
    to uint8.  OpenCV serves an exact 2x downscale in both axes with
    INTER_AREA instead; that case raises here.  An unchanged size is a
    copy, as in OpenCV."""
    h, w, out_h, out_w = _check_resize(img, out_hw)
    if (out_h, out_w) == (h, w):
        return img.copy()
    out = native.resize_linear_u8(
        img.reshape(h, w, -1), (out_h, out_w),
        _taps(w, out_w, clamp_weights=True),
        _taps(h, out_h, clamp_weights=False))
    return out.reshape((out_h, out_w) + img.shape[2:])


def resize_linear_u8_plain(img: np.ndarray, out_hw) -> np.ndarray:
    """Plain numpy version of :func:`resize_linear_u8`."""
    h, w, out_h, out_w = _check_resize(img, out_hw)
    if (out_h, out_w) == (h, w):
        return img.copy()
    src = img.reshape(h, w, -1).astype(np.int32)
    x0, x1, a0, a1 = _taps(w, out_w, clamp_weights=True)
    y0, y1, b0, b1 = _taps(h, out_h, clamp_weights=False)
    rows = src[:, x0] * a0[:, None] + src[:, x1] * a1[:, None]  # (h, W', c)
    rows >>= 4
    out = ((rows[y0] * b0[:, None, None]) >> 16) + \
        ((rows[y1] * b1[:, None, None]) >> 16)
    out += 2
    out >>= 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (out_h, out_w) + img.shape[2:])


def imresize(img: np.ndarray, scale_factor: float) -> np.ndarray:
    """Keep-ratio resize by ``scale_factor``: the output is
    ``int(w * factor + 0.5) x int(h * factor + 0.5)``
    (``imvoxelnet_tpu/data/pipeline.py:43-49``)."""
    h, w = img.shape[:2]
    new_w = int(w * scale_factor + 0.5)
    new_h = int(h * scale_factor + 0.5)
    return resize_linear_u8(np.ascontiguousarray(img), (new_h, new_w))
