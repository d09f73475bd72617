"""Minimal PNG writer and reader (zlib + struct + numpy), and the port's
image reader.

The writer emits 8-bit RGB or RGBA with no filtering (zlib level 1), a
batch at a time on a pool of threads: ``zlib.compress`` releases
the interpreter lock, so the images deflate in parallel.
The reader takes every PNG that PIL's ``convert("RGB")`` reads, and makes
the same 8-bit samples of it: grayscale of 1, 2, 4, 8 or 16 bits (scaled by
255, 85 and 17 below 8 bits; 16-bit gray clipped to 255, as PIL's ``I;16``
→ RGB clips it), grayscale + alpha, RGB and RGBA of 8 or 16 bits (the high
byte of a 16-bit sample, as PIL unpacks them), and palette images of 1, 2,
4 or 8 bits (expanded through ``PLTE``; ``tRNS`` is ignored, as
``convert("RGB")`` ignores it), plain or Adam7-interlaced, with any of the
five scanline filters. As PIL's ``Image.open``, it checks the CRC of every
chunk before the first IDAT and no later one, and refuses an image past
PIL's decompression-bomb bound from IHDR. ``read_image_rgb`` picks
the reader by the file's first bytes, not its name, in the order PIL's
plugins try them: BMP, GIF, JPEG, PNM, PNG here, ICO and CUR, TIFF and WebP
through the port's decoders (``utils/bmp.py``, ``utils/gif.py``,
``utils/jpeg.py``, ``utils/pnm.py``, ``utils/ico.py``, ``utils/tiff.py``,
``utils/webp.py``), and the types left (TGA, PCX, PSD, JPEG 2000 and the
other plugins PIL opens by content, and TIFFs of the compressions and
layouts ``utils/tiff.py`` leaves to PIL) through PIL, imported only for
them. ``refused_images`` lists the files those decoders refuse on their
headers and, where PIL cannot be imported, the files that would need it.
"""
from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Optional, Sequence

import numpy as np

from vavae_tpu_torch.utils import bmp, gif, ico, pnm, tiff, webp
from vavae_tpu_torch.utils.jpeg import CHECK_HEAD, decode_jpeg, jpeg_head_refusal
from vavae_tpu_torch.utils.pil_limits import NeedsPil, bomb_check

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type → samples per pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W, 3) RGB or (H, W, 4) RGBA uint8 → PNG bytes."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3) or (H, W, 4) uint8, got {img.shape}")
    h, w, c = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def write_pngs(images: np.ndarray, paths, threads: int = 0) -> None:
    """images (B, H, W, 3 or 4) uint8 → one PNG per path, encoded and written
    on ``threads`` threads (0: one a core), at most one an image. The first
    failure is raised once every image has been tried."""
    if len(images) != len(paths):
        raise ValueError(f"{len(images)} images for {len(paths)} paths")

    def write(i: int) -> None:
        with open(paths[i], "wb") as f:
            f.write(encode_png(images[i]))

    n = min(threads or os.cpu_count() or 1, len(paths))
    if n <= 1:
        for i in range(len(paths)):
            write(i)
        return
    with ThreadPoolExecutor(n) as pool:
        # not ``pool.map``: its iterator cancels the images not yet started
        # when one fails
        for future in [pool.submit(write, i) for i in range(len(paths))]:
            future.result()


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters of h rows of ``stride`` bytes, whose
    filters reach back ``bpp`` bytes; returns (h, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 1:  # Sub: a running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(stride) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: pixel by pixel along the row
            cur = np.empty(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prev[x:x + bpp]
                pred = (left + up) >> 1 if ftype == 3 else _paeth(left, up, up_left)
                left = (line[x:x + bpp] + pred) & 0xFF
                cur[x:x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _unpack(rows: np.ndarray, w: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered scanlines (h, bytes) → samples (h, w, channels): uint16
    for 16-bit files, uint8 values below 2^depth otherwise, the leftmost
    pixel in the high bits of a byte."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, -1).view(">u2")[:, :w * channels].reshape(h, w, channels)
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # high bits first
    idx = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return idx.reshape(h, -1)[:, :w, None]


# Adam7: each pass's first column and row, and its steps
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _samples(raw: bytes, h: int, w: int, depth: int, channels: int, interlace: int) -> np.ndarray:
    """The image's samples (h, w, channels) from the inflated data: one
    pass, or Adam7's seven, each unfiltered on its own."""
    bpp = max(1, depth * channels // 8)  # the filters' byte distance
    row_bytes = lambda width: (width * depth * channels + 7) // 8  # noqa: E731
    if not interlace:
        return _unpack(_unfilter(raw, h, row_bytes(w), bpp), w, depth, channels)
    out = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue  # an empty pass has no bytes at all
        size = ph * (row_bytes(pw) + 1)
        rows = _unfilter(raw[pos:pos + size], ph, row_bytes(pw), bpp)
        out[y0::dy, x0::dx] = _unpack(rows, pw, depth, channels)
        pos += size
    if pos != len(raw):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {pos}")
    return out


def _to_8_bits(s: np.ndarray, depth: int, ctype: int) -> np.ndarray:
    """Samples as PIL unpacks them for ``convert("RGB")``: gray below 8 bits
    scaled to 0-255, 16-bit gray (PIL's ``I;16``) clipped to 255, and the
    high byte of any other 16-bit sample."""
    if depth == 16:
        return np.minimum(s, 255).astype(np.uint8) if ctype == 0 else (s >> 8).astype(np.uint8)
    if depth < 8 and ctype == 0:
        return (s * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return s


_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


class _Cut(Exception):
    """The data ends inside the chunks before the first IDAT."""


def _head_chunks(data: bytes) -> tuple[Optional[tuple], Optional[np.ndarray], int]:
    """IHDR's fields (None without one), the PLTE (None without one) and the
    offset of the first IDAT or IEND chunk, read from the chunks before it
    as PIL's ``Image.open`` reads them (``PngImageFile._open``): each chunk
    whole, its CRC (``zlib.crc32`` over type and body) equal to the stored
    one, known or not (``PngStream.crc``), and the image's size held to
    PIL's bomb bound as soon as IHDR is read. Raises ``_Cut`` where the
    data ends first, ``ValueError`` for what PIL refuses."""
    pos, header, palette = 8, None, None
    while True:
        if pos + 8 > len(data):
            raise _Cut
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if tag in (b"IDAT", b"IEND"):
            return header, palette, pos
        end = pos + 8 + length
        if end + 4 > len(data):
            raise _Cut
        body = data[pos + 8:end]
        if zlib.crc32(body, zlib.crc32(tag)) != struct.unpack(">I", data[end:end + 4])[0]:
            raise ValueError(f"broken PNG file (bad header checksum in {tag!r})")
        if tag == b"IHDR":
            if length < 13:
                raise ValueError("Truncated IHDR chunk")
            header = struct.unpack(">IIBBBBB", body[:13])
            bomb_check(header[0], header[1])
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        pos = end + 4


def _check_header(header: Optional[tuple]) -> None:
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    _, _, depth, ctype, _, _, interlace = header
    if depth not in _DEPTHS.get(ctype, ()) or interlace not in (0, 1):
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, C) uint8: C is the file's samples per pixel (1
    gray, 2 gray + alpha, 3 RGB, 4 RGBA), and 3 for a palette image, whose
    indices are looked up in ``PLTE``; samples of other depths than 8 are
    brought to 8 bits as PIL brings them. The chunks before the first IDAT
    are checked as PIL checks them (``_head_chunks``); the later ones are
    not, as PIL checks none of their CRCs."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    try:
        header, palette, pos = _head_chunks(data)
    except _Cut:
        raise ValueError("truncated PNG file (it ends before its image data)") from None
    _check_header(header)
    w, h, depth, ctype, _, _, interlace = header
    idat = []
    while pos + 8 <= len(data):  # a cut chunk header ends the file, as in PIL
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    try:  # a stream cut after the last row (its checksum missing) is whole enough for PIL
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from None
    samples = _samples(raw, h, w, depth, _CHANNELS.get(ctype, 1), interlace)
    if ctype != 3:
        return _to_8_bits(samples, depth, ctype)
    if palette is None:
        raise ValueError("palette PNG (colour type 3) without a PLTE chunk")
    idx = samples[..., 0]
    if idx.max(initial=0) >= len(palette):
        raise ValueError(f"palette index {idx.max()} past the {len(palette)}-entry PLTE")
    return palette[idx]


def png_head_refusal(head: bytes, f: BinaryIO) -> Optional[str]:
    """Why ``decode_png`` refuses the PNG open as ``f`` on its chunks before
    the first IDAT (a bad CRC, a cut chunk, IHDR's size past PIL's bomb
    bound or fields PIL does not read), else None (also for a file that is
    not a PNG). ``head`` holds its first ``CHECK_HEAD`` bytes (or all, if
    fewer); the rest of ``f`` is read only when those chunks run past them."""
    if head[:8] != _SIGNATURE:
        return None
    try:
        try:
            header, _, _ = _head_chunks(head)
        except _Cut:
            if len(head) < CHECK_HEAD:
                raise
            header, _, _ = _head_chunks(head + f.read())
        _check_header(header)
    except _Cut:
        return "truncated PNG file (it ends before its image data)"
    except ValueError as e:
        return str(e)
    return None


def _rgb(img: np.ndarray) -> np.ndarray:
    """A decoded PNG as (H, W, 3), the way PIL's ``convert("RGB")`` makes it
    (gray repeated, alpha dropped; a palette is already looked up)."""
    if img.shape[2] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _decode_png_rgb(data: bytes, path: str) -> np.ndarray:
    try:
        return _rgb(decode_png(data))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def read_png(path: str) -> np.ndarray:
    """The PNG at ``path`` as (H, W, 3) uint8, the way PIL's
    ``convert("RGB")`` makes it (gray repeated, alpha dropped, palette
    looked up)."""
    with open(path, "rb") as f:
        return _decode_png_rgb(f.read(), path)


_JPEG_MAGIC = b"\xff\xd8\xff"
_CHECK_THREADS = 8


_OTHERS = "an image that is neither PNG, JPEG, WebP, BMP, GIF, TIFF, PNM, ICO nor CUR"


def _ported(head: bytes) -> bool:
    """Whether a file that starts with ``head`` (its first 12 bytes or
    more) goes to one of the port's decoders (which may still leave it to
    PIL)."""
    return (head[:2] == bmp.MAGIC or gif.is_gif(head) or head[:3] == _JPEG_MAGIC
            or pnm.is_pnm(head) or head[:8] == _SIGNATURE or ico.is_ico(head)
            or tiff.is_tiff(head) or webp.is_webp(head))


def read_image_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8, as PIL's ``Image.open(path).convert("RGB")``: by the
    file's first bytes (an ImageNet file named ``.JPEG`` may hold a PNG, a
    ``.jpg`` a GIF), in the order PIL's plugins try them, a BMP, GIF, JPEG,
    PNM, PNG, ICO or CUR, TIFF or WebP through the port's decoders, and
    other types (and the files those decoders leave to PIL, ``NeedsPil``)
    through PIL, imported only for them."""
    with open(path, "rb") as f:
        data = f.read()
    what = _OTHERS
    try:
        if data[:2] == bmp.MAGIC:
            return bmp.decode_bmp(data, path)
        if gif.is_gif(data):
            return gif.decode_gif(data, path)
        if data[:3] == _JPEG_MAGIC:
            return decode_jpeg(data, path)
        if pnm.is_pnm(data):
            return pnm.decode_pnm(data, path)
        if data[:8] == _SIGNATURE:
            return _decode_png_rgb(data, path)
        if ico.is_ico(data):
            return ico.decode_ico(data, path)
        if tiff.is_tiff(data):
            return tiff.decode_tiff(data, path)
        if webp.is_webp(data):
            return webp.decode_webp(data, path)
    except NeedsPil as e:
        what = str(e)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading {what} needs PIL (Pillow), which is not "
                          "installed") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _pil_importable() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def _refusal(path: str, pil: bool) -> Optional[str]:
    """The file's head read once; the rest only for a JPEG whose frame header
    lies past it, a PNG whose chunks before the first IDAT run past it, or
    a WebP, BMP, GIF, PNM, ICO, CUR or TIFF file whose headers need it.
    Without PIL (``pil`` False), also a file that would need it."""
    with open(path, "rb") as f:
        head = f.read(CHECK_HEAD)
        try:
            why = (jpeg_head_refusal(head, f) or png_head_refusal(head, f)
                   or webp.webp_head_refusal(head, f)
                   or bmp.bmp_head_refusal(head, f) or gif.gif_head_refusal(head, f)
                   or pnm.pnm_head_refusal(head, f) or ico.ico_head_refusal(head, f)
                   or tiff.tiff_head_refusal(head, f))
        except NeedsPil as e:
            return None if pil else f"reading {e} needs PIL (Pillow), which is not installed"
    if why is None and not pil and not _ported(head):
        why = f"reading {_OTHERS} needs PIL (Pillow), which is not installed"
    return why


def refused_images(paths: Sequence[str]) -> list[tuple[str, str]]:
    """(path, reason) for each of ``paths`` that the port's decoders refuse
    on their headers alone (``jpeg_refusal``, ``png_head_refusal``,
    ``webp_refusal``, ``bmp_refusal`` and the GIF, PNM, ICO/CUR and TIFF
    readers' header checks), and, where PIL cannot be imported, each that would need it, in
    the order of ``paths``, checked on a pool of threads."""
    pil = _pil_importable()
    with ThreadPoolExecutor(_CHECK_THREADS) as pool:
        reasons = list(pool.map(lambda p: _refusal(p, pil), paths))
    return [(p, r) for p, r in zip(paths, reasons) if r is not None]
