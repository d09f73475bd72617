"""Hand-built TIFF files for the tests of the port's TIFF reader: an IFD
writer (classic or BigTIFF, either byte order) and the encoders of its
strips and tiles (TIFF's MSB-first LZW with the early code-width change,
PackBits, Deflate), each written from the TIFF 6.0 specification."""
from __future__ import annotations

import struct
import zlib

import numpy as np

TYPE_FMT = {1: "B", 3: "H", 4: "L", 5: "LL", 6: "b", 8: "h", 9: "l", 11: "f", 12: "d", 16: "Q",
            17: "q"}


def lzw(data: bytes) -> bytes:
    """TIFF LZW: a clear code first, codes of 9-12 bits, MSB first, the
    width growing when the next code reaches 2^width (one code early for
    the decoder), a clear when the table reaches 4,094, EOI last."""
    out, acc, nb = bytearray(), 0, 0
    width = 9

    def put(code: int) -> None:
        nonlocal acc, nb
        acc = (acc << width) | code
        nb += width
        while nb >= 8:
            nb -= 8
            out.append((acc >> nb) & 255)

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    put(256)
    w = b""
    for k in data:
        wk = w + bytes([k])
        if not w or wk in table:
            w = wk
            continue
        put(table[w])
        table[wk] = nxt
        nxt += 1
        if nxt == 4094:
            put(256)
            table, nxt, width = {bytes([i]): i for i in range(256)}, 258, 9
        elif nxt >= (1 << width):
            width += 1
        w = bytes([k])
    if w:
        put(table[w])
        nxt += 1
        if nxt >= (1 << width) and width < 12:
            width += 1
    put(257)
    if nb:
        out.append((acc << (8 - nb)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes as (1 - n, byte), the rest as
    literal runs of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 255, data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def deflate(data: bytes) -> bytes:
    return zlib.compress(data, 6)


ENCODERS = {1: lambda b: b, 5: lzw, 8: deflate, 32946: deflate, 32773: packbits}


def predict(rows: np.ndarray, spp: int, nbytes: int, order: str) -> np.ndarray:
    """Horizontal differencing of (h, row bytes) rows of ``nbytes``-byte
    samples, ``spp`` apart, in the file's byte order."""
    dt = np.dtype(f"{'<' if order == 'II' else '>'}u{nbytes}")
    v = rows.view(dt).reshape(rows.shape[0], -1, spp).astype(np.int64)
    d = np.concatenate([v[:, :1], np.diff(v, axis=1)], axis=1) % (1 << (8 * nbytes))
    return d.astype(dt).reshape(rows.shape[0], -1).view(np.uint8)


def tiff(entries: list, blocks: list, *, order: str = "II", big: bool = False,
         offsets_tag: int = 273, counts_tag: int | None = 279, magic: bytes | None = None,
         offsets_type: int = 4, offsets: tuple | None = None) -> bytes:
    """A TIFF file: the header, the ``blocks`` (strip or tile bytes), then
    one IFD of ``entries`` (tag, type, values: a tuple, or bytes for types
    1 and 7) with the blocks' offsets (or ``offsets``, of type
    ``offsets_type``) and byte counts added under ``offsets_tag`` and
    ``counts_tag`` (None: no counts)."""
    e = "<" if order == "II" else ">"
    head_len = 16 if big else 8
    data = bytearray(head_len)
    offs = []
    for b in blocks:
        offs.append(len(data))
        data += b
        if len(data) % 2:
            data += b"\0"
    entries = list(entries) + [(offsets_tag, offsets_type, offsets or tuple(offs))]
    if counts_tag:
        entries.append((counts_tag, 4, tuple(len(b) for b in blocks)))
    entries.sort(key=lambda t: t[0])
    ifd_at = len(data)
    n = len(entries)
    entry_len, inline = (20, 8) if big else (12, 4)
    extra_at = ifd_at + (8 if big else 2) + n * entry_len + (8 if big else 4)
    ifd = bytearray(struct.pack(e + ("Q" if big else "H"), n))
    extra = bytearray()
    for tag, typ, vals in entries:
        if isinstance(vals, (bytes, bytearray)):
            raw, count = bytes(vals), len(vals)
        else:
            fmt = TYPE_FMT[typ]
            flat = [x for v in vals for x in (v if isinstance(v, tuple) else (v,))]
            raw = struct.pack(e + fmt[0] * len(flat), *flat)
            count = len(vals)
        if len(raw) <= inline:
            field = raw + bytes(inline - len(raw))
        else:
            field = struct.pack(e + ("Q" if big else "L"), extra_at + len(extra))
            extra += raw
            if len(extra) % 2:
                extra += b"\0"
        ifd += struct.pack(e + ("HHQ" if big else "HHL"), tag, typ, count) + field
    ifd += bytes(8 if big else 4)
    data += ifd + extra
    if magic is None:
        magic = (b"II" if order == "II" else b"MM") + struct.pack(e + "H", 43 if big else 42)
    data[:4] = magic
    if big:
        data[4:16] = struct.pack(e + "HHQ", 8, 0, ifd_at)
    else:
        data[4:8] = struct.pack(e + "L", ifd_at)
    return bytes(data)


def image(samples: np.ndarray, bits: int, *, order: str = "II", compression: int = 1,
          predictor: int = 1, photometric: int | None = None, rows_per_strip: int | None = None,
          tile: tuple | None = None, planar: int = 1, extra: tuple = (), sample_format=None,
          fillorder: int = 1, colormap: tuple | None = None, orientation: int | None = None,
          big: bool = False, more: tuple = (), offsets_type: int = 4,
          offsets: tuple | None = None) -> bytes:
    """A TIFF of ``samples`` (h, w, spp) integers (floats for 32-bit sample
    format 3) packed at ``bits`` a sample, in strips of ``rows_per_strip``
    rows or ``tile`` (w, h) tiles, planar or not, compressed and predicted
    as asked; the entries of ``more`` are added, or replace those of their
    tags; ``offsets`` and ``offsets_type`` as for ``tiff``."""
    h, w, spp = samples.shape
    planes = [samples[..., i:i + 1] for i in range(spp)] if planar == 2 else [samples]
    if photometric is None:
        photometric = 2 if spp - len(extra) >= 3 else 1
    tw, th = tile or (w, rows_per_strip or h)
    blocks = []
    for plane in planes:
        k = plane.shape[2]
        for y in range(0, h, th):
            for x in range(0, w if tile else 1, tw if tile else 1):
                block = np.zeros((th if tile else min(th, h - y), tw, k), plane.dtype)
                part = plane[y:y + th, x:x + tw] if tile else plane[y:y + th]
                block[:part.shape[0], :part.shape[1]] = part
                rows = pack_rows(block, bits, order)
                if predictor == 2:
                    rows = predict(rows, k, bits // 8, order)
                raw = ENCODERS[compression](rows.tobytes())
                if fillorder == 2:  # the stored bytes, compressed or not, bit-reversed
                    raw = bytes(int(f"{b:08b}"[::-1], 2) for b in raw)
                blocks.append(raw)
    entries = [(256, 4, (w,)), (257, 4, (h,)), (258, 3, (bits,) * spp), (259, 3, (compression,)),
               (262, 3, (photometric,)), (277, 3, (spp,)), (284, 3, (planar,))]
    if tile:
        entries += [(322, 4, (tw,)), (323, 4, (th,))]
    else:
        entries += [(278, 4, (th,))]
    if predictor != 1:
        entries.append((317, 3, (predictor,)))
    if extra:
        entries.append((338, 3, tuple(extra)))
    if sample_format:
        entries.append((339, 3, (sample_format,) * spp))
    if fillorder != 1:
        entries.append((266, 3, (fillorder,)))
    if colormap is not None:
        entries.append((320, 3, tuple(colormap)))
    if orientation is not None:
        entries.append((274, 3, (orientation,)))
    entries = list({e[0]: e for e in entries + list(more)}.values())  # ``more`` replaces
    return tiff(entries, blocks, order=order, big=big, offsets_tag=324 if tile else 273,
                counts_tag=325 if tile else 279, offsets_type=offsets_type, offsets=offsets)


def pack_rows(block: np.ndarray, bits: int, order: str) -> np.ndarray:
    """(h, w, k) samples → (h, row bytes) uint8: bits below 8 packed MSB
    first and each row padded to a byte; wider samples in ``order``."""
    h, w, k = block.shape
    if bits < 8:
        v = block.reshape(h, w * k).astype(np.uint8)
        per = 8 // bits
        padded = np.zeros((h, -(-w * k // per) * per), np.uint8)
        padded[:, :w * k] = v
        out = np.zeros((h, padded.shape[1] // per), np.uint8)
        for j in range(per):
            out |= padded[:, j::per] << (8 - bits * (j + 1))
        return out
    e = "<" if order == "II" else ">"
    if block.dtype.kind == "f":
        dt = np.dtype(f"{e}f{bits // 8}")
    else:
        dt = np.dtype(f"{e}u{bits // 8}") if bits > 8 else np.dtype(np.uint8)
    return np.ascontiguousarray(block.astype(dt)).view(np.uint8).reshape(h, -1)
