"""The port's PNG reader (``utils/png.py``) on every PNG kind PIL reads:
gray of 1, 2, 4, 8 and 16 bits, gray + alpha, RGB and RGBA of 8 and 16
bits, palette of 1-8 bits, plain and Adam7-interlaced, against PIL's
``Image.open(p).convert("RGB")``, bit for bit. The committed fixtures of
``tests/data/png`` (written by its ``make_fixtures.py``) hold PIL's decodes
in ``expected.npz``, which the card's machine reads too (PIL is not
one of its stated packages); a
seeded sweep of sizes and filters goes through PIL itself. The files PIL
refuses on their chunks before IDAT (a bad CRC, a size past the bomb bound)
are refused by ``read_image_rgb`` and named by ``refused_images``.
"""
import io
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from test_torch_common import REPO, one_thread  # noqa: F401
from vavae_tpu_torch.utils.jpeg import CHECK_HEAD
from vavae_tpu_torch.utils.pil_limits import MAX_IMAGE_PIXELS
from vavae_tpu_torch.utils.png import decode_png, read_image_rgb, read_png, refused_images

pytestmark = pytest.mark.usefixtures("one_thread")

FIXTURES = REPO / "tests" / "data" / "png"
sys.path.insert(0, str(FIXTURES))
import make_fixtures as png_fixtures  # noqa: E402

EXPECTED = np.load(FIXTURES / "expected.npz")


@pytest.mark.parametrize("name", sorted(EXPECTED.files))
def test_committed_fixture_matches_pil(name):
    """The file through ``read_png`` and ``read_image_rgb`` equals PIL's
    committed decode, which equals PIL's decode now."""
    path = str(FIXTURES / name)
    want = EXPECTED[name]
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), want)
    np.testing.assert_array_equal(read_png(path), want)
    np.testing.assert_array_equal(read_image_rgb(path), want)


def test_fixtures_cover_every_kind():
    kinds = {(ctype, depth, adam7) for ctype, (_, depths) in png_fixtures.KINDS.items()
             for depth in depths for adam7 in ("", "_adam7")}
    assert sorted(EXPECTED.files) == sorted(f"c{c}_d{d}{a}.png" for c, d, a in kinds)


@pytest.mark.parametrize("ctype", sorted(png_fixtures.KINDS))
def test_sizes_and_filters_match_pil(ctype):
    """Seeded images of each colour type and depth, plain and interlaced, at
    sizes where Adam7 passes are empty (1×1, 3×9) or partial."""
    rs = np.random.default_rng(ctype)
    c, depths = png_fixtures.KINDS[ctype]
    for depth in depths:
        for interlace in (0, 1):
            for h, w in ((1, 1), (3, 9), (8, 8), (13, 11), (2, 17)):
                s = rs.integers(0, 1 << depth, (h, w, c))
                palette = (rs.integers(0, 256, (1 << depth, 3)).astype(np.uint8)
                           if ctype == 3 else None)
                data = png_fixtures.encode(s, depth, ctype, interlace, rs, palette)
                with Image.open(io.BytesIO(data)) as im:
                    want = np.asarray(im.convert("RGB"))
                got = decode_png(data)
                rgb = np.repeat(got[..., :1], 3, 2) if got.shape[2] < 3 else got[..., :3]
                np.testing.assert_array_equal(rgb, want, err_msg=f"{ctype} {depth} {interlace}")


@pytest.mark.parametrize("depth,ctype,interlace", [(4, 2, 0), (16, 3, 0), (2, 6, 0), (8, 2, 2)])
def test_invalid_headers_raise(depth, ctype, interlace):
    """Depths a colour type does not allow, and an unknown interlace method,
    which PIL refuses too."""
    rs = np.random.default_rng(0)
    data = bytearray(png_fixtures.encode(np.zeros((2, 2, 3), np.int64), 8, 2, 0, rs))
    data[24:29] = bytes([depth, ctype, 0, 0, interlace])  # IHDR's fields, and its CRC redone
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(bytes(data))
    with pytest.raises(OSError):  # PIL's UnidentifiedImageError
        with Image.open(io.BytesIO(bytes(data))) as im:
            im.convert("RGB")


# -- what PIL refuses on the chunks before IDAT: the bomb bound and the CRCs ---------------------


def _png(chunks) -> bytes:
    return b"\x89PNG\r\n\x1a\n" + b"".join(png_fixtures._chunk(t, b) for t, b in chunks)


def _ihdr(w: int, h: int, depth: int = 8, ctype: int = 0) -> tuple:
    return b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)


def _gray_bomb(w: int, h: int) -> bytes:
    """An 8-bit gray PNG of w × h zeros, its IDAT deflated a row at a time."""
    z = zlib.compressobj(9)
    row = bytes(w + 1)
    idat = b"".join(z.compress(row) for _ in range(h)) + z.flush()
    return _png([_ihdr(w, h), (b"IDAT", idat), (b"IEND", b"")])


def _pil_refuses(path) -> str:
    with pytest.raises(Exception) as e:
        with Image.open(path) as im:
            im.convert("RGB")
    return str(e.value)


def test_bomb_png_is_refused_as_pil_refuses_it(tmp_path):
    """The 174,609-byte 13,400 × 13,400 gray PNG (179,560,000 pixels), which
    inflates to 538.7 MB: refused from IHDR with PIL's message, before any
    IDAT is inflated, and named by ``refused_images``."""
    path = tmp_path / "bomb.png"
    path.write_bytes(_gray_bomb(13400, 13400))
    assert path.stat().st_size == 174609
    want = _pil_refuses(path)
    assert want.startswith("Image size (179560000 pixels) exceeds limit of 178956970 pixels")
    with pytest.raises(ValueError) as e:
        read_image_rgb(str(path))
    assert str(e.value) == f"{path}: {want}"
    assert refused_images([str(path)]) == [(str(path), want)]


@pytest.mark.parametrize("w,h,refused", [(13377, 13378, True), (13377, 13377, False)])
def test_bomb_bound_boundary_png(tmp_path, w, h, refused):
    """13,377 × 13,378 = 178,957,506 pixels lies past 2 × MAX_IMAGE_PIXELS =
    178,956,970 and is refused; 13,377² = 178,944,129 is not. Held on the
    header check alone, as PIL's ``Image.open`` holds it, so no 179 M
    pixels are decoded."""
    assert (w * h > 2 * MAX_IMAGE_PIXELS) == refused
    path = tmp_path / "edge.png"
    path.write_bytes(_png([_ihdr(w, h), (b"IDAT", zlib.compress(b"")), (b"IEND", b"")]))
    got = refused_images([str(path)])
    if refused:
        want = _pil_refuses(path)
        assert got == [(str(path), want)] and want.startswith(f"Image size ({w * h} pixels)")
        with pytest.raises(ValueError, match="decompression bomb"):
            read_image_rgb(str(path))
    else:
        with pytest.warns(Image.DecompressionBombWarning), Image.open(path) as im:
            assert im.size == (w, h)  # opened (a warning only), as the port's check passes it
        assert got == []


def _palette_png(extra_before=(), extra_after=()) -> tuple[bytes, np.ndarray]:
    """A 6×5 palette PNG with tEXt before IDAT (and ``extra_*`` chunks), and
    its RGB image."""
    rs = np.random.default_rng(3)
    palette = rs.integers(0, 256, (4, 3)).astype(np.uint8)
    idx = rs.integers(0, 4, (5, 6)).astype(np.uint8)
    raw = np.concatenate([np.zeros((5, 1), np.uint8), idx], 1).tobytes()
    data = _png([_ihdr(6, 5, 8, 3), (b"PLTE", palette.tobytes()),
                 (b"tEXt", b"Comment\0made in the test"), *extra_before,
                 (b"IDAT", zlib.compress(raw)), *extra_after, (b"IEND", b"")])
    return data, palette[idx]


def _flip_crc(data: bytes, tag: bytes, nth: int = 0) -> bytes:
    """``data`` with one bit flipped in the CRC of the ``nth`` chunk ``tag``."""
    pos, seen = 8, 0
    while True:
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == tag:
            if seen == nth:
                crc = pos + 8 + length
                return data[:crc] + bytes([data[crc] ^ 0x10]) + data[crc + 1:]
            seen += 1
        pos += 12 + length


BAD_BEFORE_IDAT = {
    "IHDR": lambda: _flip_crc(_palette_png()[0], b"IHDR"),
    "PLTE": lambda: _flip_crc(_palette_png()[0], b"PLTE"),
    "tEXt": lambda: _flip_crc(_palette_png()[0], b"tEXt"),
    # an unknown ancillary chunk, checked as PIL checks every chunk
    "unknown_ancillary": lambda: _flip_crc(_palette_png([(b"prVt", b"x" * 7)])[0], b"prVt"),
    # a bad CRC past the first 16 KiB that refused_images reads
    "past_the_head": lambda: _flip_crc(
        _palette_png([(b"zTXt", bytes(CHECK_HEAD + 100))])[0], b"zTXt"),
    # a file cut inside a chunk before IDAT
    "cut": lambda: _palette_png()[0][:52],
}


@pytest.mark.parametrize("case", sorted(BAD_BEFORE_IDAT))
def test_bad_chunk_before_idat_is_refused_as_pil_refuses_it(tmp_path, case):
    """A bad CRC (one bit flipped) in any chunk before the first IDAT, or a
    chunk cut there: PIL's ``Image.open`` refuses the file, and so do
    ``read_image_rgb`` and ``refused_images``, naming it."""
    path = tmp_path / f"{case}.png"
    path.write_bytes(BAD_BEFORE_IDAT[case]())
    _pil_refuses(path)
    with pytest.raises(ValueError, match=r"bad header checksum|truncated PNG") as e:
        read_image_rgb(str(path))
    assert str(e.value).startswith(str(path))
    [(named, why)] = refused_images([str(path)])
    assert named == str(path) and why in str(e.value)


@pytest.mark.parametrize("tag,nth", [(b"IDAT", 0), (b"IDAT", 1), (b"tEXt", 1), (b"IEND", 0)])
def test_bad_crc_from_idat_on_is_read_as_pil_reads_it(tmp_path, tag, nth):
    """PIL checks no CRC from the first IDAT on (``load_read``, ``load_end``):
    a bad IDAT, later tEXt or IEND CRC is read, to PIL's pixels."""
    data, want = _palette_png(extra_after=[(b"tEXt", b"Author\0after the data")])
    idat = data.index(b"IDAT") - 4  # split the image data over two IDAT chunks
    (length,) = struct.unpack(">I", data[idat:idat + 4])
    z = data[idat + 8:idat + 8 + length]
    data = (data[:idat] + png_fixtures._chunk(b"IDAT", z[:9]) + png_fixtures._chunk(b"IDAT", z[9:])
            + data[idat + 12 + length:])
    path = tmp_path / "late.png"
    path.write_bytes(_flip_crc(data, tag, nth))
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), want)
    np.testing.assert_array_equal(read_image_rgb(str(path)), want)
    assert refused_images([str(path)]) == []
