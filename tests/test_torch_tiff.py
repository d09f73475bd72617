"""The port's TIFF reader (``utils/tiff.py`` over ``native/lzw_decoder.cpp``)
against PIL 12's ``TiffImagePlugin`` (libtiff 4.7 for compressed files) +
``convert("RGB")``, bit for bit: the committed fixtures
(``tests/data/tiff/make_fixtures.py``: PIL's own files and hand-built ones
for 16-bit, signed and float samples in both byte orders, alpha, WhiteIsZero,
palettes, FillOrder 2, orientation, tiles, planes, extra samples, BigTIFF),
random layouts from ``tiffkit``, files cut short, and PIL's own writes of
every mode, compression and predictor (hypothesis). Files PIL refuses raise
``ValueError`` naming the file; files of the kinds the port leaves to PIL
(JPEG and CCITT compression) go to PIL, and without PIL raise
``ImportError`` naming the file and why.
"""
import builtins
import ctypes
import io
import os
import sys
import tempfile
import warnings

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from test_torch_common import REPO, one_thread  # noqa: F401
from vavae_tpu_torch.utils.pil_limits import NeedsPil
from vavae_tpu_torch.utils.png import read_image_rgb, refused_images
from vavae_tpu_torch.utils.tiff import _ERR_LEN, _library, decode_tiff, tiff_head_refusal

pytestmark = pytest.mark.usefixtures("one_thread")

FIXTURES = REPO / "tests" / "data" / "tiff"
sys.path.insert(0, str(FIXTURES))
import tiffkit as K  # noqa: E402

STEMS = sorted(p.stem for p in FIXTURES.glob("*.tif"))
GOOD = [s for s in STEMS if not s.startswith(("refused_", "pil_only_"))]
PIL_ONLY = [s for s in STEMS if s.startswith("pil_only_")]
REFUSED = [s for s in STEMS if s.startswith("refused_")]


@pytest.fixture(scope="module")
def expected():
    return dict(np.load(FIXTURES / "expected.npz"))


def _pil(data: bytes):
    """PIL's decode of ``data`` from a file, as ``Image.open(path)`` makes
    it (it maps a lone uncompressed strip, which a file object it cannot)."""
    fd, path = tempfile.mkstemp(suffix=".tif")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(path) as im:
                return np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 - any refusal of PIL's
        return None
    finally:
        os.remove(path)


def _same_outcome(data: bytes, what) -> bool:
    """Holds the port to PIL on ``data``; False (nothing held) for a file
    the port leaves to PIL."""
    try:
        got = decode_tiff(data)
    except NeedsPil:
        return False
    except ValueError:
        got = None
    want = _pil(data)
    assert (want is None) == (got is None), (what, "PIL refuses" if want is None else "port refuses")
    if want is not None:
        np.testing.assert_array_equal(got, want, err_msg=str(what))
    return True


@pytest.mark.parametrize("stem", GOOD)
def test_fixtures_match_pil(stem, expected):
    """Each committed fixture reads bit-equal to PIL's committed and live
    decode (from its path, as ``Image.open(path)`` maps an uncompressed
    strip) through ``read_image_rgb``, none of them left to PIL."""
    path = FIXTURES / f"{stem}.tif"
    decode_tiff(path.read_bytes())  # raises NeedsPil for a file left to PIL
    np.testing.assert_array_equal(read_image_rgb(str(path)), expected[stem])
    with Image.open(path) as im:
        assert im.format == "TIFF"
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), expected[stem])


def test_pinned_quirks(expected):
    """16-bit RGB reads its samples' high bytes; 16-bit gray is clipped at
    255; the Orientation tag is applied (6 turns the image a quarter turn
    clockwise); PackBits and uncompressed strips keep their predictor's
    differences."""
    rs = np.random.default_rng(2)
    small = np.asarray(Image.open(FIXTURES / "pil_rgb_raw.tif"))[:29, :37]
    rgb16 = (small.astype(np.uint16) * 257 + rs.integers(0, 256, small.shape)).astype(np.uint16)
    np.testing.assert_array_equal(expected["rgb16_mm_lzw"], rgb16 >> 8)
    gray16 = rs.integers(0, 700, (29, 37, 1))
    np.testing.assert_array_equal(expected["gray16_clipped_ii_packbits"][..., :1],
                                  np.minimum(gray16, 255))
    np.testing.assert_array_equal(expected["orientation_6_lzw"], np.rot90(small, -1))
    assert not np.array_equal(expected["predictor_ignored_packbits"], small)


@pytest.mark.parametrize("stem", PIL_ONLY)
def test_left_to_pil(stem, expected, monkeypatch):
    """A JPEG- or CCITT-compressed TIFF goes to PIL; without PIL it raises
    ``ImportError`` naming the file and its compression, and
    ``refused_images`` names it."""
    path = FIXTURES / f"{stem}.tif"
    np.testing.assert_array_equal(read_image_rgb(str(path)), expected[stem])
    with open(path, "rb") as f:
        with pytest.raises(NeedsPil, match="TIFF compression"):
            tiff_head_refusal(f.read(16), f)
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match=f"{path}: reading TIFF compression .* needs PIL"):
        read_image_rgb(str(path))
    assert [p for p, _ in refused_images([str(path)])] == [str(path)]


@pytest.mark.parametrize("stem", REFUSED)
def test_refused_fixtures_raise_as_pil(stem):
    """Each file PIL refuses (a big-endian BigTIFF, an unknown compression,
    LZW data cut short, a predictor on 4-bit samples, no dimensions, strip
    offsets before the file or at 2^63 - 1) raises ``ValueError`` naming the
    file."""
    path = FIXTURES / f"{stem}.tif"
    assert _pil(path.read_bytes()) is None
    with pytest.raises(ValueError, match=f"^{path}: "):
        read_image_rgb(str(path))


def test_header_refusals():
    """``tiff_head_refusal`` names what the IFD alone refuses; the files
    refused only in their pixels pass it."""
    reasons = {}
    for stem in STEMS:
        with open(FIXTURES / f"{stem}.tif", "rb") as f:
            try:
                reasons[stem] = tiff_head_refusal(f.read(16), f)
            except NeedsPil:
                reasons[stem] = "PIL"
    assert {s: r for s, r in reasons.items() if r} == {
        "pil_only_group4": "PIL", "pil_only_jpeg": "PIL",
        "refused_compression_99": "unknown TIFF compression 99",
        "refused_mm_bigtiff": "Missing dimensions", "refused_no_dimensions": "Missing dimensions",
        **{f"refused_slong_offset_minus_{n}_{codec}": "TIFF strip or tile offset or byte count below 0"
           for n in ("1", "len") for codec in ("raw", "lzw")}}
    assert refused_images([str(FIXTURES / f"{s}.tif") for s in GOOD]) == []


def test_native_decoder_refuses_blocks_outside_the_data():
    """``tiff_decode_blocks`` itself refuses a block that starts before the
    data, runs past its end, or whose end overflows, whatever its caller
    checked."""

    data = K.packbits(bytes(range(40)))
    out = np.zeros(40, np.uint8)
    for offset, count in ((-1, 4), (-len(data), len(data)), (0, len(data) + 1),
                          (2**63 - 1, 2), (1, 2**63 - 1)):
        offsets, counts = np.array([offset], np.int64), np.array([count], np.int64)
        sizes = np.array([40], np.int64)
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = _library().tiff_decode_blocks(data, len(data), offsets.ctypes.data, counts.ctypes.data,
                                           sizes.ctypes.data, 1, 32773, 0, 0, 1, 40, 1, 1,
                                           out.ctypes.data, err, _ERR_LEN)
        assert rc == -1 and err.value == b"TIFF strip or tile lies past the file", (offset, count)
    offsets, counts = np.array([0], np.int64), np.array([len(data)], np.int64)
    assert _library().tiff_decode_blocks(data, len(data), offsets.ctypes.data, counts.ctypes.data,
                                         sizes.ctypes.data, 1, 32773, 0, 0, 1, 40, 1, 1,
                                         out.ctypes.data, err, _ERR_LEN) == 0
    assert out.tobytes() == bytes(range(40))


def test_mapped_strip_past_the_file_refused():
    """A lone uncompressed 16×112 tile of a 10×100 image, turned by the
    Orientation tag, at the end of the file: PIL's mapping checks 10 rows of
    the tile's 16-byte stride, then reads rows of 100 bytes, past the file's
    end. The port refuses the file rather than read memory it does not
    own; with the file 44 bytes longer, it reads the rows as PIL does."""
    entries = [(256, 4, (10,)), (257, 4, (100,)), (258, 3, (8,)), (259, 3, (1,)),
               (262, 3, (1,)), (274, 3, (6,)), (277, 3, (1,)), (322, 4, (16,)),
               (323, 4, (112,))]
    head = len(K.tiff(entries, [b""], offsets_tag=324, counts_tag=325, offsets=(0,)))
    data = K.tiff(entries, [b""], offsets_tag=324, counts_tag=325, offsets=(head,)) + bytes(200)
    with pytest.raises(ValueError, match="TIFF strip mapped past the end of the file"):
        decode_tiff(data)
    full = K.tiff(entries, [b""], offsets_tag=324, counts_tag=325,
                  offsets=(head,)) + bytes(range(244))  # the last row inside: read as PIL reads it
    np.testing.assert_array_equal(decode_tiff(full), _pil(full))


@pytest.mark.parametrize("stem", GOOD)
def test_cut_files_as_pil(stem):
    """Each fixture cut at 8 places: refused or decoded as PIL does (a cut
    that leaves PIL and libtiff different views of the IFD goes to PIL)."""
    data = (FIXTURES / f"{stem}.tif").read_bytes()
    rs = np.random.default_rng(len(data))
    for cut in sorted(set(rs.integers(8, len(data), 7).tolist() + [len(data) - 1])):
        _same_outcome(data[:cut], ("cut", cut))


LAYOUTS = [  # (photometric, bits, samples, extra samples, sample format)
    (1, 8, 1, (), None), (0, 8, 1, (), None), (1, 1, 1, (), None), (0, 1, 1, (), None),
    (1, 2, 1, (), None), (1, 4, 1, (), None), (0, 4, 1, (), None), (1, 16, 1, (), None),
    (0, 16, 1, (), None), (1, 16, 1, (), 2), (1, 32, 1, (), 3), (1, 32, 1, (), 1),
    (1, 32, 1, (), 2), (2, 8, 3, (), None), (2, 8, 4, (2,), None), (2, 8, 4, (1,), None),
    (2, 8, 4, (0,), None), (2, 8, 4, (), None), (2, 8, 5, (1, 0), None), (2, 16, 3, (), None),
    (2, 16, 4, (1,), None), (2, 16, 4, (2,), None), (3, 8, 1, (), None), (3, 4, 1, (), None),
    (3, 1, 1, (), None), (3, 2, 1, (), None), (5, 8, 4, (), None), (5, 16, 4, (), None),
    (1, 8, 2, (2,), None), (3, 8, 2, (2,), None), (3, 8, 2, (0,), None), (1, 8, 1, (), 2),
    (2, 8, 6, (2, 0, 0), None)]


@pytest.mark.parametrize("chunk", range(4))
def test_random_layouts_as_pil(chunk):
    """Random images of every layout above through ``tiffkit``: byte order,
    compression, predictor, strips or tiles, planes, FillOrder, Orientation
    and BigTIFF drawn at random: refused or decoded as PIL does."""
    rs = np.random.default_rng(chunk)
    held = 0
    for t in range(chunk * 60, chunk * 60 + 60):
        photo, bits, spp, extra, sf = LAYOUTS[t % len(LAYOUTS)]
        h, w = int(rs.integers(1, 20)), int(rs.integers(1, 20))
        if sf == 3:
            s = rs.normal(120, 100, (h, w, spp)).astype(np.float32)
        elif sf == 2:
            s = rs.integers(-(1 << (bits - 1)), 1 << (bits - 1), (h, w, spp))
        else:
            s = rs.integers(0, 1 << bits, (h, w, spp))
        comp = [1, 5, 8, 32946, 32773][int(rs.integers(0, 5))]
        kw = dict(order=["II", "MM"][int(rs.integers(0, 2))], compression=comp, photometric=photo,
                  extra=extra, sample_format=sf,
                  predictor=2 if bits >= 8 and rs.random() < 0.4 else 1)
        if rs.random() < 0.3:
            kw["tile"] = (16 * int(rs.integers(1, 3)), 16 * int(rs.integers(1, 3)))
        elif rs.random() < 0.5:
            kw["rows_per_strip"] = int(rs.integers(1, h + 3))
        if spp > 1 and rs.random() < 0.25:
            kw["planar"] = 2
        if rs.random() < 0.15:
            kw["fillorder"] = 2
        if rs.random() < 0.15:
            kw["orientation"] = int(rs.integers(1, 9))
        if rs.random() < 0.1:
            kw["big"] = True
        if photo == 3:
            kw["colormap"] = tuple(int(x) for x in rs.integers(0, 65536, 3 * (1 << bits)))
        held += _same_outcome(K.image(s, bits, **kw), (t, kw))
    assert held >= 55  # the port decides nearly all of them itself


def test_decompression_bomb_refused_as_pil(tmp_path):
    """An IFD past twice PIL's ``MAX_IMAGE_PIXELS`` is refused with PIL's
    message, from the IFD."""
    data = K.tiff([(256, 4, (40000,)), (257, 4, (30000,)), (258, 3, (8,)), (259, 3, (5,)),
                   (262, 3, (1,)), (278, 4, (30000,))], [bytes(16)])
    with pytest.raises(Image.DecompressionBombError) as pil:
        Image.open(io.BytesIO(data))
    path = tmp_path / "bomb.tif"
    path.write_bytes(data)
    with pytest.raises(ValueError) as port:
        read_image_rgb(str(path))
    assert str(port.value) == f"{path}: {pil.value}"


@pytest.mark.parametrize("typ", [1, 2, 5, 11, 12, 14])
def test_tag_types_other_than_integers_go_to_pil(typ):
    """A width tag of a type other than an integer's: the port leaves the
    file to PIL (whatever PIL then makes of it), or, for a type PIL drops,
    refuses it as PIL does (no width)."""
    data = K.image(np.zeros((4, 6, 1), np.uint8), 8, more=((256, typ, b"\x06\x00\x00\x00"),))
    try:
        decode_tiff(data)
        outcome = "decoded"
    except NeedsPil:
        outcome = "pil"
    except ValueError:
        outcome = "refused"
    assert outcome == ("refused" if typ == 14 else "pil")
    if outcome == "refused":
        assert _pil(data) is None


@st.composite
def _pil_writes(draw):
    mode = draw(st.sampled_from(["RGB", "L", "RGBA", "I;16", "P", "CMYK", "F", "1", "LA"]))
    comp = draw(st.sampled_from(["raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
                                 "packbits"]))
    predictor = draw(st.sampled_from([None, 2])) if mode != "1" else None
    w, h = draw(st.integers(1, 40)), draw(st.integers(1, 30))
    rows = draw(st.sampled_from([None, 1, 3, 16]))
    rs = np.random.default_rng(draw(st.integers(0, 2**31)))
    v = rs.integers(0, 256, (h, w, 4)).astype(np.uint8)
    if draw(st.booleans()):  # runs and gradients, which LZW and PackBits shorten
        v[:, : w // 2] = v[:, :1]
    img = Image.fromarray(v, "RGBA")
    if mode == "I;16":
        img = Image.fromarray(v[..., 0].astype(np.uint16) * int(rs.integers(1, 300)))
    elif mode == "F":
        img = Image.fromarray(v[..., 0].astype(np.float32) * 1.7 - 100)
    elif mode == "1":
        img = Image.fromarray(v[..., 0] > 128)
    elif mode == "P":
        img = img.convert("RGB").quantize(int(rs.integers(2, 200)))
    elif mode != "RGBA":
        img = img.convert(mode)
    info = {317: predictor} if predictor else {}
    if rows:
        info[278] = rows
    return img, comp, info


@settings(max_examples=80, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_pil_writes())
def test_pil_writes_round_trip(case):
    """PIL's TIFF writes (libtiff for LZW, Deflate and PackBits) of modes
    RGB, L, RGBA, I;16, P, CMYK, F, 1 and LA, with and without predictor 2,
    in strips of 1-16 rows or one: the port reads each as PIL does."""
    img, comp, info = case
    b = io.BytesIO()
    img.save(b, "TIFF", compression=comp, tiffinfo=info)
    assert _same_outcome(b.getvalue(), (img.mode, comp, info))
