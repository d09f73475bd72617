"""The port's JPEG decoder (``utils/jpeg.py`` over ``native/jpeg_decoder.cpp``)
against PIL's ``Image.open(p).convert("RGB")`` (libjpeg-turbo), bit for bit
(``np.array_equal``), on PIL-encoded images: subsampling 4:4:4, 4:2:2 and
4:2:0 at qualities 10, 75 and 95 with and without ``optimize``, progressive,
restart intervals, L and CMYK, EXIF and ICC segments, odd and tiny sizes, a
hypothesis sweep; files edited byte by byte for what PIL does not write (RGB
component ids, Adobe transforms, YCCK, missing Huffman tables, bytes before
a marker, a short data segment); the other sampling factors through OpenCV's
encoder; and the committed files PIL cannot write (``tests/data/jpeg``'s
``make_fixtures.py``): arithmetic-coded sequential and progressive files,
lossless files with each predictor, and progressive files that libjpeg
block-smooths, whole, cut short and corrupted. What PIL refuses too raises
naming the file and the SOF marker; ``read_image_rgb`` dispatches on magic
bytes; the committed fixtures equal PIL's decodes.
"""
import hashlib
import io
import itertools
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from test_torch_common import REPO, one_thread  # noqa: F401
from vavae_tpu_torch.utils.jpeg import decode_jpeg, jpeg_refusal, read_jpeg
from vavae_tpu_torch.utils.png import encode_png, read_image_rgb, read_png, refused_images

pytestmark = pytest.mark.usefixtures("one_thread")

FIXTURES = REPO / "tests" / "data" / "jpeg"


def _image(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """Gradients, flat areas and noise: every DCT band gets coefficients."""
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 7 + yy * 3, xx * yy // 3, 255 - xx * 5 + yy * 2, (xx + yy) * 4][:channels], -1)
    img = (base % 256 + rs.integers(-40, 41, base.shape)).clip(0, 255)
    img[h // 2:, : w // 3] = img[h // 2:, : w // 3] // 32 * 32
    return img.astype(np.uint8)


def _encode(img, mode: str = "RGB", **kw) -> bytes:
    im = Image.frombytes(mode, img.shape[1::-1], np.ascontiguousarray(img).tobytes())
    b = io.BytesIO()
    im.save(b, "JPEG", **kw)
    return b.getvalue()


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _assert_pil_equal(data: bytes) -> None:
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, _pil(data))


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_sequential_matches_pil(subsampling, quality, optimize):
    for h, w in ((37, 29), (64, 48)):
        _assert_pil_equal(_encode(_image(h, w, quality + h), quality=quality,
                                  subsampling=subsampling, optimize=optimize))


@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_progressive_matches_pil(subsampling, quality):
    for h, w in ((37, 29), (48, 80)):
        _assert_pil_equal(_encode(_image(h, w, quality + w), quality=quality,
                                  subsampling=subsampling, progressive=True))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1}, {"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1}, {"restart_marker_rows": 2}],
                         ids=["blocks1", "blocks3", "rows1", "rows2"])
def test_restart_intervals_match_pil(restart, progressive):
    for ss in (0, 2):
        _assert_pil_equal(_encode(_image(45, 61, 3), quality=80, subsampling=ss,
                                  progressive=progressive, **restart))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("mode", ["L", "CMYK"])
def test_gray_and_cmyk_match_pil(mode, progressive):
    for q in (10, 75, 95):
        img = _image(29, 37, q, 4)
        img = img[..., 0].copy() if mode == "L" else img
        _assert_pil_equal(_encode(img, mode, quality=q, progressive=progressive))


@pytest.mark.parametrize("hw", [(1, 1), (2, 2), (17, 8), (8, 17), (37, 29), (3, 130)])
def test_sizes_match_pil(hw):
    for ss, prog in itertools.product((0, 1, 2), (False, True)):
        _assert_pil_equal(_encode(_image(*hw, seed=sum(hw)), quality=85, subsampling=ss,
                                  progressive=prog))


def test_exif_and_icc_segments_are_skipped():
    exif = Image.Exif()
    exif[0x010E] = "a description"
    data = _encode(_image(33, 47, 4), quality=80, exif=exif.tobytes(),
                   icc_profile=bytes(range(256)) * 300)  # spans two APP2 segments
    assert data.count(b"ICC_PROFILE") == 2
    _assert_pil_equal(data)


@settings(max_examples=40, deadline=None, database=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), quality=st.integers(1, 100),
       subsampling=st.sampled_from([0, 1, 2]), progressive=st.booleans(),
       optimize=st.booleans(), mode=st.sampled_from(["RGB", "L", "CMYK"]),
       restart=st.integers(0, 3), seed=st.integers(0, 2**16))
def test_hypothesis_sweep_matches_pil(h, w, quality, subsampling, progressive, optimize, mode,
                                      restart, seed):
    img = _image(h, w, seed, 4)
    img = img[..., 0].copy() if mode == "L" else (img[..., :3].copy() if mode == "RGB" else img)
    kw = {"restart_marker_blocks": restart} if restart else {}
    _assert_pil_equal(_encode(img, mode, quality=quality, subsampling=subsampling,
                              progressive=progressive, optimize=optimize, **kw))


@pytest.mark.parametrize("factor", ["411", "440", "420", "422", "444"])
def test_other_sampling_factors_match_pil(factor):
    """4:4:0 (turbo's h1v2 filter) and 4:1:1 (replication) come from OpenCV's
    encoder, which PIL's lacks."""
    cv2 = pytest.importorskip("cv2")
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")
    for h, w in ((37, 29), (16, 16), (5, 70)):
        ok, buf = cv2.imencode(".jpg", _image(h, w, 9), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
        assert ok
        _assert_pil_equal(buf.tobytes())


# -- files edited byte by byte ----------------------------------------------------------------


def _segments(data: bytes) -> list:
    """(marker, bytes) of each segment up to and including the first SOS
    (which carries the rest of the file)."""
    out, i = [], 2
    while True:
        m = data[i + 1]
        if m == 0xDA:
            return out + [(m, data[i:])]
        n = int.from_bytes(data[i + 2:i + 4], "big")
        out.append((m, data[i:i + 2 + n]))
        i += 2 + n


def _join(segs) -> bytes:
    return b"\xff\xd8" + b"".join(s for _, s in segs)


def _with_ids(segs, ids: bytes):
    out = []
    for m, s in segs:
        s = bytearray(s)
        for k in range(3):
            if m == 0xC0:
                s[10 + 3 * k] = ids[k]
            elif m == 0xDA:
                s[5 + 2 * k] = ids[k]
        out.append((m, bytes(s)))
    return out


def _adobe(transform: int):
    return 0xEE, b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([transform])


@pytest.fixture(scope="module")
def rgb_segments():
    return _segments(_encode(_image(29, 37, 5), quality=90))


def test_colour_space_rules_match_pil(rgb_segments):
    """3 components are YCbCr unless, without a JFIF marker, an Adobe
    transform 0 or the ids 'R', 'G', 'B' say RGB (libjpeg's rules)."""
    no_jfif = [(m, s) for m, s in rgb_segments if m != 0xE0]
    cases = {"rgb ids": _with_ids(no_jfif, b"RGB"), "rgb ids + jfif": _with_ids(rgb_segments, b"RGB"),
             "other ids": _with_ids(no_jfif, b"ABC"), "adobe 0": [_adobe(0)] + no_jfif,
             "adobe 1": [_adobe(1)] + no_jfif, "adobe 0 + jfif": [_adobe(0)] + rgb_segments}
    for segs in cases.values():
        _assert_pil_equal(_join(segs))
    # the RGB reading really differs from the YCbCr one
    assert not np.array_equal(decode_jpeg(_join(cases["rgb ids"])), decode_jpeg(_join(no_jfif)))


def test_ycck_and_cmyk_without_adobe_match_pil():
    segs = _segments(_encode(_image(29, 37, 6, 4), "CMYK", quality=90))
    transform = lambda t: [(m, s[:-1] + bytes([t]) if m == 0xEE else s) for m, s in segs]  # noqa: E731
    for case in (transform(2), transform(1), [(m, s) for m, s in segs if m != 0xEE]):
        _assert_pil_equal(_join(case))


def test_missing_huffman_tables_default_to_the_standard_ones(rgb_segments):
    """PIL without ``optimize`` writes the standard tables; without its DHT
    segments libjpeg (and the port) falls back to them."""
    _assert_pil_equal(_join([(m, s) for m, s in rgb_segments if m != 0xC4]))


def test_bytes_before_a_marker_are_skipped(rgb_segments):
    for junk in (b"\x00\x12\x34", b"\xff\xff\xff", b"\xff\x00\x55"):
        _assert_pil_equal(_join([(m, junk + s if m == 0xDB else s) for m, s in rgb_segments]))


def test_short_data_segment_and_missing_eoi_match_pil():
    """A scan cut short and closed by EOI leaves the rest undecoded, as in
    libjpeg; a sequential file without its EOI reads whole (libjpeg has all
    its bits; PIL reads such a file or not depending on its buffering)."""
    data = _encode(_image(40, 56, 7), quality=90)
    for tenths in (3, 5, 8):  # PIL itself reads these cuts (not every cut)
        _assert_pil_equal(data[:len(data) * tenths // 10] + b"\xff\xd9")
    np.testing.assert_array_equal(decode_jpeg(data[:-2]), _pil(data))


def _sof_as(data: bytes, marker: int, precision: int = 8) -> bytes:
    segs = _segments(data)
    out = []
    for m, s in segs:
        if m in (0xC0, 0xC2):
            s = bytes([0xFF, marker]) + s[2:4] + bytes([precision]) + s[5:]
        out.append((m, s))
    return _join(out)


@pytest.mark.parametrize("marker,kind", [
    (0xC9, "arith_444_restart.jpg"), (0xCA, "arith_prog_420_dac.jpg"),
    (0xC3, "lossless_rgb_psv1.jpg"), (0xC5, "hierarchical"), (0xC7, "hierarchical"),
    (0xCB, "arithmetic-coded lossless")])
def test_unsupported_files_raise(marker, kind):
    """Arithmetic-coded (SOF9, SOF10) and lossless (SOF3) files decode as PIL
    decodes them; hierarchical and arithmetic-coded lossless SOF markers,
    which PIL refuses too, raise naming the file and the marker."""
    if kind.endswith(".jpg"):
        data = (FIXTURES / kind).read_bytes()
        assert marker in [m for m, _ in _segments(data)]
        _assert_pil_equal(data)
        return
    data = _sof_as(_encode(_image(16, 16, 8), quality=80), marker)
    with pytest.raises(ValueError, match=f"x.jpg: unsupported JPEG: SOF marker 0x{marker:02X} "
                                         rf"\(.*{kind}"):
        decode_jpeg(data, "x.jpg")
    with pytest.raises(OSError):
        _pil(data)


def test_12_bit_and_broken_files_raise(tmp_path):
    data = _encode(_image(16, 16, 8), quality=80)
    with pytest.raises(ValueError, match="SOF marker 0xC1 with 12-bit samples"):
        decode_jpeg(_sof_as(data, 0xC1, 12), "x.jpg")
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match=f"{path}: truncated JPEG file"):
        read_jpeg(str(path))
    with pytest.raises(ValueError, match="not a JPEG file"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")
    prog = _encode(_image(40, 40, 9), quality=80, progressive=True)
    _assert_pil_equal(prog[:len(prog) * 2 // 3] + b"\xff\xd9")  # smoothed, as libjpeg smooths


def _with_jfif(data: bytes) -> bytes:
    return data[:2] + b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00" + data[2:]


def test_refused_jpegs_names_what_the_decoder_refuses(tmp_path):
    """From the markers before the data: an arithmetic-coded lossless SOF, a
    12-bit one, a hierarchical one behind 20 KB of APP1 and a lossless frame
    in YCbCr (libjpeg converts no colour in a lossless file) are named with
    ``read_jpeg``'s own message, and PIL refuses each of them too; a
    sequential and a progressive file, an arithmetic-coded, a lossless and a
    block-smoothed one, a PNG under a ``.JPEG`` name and a truncated file
    (PIL refuses it too) are not."""
    base = _encode(_image(24, 24, 10), quality=80)
    prog = _encode(_image(40, 40, 9), quality=80, progressive=True)
    late = _join([(0xE1, b"\xff\xe1" + (20002).to_bytes(2, "big") + bytes(20000))]
                 + _segments(base))
    lossless = (FIXTURES / "lossless_420_psv4.jpg").read_bytes()
    files = {"arith_lossless.jpg": _sof_as(base, 0xCB), "12bit.jpg": _sof_as(base, 0xC1, 12),
             "late_hierarchical.jpg": _sof_as(late, 0xC5), "ycc_lossless.jpg": _with_jfif(lossless),
             "base.jpg": base, "prog.jpg": prog, "late.jpg": late, "lossless.jpg": lossless,
             "arith.jpg": (FIXTURES / "arith_prog_444.jpg").read_bytes(),
             "unrefined.jpg": prog[:len(prog) * 2 // 3] + b"\xff\xd9",
             "png.JPEG": encode_png(_image(8, 8, 1)), "cut.jpg": prog[:len(prog) // 2]}
    paths = []
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        paths.append(str(tmp_path / name))
    got = refused_images(paths)
    assert [os.path.basename(p) for p, _ in got] == ["arith_lossless.jpg", "12bit.jpg",
                                                     "late_hierarchical.jpg", "ycc_lossless.jpg"]
    for path, why in got:
        assert jpeg_refusal(path) == why
        with pytest.raises(ValueError) as e:
            read_jpeg(path)
        assert str(e.value) == f"{path}: {why}"
        with pytest.raises(OSError):
            with Image.open(path) as im:
                im.convert("RGB")
    for path in paths[4:11]:
        read_image_rgb(path)


# libjpeg-turbo's C decoder: PIL with its x86 SIMD off, which would otherwise
# run an inverse DCT that rounds the out-of-range coefficients of corrupt
# data its own way (for valid data the two agree bit for bit)
_PIL_C_DECODES = """
import hashlib, io, sys
import numpy as np
from PIL import Image
data = open(sys.argv[1], "rb").read()
def digest(c):
    try:
        with Image.open(io.BytesIO(c)) as im:
            a = np.ascontiguousarray(im.convert("RGB"))
        return hashlib.sha1(repr(a.shape).encode() + a.tobytes()).hexdigest()
    except Exception:
        return "-"
for pos in range(3, len(data)):
    for mask in (0x01, 0xFF):
        c = bytearray(data)
        c[pos] ^= mask
        got = digest(bytes(c))
        print(got, digest(bytes(c) + b"\\xff\\xd9") if got == "-" else "=")
"""


@pytest.mark.parametrize("name", ["restart_rows_q75.jpg", "progressive_restart_blocks.jpg",
                                  "arith_prog_gray_restart_dac.jpg", "arith_444_restart.jpg",
                                  "lossless_rgb_psv6_pt2_restart.jpg", "smooth_dc_al1.jpg"])
def test_corrupt_files_decode_as_libjpeg_does(name, tmp_path):
    """A committed fixture (Huffman sequential and progressive,
    arithmetic-coded sequential and progressive, lossless, block-smoothed)
    corrupted byte by byte after its magic bytes (each byte's lowest bit,
    then all its bits, flipped): bad Huffman codes, arithmetic overflows,
    restart markers out of order, markers in the data, broken segments.
    Where libjpeg-turbo's C decoder keeps the image, the port gives the same
    pixels, or refuses a file ``jpeg_refusal`` names beforehand. Where it
    refuses, so does the port, except for a sequential file that has lost
    its EOI marker: the port reads it as libjpeg reads it with the marker
    put back (libjpeg's bit buffer asks for bytes past the end, and PIL's
    buffering decides)."""
    path = FIXTURES / name
    env = dict(os.environ, JSIMD_FORCENONE="1")
    out = subprocess.run([sys.executable, "-c", _PIL_C_DECODES, str(path)], env=env,
                         capture_output=True, text=True, check=True).stdout.split()
    data = path.read_bytes()
    want, closed = out[::2], out[1::2]
    assert len(want) == len(closed) == 2 * (len(data) - 3)
    variants = ((pos, mask) for pos in range(3, len(data)) for mask in (0x01, 0xFF))
    named = 0
    for (pos, mask), w, wc in zip(variants, want, closed):
        c = bytearray(data)
        c[pos] ^= mask
        try:
            a = decode_jpeg(bytes(c))
            got = hashlib.sha1(repr(a.shape).encode() + a.tobytes()).hexdigest()
        except ValueError:
            got = "-"
        if got != w and w == "-":
            assert got == wc, f"byte {pos} ^ {mask:#x}: the port decodes what libjpeg refuses"
        elif got != w:
            assert got == "-", f"byte {pos} ^ {mask:#x}: the port decodes differently"
            (tmp_path / "c.jpg").write_bytes(bytes(c))
            assert jpeg_refusal(str(tmp_path / "c.jpg")), f"byte {pos} ^ {mask:#x}: refused unnamed"
            named += 1
    assert named < len(want) // 50


_PIL_C_CUTS = """
import hashlib, io, sys
import numpy as np
from PIL import Image
data = open(sys.argv[1], "rb").read()
for cut in range(int(sys.argv[2]), len(data) - 2, int(sys.argv[3])):
    try:
        with Image.open(io.BytesIO(data[:cut] + b"\\xff\\xd9")) as im:
            a = np.ascontiguousarray(im.convert("RGB"))
        print(hashlib.sha1(repr(a.shape).encode() + a.tobytes()).hexdigest())
    except Exception:
        print("-")
"""


@pytest.mark.parametrize("name", ["progressive_420_q85.jpg", "smooth_ac_unrefined.jpg",
                                  "smooth_dc_al1.jpg", "arith_prog_420_dac.jpg",
                                  "arith_444_restart.jpg", "lossless_gray_psv5_pt2.jpg"])
def test_cut_files_decode_as_libjpeg_does(name):
    """A committed fixture cut short at every 37th byte and closed by EOI, as
    libjpeg-turbo's C decoder reads it (PIL with its SIMD off): the rest of
    a Huffman scan undecoded, an arithmetic one fed zeros, and a progressive
    file smoothed with the coefficient bits of its scans, those before the
    last scan in the iMCU rows after the one where its data ran out."""
    path = FIXTURES / name
    env = dict(os.environ, JSIMD_FORCENONE="1")
    want = subprocess.run([sys.executable, "-c", _PIL_C_CUTS, str(path), "150", "37"], env=env,
                          capture_output=True, text=True, check=True).stdout.split()
    data = path.read_bytes()
    cuts = range(150, len(data) - 2, 37)
    assert len(want) == len(cuts) and want.count("-") < len(want) // 4
    for cut, w in zip(cuts, want):
        try:
            a = decode_jpeg(data[:cut] + b"\xff\xd9")
            got = hashlib.sha1(repr(a.shape).encode() + a.tobytes()).hexdigest()
        except ValueError:
            got = "-"
        assert got == w, f"cut at {cut}"


def _format_fixtures() -> list:
    return [e["file"] for e in json.loads((FIXTURES / "manifest.json").read_text())["fixtures"]
            if e["file"].startswith(("arith_", "lossless_", "smooth_"))]


@pytest.mark.parametrize("name", _format_fixtures())
def test_format_fixtures_match_pil(name):
    """Each arithmetic-coded, lossless and block-smoothed fixture: the port's
    decode equals PIL's, and PIL's committed decode."""
    entry = next(e for e in _manifest()["fixtures"] if e["file"] == name)
    data = (FIXTURES / name).read_bytes()
    got = decode_jpeg(data, name)
    np.testing.assert_array_equal(got, _pil(data))
    if "decode" in entry:
        np.testing.assert_array_equal(got, read_png(str(FIXTURES / entry["decode"])))
    else:
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["decode_sha256"]


def test_read_image_rgb_dispatches_on_magic_bytes(tmp_path):
    """ImageNet holds a PNG named ``.JPEG``; the name does not decide."""
    img = _image(20, 30, 10)
    Image.fromarray(img).save(tmp_path / "png.JPEG", "PNG")
    jpeg = _encode(img, quality=90)
    (tmp_path / "jpeg.png").write_bytes(jpeg)
    np.testing.assert_array_equal(read_image_rgb(str(tmp_path / "png.JPEG")), img)
    np.testing.assert_array_equal(read_image_rgb(str(tmp_path / "jpeg.png")), _pil(jpeg))


def test_threads_decode_in_parallel_and_agree():
    datas = [_encode(_image(64 + i, 80, i), quality=70 + i, progressive=bool(i % 2))
             for i in range(16)]
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(decode_jpeg, datas * 4))
    for d, g in zip(datas * 4, got):
        np.testing.assert_array_equal(g, _pil(d))


# -- the committed fixtures -------------------------------------------------------------------


def _manifest() -> dict:
    return json.loads((FIXTURES / "manifest.json").read_text())


def test_committed_fixtures_equal_pil_decodes():
    """Each committed decode is PIL's decode of its file (the card's machine,
    where PIL is not a stated package, holds the port's decoder to them), and the port's
    decoder equals both."""
    for entry in _manifest()["fixtures"]:
        path = str(FIXTURES / entry["file"])
        with Image.open(path) as im:
            want = np.ascontiguousarray(np.asarray(im.convert("RGB")))
        assert list(want.shape) == entry["shape"]
        if "decode" in entry:
            np.testing.assert_array_equal(read_png(str(FIXTURES / entry["decode"])), want)
        else:
            assert hashlib.sha256(want.tobytes()).hexdigest() == entry["decode_sha256"]
        np.testing.assert_array_equal(read_image_rgb(path), want)


def test_committed_imagenet_crops_match_the_port(tmp_path):
    """The tree of the manifest through the port's ``ImageNetValidation``:
    its ``filelist.txt``, items and labels equal the committed ones (made by
    the JAX package's class over PIL)."""
    from vavae_tpu_torch.data.ldm_datasets import ImageNetValidation

    m = _manifest()
    for t in m["tree"]:
        dst = tmp_path / t["path"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes((FIXTURES / t["file"]).read_bytes())
    want = np.load(FIXTURES / "imagenet_val_crops.npz")
    ds = ImageNetValidation(str(tmp_path), size=m["crop_size"])
    assert (tmp_path / "filelist.txt").read_text() == m["filelist"]
    assert [os.path.relpath(p, tmp_path) for p, _ in ds.items] == list(want["paths"])
    for i in range(len(ds)):
        x, y = ds[i]
        crop = want["crops"][want["fixture"][i]]
        np.testing.assert_array_equal(x, (crop / 127.5 - 1.0).astype(np.float32))
        assert y == want["labels"][i]


# -- the decompression-bomb bound (PIL's, from the frame header) ---------------------------------


def _sized(data: bytes, h: int, w: int) -> bytes:
    """``data`` with its SOF0 frame saying h × w pixels."""
    sof = data.index(b"\xff\xc0")
    return data[:sof + 5] + h.to_bytes(2, "big") + w.to_bytes(2, "big") + data[sof + 9:]


def test_bomb_jpeg_is_refused_as_pil_refuses_it(tmp_path):
    """A baseline JPEG of a few hundred bytes whose SOF0 says 13,400 ×
    13,400 = 179,560,000 pixels: refused from the frame header with PIL's
    message before anything is allocated by the pixel, and named by
    ``refused_images``."""
    path = tmp_path / "bomb.jpg"
    path.write_bytes(_sized(_encode(_image(8, 8, 11), quality=90), 13400, 13400))
    assert path.stat().st_size < 1000
    with pytest.raises(Image.DecompressionBombError) as pil:
        Image.open(path)
    want = str(pil.value)
    assert want.startswith("Image size (179560000 pixels) exceeds limit of 178956970 pixels")
    with pytest.raises(ValueError) as e:
        read_image_rgb(str(path))
    assert str(e.value) == f"{path}: {want}"
    assert jpeg_refusal(str(path)) == want
    assert refused_images([str(path)]) == [(str(path), want)]


@pytest.mark.parametrize("h,refused", [(2731, True), (2730, False)])
def test_bomb_bound_boundary_jpeg(tmp_path, h, refused):
    """65,535 × 2,731 = 178,976,085 pixels lies past 2 × MAX_IMAGE_PIXELS =
    178,956,970 and is refused; 65,535 × 2,730 = 178,910,550 is not. Held
    on the header check alone (also behind 20 KB of APP1, past the first
    16 KiB that ``refused_images`` reads), as PIL's ``Image.open`` holds
    it, so no 179 M pixels are decoded."""
    base = _encode(_image(8, 8, 12), quality=90)
    late = _join([(0xE1, b"\xff\xe1" + (20002).to_bytes(2, "big") + bytes(20000))]
                 + _segments(base))
    for i, data in enumerate((base, late)):
        path = tmp_path / f"edge{i}.jpg"
        path.write_bytes(_sized(data, h, 65535))
        if refused:
            with pytest.raises(Image.DecompressionBombError) as pil:
                Image.open(path)
            assert refused_images([str(path)]) == [(str(path), str(pil.value))]
            with pytest.raises(ValueError, match="decompression bomb"):
                read_jpeg(str(path))
        else:
            with pytest.warns(Image.DecompressionBombWarning), Image.open(path) as im:
                assert im.size == (65535, h)  # opened (a warning only), as the port passes it
            assert jpeg_refusal(str(path)) is None and refused_images([str(path)]) == []
