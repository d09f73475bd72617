"""The port's WebP decoder (``utils/webp.py`` over
``native/webp_decoder.cpp``) against PIL's ``Image.open(p).convert("RGB")``
(libwebp 1.6 through ``WebPAnimDecoder``), bit for bit: the committed
fixtures (``tests/data/webp/make_fixtures.py``: lossy files at several
qualities and sizes, the encoder options PIL cannot set, alpha raw and
VP8L-compressed with each filter, lossless files through each transform,
VP8X with metadata, animations with an offset first frame), a sweep of
PIL's own encodes, and files cut short, corrupted and re-wrapped, which the
port refuses exactly where PIL does. ``read_image_rgb`` dispatches on the
RIFF magic, and an LSUN filelist of WebP files gives the JAX package's
items.
"""
import io
import random
import shutil
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from test_torch_common import REPO, one_thread  # noqa: F401
from test_torch_jpeg import _image
from vavae_tpu.data import ldm_datasets as jax_ldm
from vavae_tpu_torch.data import ldm_datasets as port_ldm
from vavae_tpu_torch.utils import png as png_module
from vavae_tpu_torch.utils.jpeg import CHECK_HEAD
from vavae_tpu_torch.utils.png import read_image_rgb, refused_images
from vavae_tpu_torch.utils.webp import decode_webp, webp_facts, webp_refusal

pytestmark = pytest.mark.usefixtures("one_thread")

FIXTURES = REPO / "tests" / "data" / "webp"
STEMS = sorted(p.stem for p in FIXTURES.glob("*.webp"))


@pytest.fixture(scope="module")
def expected():
    return dict(np.load(FIXTURES / "expected.npz"))


def _pil(data: bytes, mode: str = "RGB"):
    """PIL's decode, or None where PIL refuses the file."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert(mode))
    except Exception:  # noqa: BLE001 - any refusal of PIL's
        return None


def _port(data: bytes):
    try:
        return decode_webp(data)
    except ValueError:
        return None


def _same_outcome(data: bytes, what) -> None:
    want, got = _pil(data), _port(data)
    assert (want is None) == (got is None), (what, "PIL refuses" if want is None else "port refuses")
    if want is not None:
        np.testing.assert_array_equal(got, want, err_msg=str(what))


def _encode(img: np.ndarray, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "WEBP", **kw)
    return b.getvalue()


@pytest.mark.parametrize("stem", STEMS)
def test_fixtures_match_pil(stem, expected, tmp_path):
    """Each committed fixture reads bit-equal to PIL's decode, through
    ``read_image_rgb`` under a misleading name too, and (with alpha) its
    RGBA equals PIL's ``convert("RGBA")``."""
    data = (FIXTURES / f"{stem}.webp").read_bytes()
    np.testing.assert_array_equal(read_image_rgb(str(FIXTURES / f"{stem}.webp")), expected[stem])
    np.testing.assert_array_equal(_pil(data), expected[stem])
    if f"{stem}__rgba" in expected:
        np.testing.assert_array_equal(decode_webp(data, alpha=True), expected[f"{stem}__rgba"])
    named = tmp_path / f"{stem}.png"
    named.write_bytes(data)
    np.testing.assert_array_equal(read_image_rgb(str(named)), expected[stem])


def test_fixtures_cover_the_coding_tools():
    """The fixtures exercise what the decoder implements: both bitstreams,
    the four VP8L transforms, the colour cache and meta prefix codes, 1 and
    8 token partitions, the simple and normal loop filters and none,
    segment maps, skip flags, 4x4 intra modes, raw and compressed alpha
    with each filter and libwebp's 8-bit alpha path, and animations."""
    facts = [webp_facts((FIXTURES / f"{s}.webp").read_bytes()) for s in STEMS]
    assert {f["lossless"] for f in facts} == {0, 1}
    transforms = 0
    for f in facts:
        transforms |= f["transforms"]
    assert transforms == 0b1111
    assert max(f["cache_bits"] for f in facts) > 0 and max(f["prefix_groups"] for f in facts) > 1
    assert {f["partitions"] for f in facts if not f["lossless"]} == {1, 8}
    assert {f["filter_type"] for f in facts if not f["lossless"]} == {0, 1, 2}
    assert {f["segments"] for f in facts if not f["lossless"]} >= {0, 2}
    assert max(f["skip_proba"] for f in facts) == 1 and max(f["intra4"] for f in facts) > 0
    assert {f["alpha"] for f in facts} == {0, 1, 2, 3}
    assert {f["alpha_filter"] for f in facts if f["alpha"] in (1, 2)} == {0, 1, 2, 3}
    assert {f["alpha_8b"] for f in facts if f["alpha"] == 2} == {0, 1}
    assert max(f["frames"] for f in facts) == 2
    modes = 0
    for f in facts:
        modes |= f["predictor_modes"]
    assert bin(modes).count("1") >= 10, bin(modes)


@pytest.mark.parametrize("kw", [
    dict(quality=1), dict(quality=30, method=0), dict(quality=75, method=4),
    dict(quality=100, method=6), dict(lossless=True, quality=0, method=0),
    dict(lossless=True, quality=60), dict(lossless=True, quality=100, method=6),
    dict(lossless=True, exact=True), dict(quality=80, alpha_quality=50),
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("shape", [(1, 1), (37, 29), (64, 97), (3, 150)])
def test_pil_encodes_match_pil(kw, shape):
    """Noisy images, RGB and RGBA, at odd and tiny sizes, encoded by PIL."""
    for channels in (3, 4):
        data = _encode(_image(*shape, seed=shape[0] + channels, channels=channels), **kw)
        np.testing.assert_array_equal(decode_webp(data), _pil(data))
        if channels == 4:
            np.testing.assert_array_equal(decode_webp(data, alpha=True), _pil(data, "RGBA"))


CUT_STEMS = ["lossy_q50_m6", "lossy_8_partitions", "lossy_alpha_pil", "lossy_alpha_raw_filter3",
             "lossless_photo_q75", "lossless_palette_11", "lossless_rgba", "vp8x_icc_exif",
             "anim_lossy_offset", "lossy_alpha_mask"]


@pytest.mark.parametrize("stem", CUT_STEMS)
def test_cut_and_corrupt_files_refused_as_pil(stem):
    """Cut at 24 places (the RIFF size left, so the container is short, and
    rewritten, so only the bitstream is: VP8's partitions and VP8L's
    prefix codes run out), and with 40 bytes changed: PIL and the port
    refuse the same files and decode the rest alike."""
    data = (FIXTURES / f"{stem}.webp").read_bytes()
    rs = np.random.default_rng(len(data))
    simple = data[12:16] in (b"VP8 ", b"VP8L")
    cuts = sorted(set(rs.integers(12, len(data), 20).tolist() + [20, 30, len(data) - 2, len(data) - 1]))
    for cut in cuts:
        _same_outcome(data[:cut], ("cut", cut))
        if simple and cut >= 20:
            c = bytearray(data[:cut])
            c[4:8] = struct.pack("<I", cut - 8)
            c[16:20] = struct.pack("<I", cut - 20)
            _same_outcome(bytes(c), ("cut, sizes rewritten", cut))
    for _ in range(40):
        c = bytearray(data)
        i = int(rs.integers(12, len(data)))
        c[i] ^= int(rs.integers(1, 256))
        _same_outcome(bytes(c), ("byte", i))


def _fixture_writer():
    import importlib.util

    spec = importlib.util.spec_from_file_location("webp_fixtures", FIXTURES / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _fixture_writer()
_riff, _chunk, _vp8x = MAKE._riff, MAKE._chunk, MAKE._vp8x


def _container_cases():
    lossy = _encode(_image(20, 30, 1), quality=70)
    vp8 = lossy[12:]
    vp8l = _encode(_image(20, 30, 2), lossless=True)[12:]
    alph = _chunk(b"ALPH", bytes([0]) + bytes(range(200)) * 3)
    unknown = _chunk(b"ZZZZ", b"abc")
    anmf = lambda x, y, w, h, frame: _chunk(b"ANMF", (x // 2).to_bytes(3, "little")  # noqa: E731
                                            + (y // 2).to_bytes(3, "little")
                                            + (w - 1).to_bytes(3, "little")
                                            + (h - 1).to_bytes(3, "little") + bytes(4) + frame)
    anim = _chunk(b"ANIM", bytes(6))
    return {
        "simple_trailing_chunk": _riff(vp8 + unknown),
        "simple_trailing_bytes": _riff(vp8 + b"xyz"),
        "riff_longer_than_file": _riff(vp8)[:4] + struct.pack("<I", len(vp8) + 40) + _riff(vp8)[8:],
        "file_longer_than_riff": _riff(vp8) + b"\0" * 16,
        "vp8x_alpha": _riff(_vp8x(0x10, 30, 20) + alph + vp8),
        "vp8x_alph_without_flag": _riff(_vp8x(0x00, 30, 20) + alph + vp8),
        "vp8x_alph_short": _riff(_vp8x(0x10, 30, 20) + _chunk(b"ALPH", bytes([0]) + bytes(10)) + vp8),
        "vp8x_alph_bad_header": _riff(_vp8x(0x10, 30, 20) + _chunk(b"ALPH", bytes([0xC0]) + bytes(600)) + vp8),
        "vp8x_alph_then_vp8l": _riff(_vp8x(0x10, 30, 20) + alph + vp8l),
        "vp8x_unknown_between": _riff(_vp8x(0x10, 30, 20) + alph + unknown + vp8),
        "vp8x_icc_unflagged": _riff(_vp8x(0x00, 30, 20) + _chunk(b"ICCP", bytes(9)) + vp8),
        "vp8x_wrong_canvas": _riff(_vp8x(0x00, 31, 20) + vp8),
        "vp8x_bad_flags": _riff(_vp8x(0x01, 30, 20) + vp8),
        "vp8x_no_image": _riff(_vp8x(0x00, 30, 20) + _chunk(b"EXIF", bytes(8))),
        "vp8x_two_images": _riff(_vp8x(0x00, 30, 20) + vp8 + vp8),
        "anim_frame_past_canvas": _riff(_vp8x(0x02, 34, 20) + anim + anmf(6, 0, 30, 20, vp8)),
        "anim_no_anim_chunk": _riff(_vp8x(0x02, 40, 30) + anmf(0, 0, 30, 20, vp8)),
        "anim_without_flag": _riff(_vp8x(0x00, 40, 30) + anim + anmf(0, 0, 30, 20, vp8)),
        "anim_lossless_frame": _riff(_vp8x(0x02, 40, 30) + anim + anmf(8, 10, 30, 20, vp8l)),
        "not_a_vp8_chunk": _riff(unknown + vp8),
    }


@pytest.mark.parametrize("case", sorted(_container_cases()))
def test_container_cases_as_pil(case):
    """Containers written here: chunks PIL skips, ALPH under and without the
    VP8X flag, short and malformed ALPH chunks, an ALPH before a VP8L
    frame, wrong canvases and flags, frames past the canvas: refused or
    decoded as PIL does."""
    _same_outcome(_container_cases()[case], case)


def test_refusals_name_the_file(tmp_path):
    """A refused file raises ``ValueError`` naming it; ``webp_refusal``
    finds the container refusals without decoding, and passes a file whose
    only fault is in its bitstream; ``refused_images`` lists them."""
    good = FIXTURES / "lossy_q50_m6.webp"
    data = good.read_bytes()
    cut = tmp_path / "cut.webp"
    cut.write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match=str(cut)):
        read_image_rgb(str(cut))
    assert "truncated" in webp_refusal(str(cut))
    bad_bits = bytearray(data)
    bad_bits[4:8] = struct.pack("<I", len(data) // 2 - 8)
    bad_bits[16:20] = struct.pack("<I", len(data) // 2 - 20)
    inner = tmp_path / "inner.webp"
    inner.write_bytes(bytes(bad_bits[:len(data) // 2]))
    assert _pil(inner.read_bytes()) is None
    with pytest.raises(ValueError, match="premature end"):
        read_image_rgb(str(inner))
    assert webp_refusal(str(inner)) is None and webp_refusal(str(good)) is None
    assert [p for p, _ in refused_images([str(good), str(cut), str(inner)])] == [str(cut)]


def _bombs():
    """A VP8 header of 16383x16383 and an animation's 2^24x255 canvas over a
    1x1 first frame: each past PIL's decompression-bomb bound."""
    one = (FIXTURES / "lossy_1x1.webp").read_bytes()
    vp8 = bytearray(one[12:])
    vp8[14:18] = struct.pack("<HH", 16383, 16383)
    anmf = _chunk(b"ANMF", bytes(16) + one[12:])
    return {"vp8_16383x16383": _riff(bytes(vp8)),
            "anim_canvas_2p24x255": _riff(_vp8x(0x02, 1 << 24, 255) + _chunk(b"ANIM", bytes(6))
                                          + anmf)}


@pytest.mark.parametrize("case", sorted(_bombs()))
def test_decompression_bombs_refused_as_pil(case, tmp_path):
    """A canvas past twice PIL's ``MAX_IMAGE_PIXELS`` is refused from the
    header, with PIL's message, before anything is allocated for it."""
    data = _bombs()[case]
    with pytest.raises(Image.DecompressionBombError) as pil:
        Image.open(io.BytesIO(data))
    path = tmp_path / "bomb.webp"
    path.write_bytes(data)
    with pytest.raises(ValueError) as port:
        read_image_rgb(str(path))
    assert str(port.value) == f"{path}: {pil.value}"
    assert webp_refusal(str(path)) == str(pil.value)


def _counting_open(counts: dict):
    """``open`` whose files add the bytes each read returns to ``counts``."""
    class Counted(io.BufferedReader):
        def read(self, n=-1):
            data = super().read(n)
            counts[self.name] = counts.get(self.name, 0) + len(data)
            return data

    return lambda path, mode="rb": Counted(io.FileIO(path, mode.replace("b", "")))


def test_refused_images_reads_heads_only(tmp_path, monkeypatch):
    """``refused_images`` reads the first 16 KiB of a PNG, a baseline JPEG
    and a file of another type once, and a WebP or BMP file whole, once."""
    img = _image(200, 300, 5)
    files = {"a.png": None, "a.jpg": "JPEG", "a.webp": "WEBP", "a.bmp": "BMP", "a.gif": "GIF"}
    for name, fmt in files.items():
        b = io.BytesIO()
        Image.fromarray(img).save(b, fmt or "PNG", **({"quality": 100} if fmt == "JPEG" else {}))
        (tmp_path / name).write_bytes(b.getvalue())
    counts = {}
    monkeypatch.setattr(png_module, "open", _counting_open(counts), raising=False)
    paths = [str(tmp_path / n) for n in files]
    assert refused_images(paths) == []
    sizes = {p: (tmp_path / n).stat().st_size for p, n in zip(paths, files)}
    assert all(s > CHECK_HEAD for s in sizes.values())
    heads = {p: CHECK_HEAD for p in paths[:2] + paths[4:]}
    assert counts == {**heads, **{p: sizes[p] for p in paths[2:4]}}


def test_threads_decode_in_parallel():
    """Decodes on 8 threads equal the one-thread ones (ctypes releases the
    interpreter lock during the call)."""
    datas = [(FIXTURES / f"{s}.webp").read_bytes() for s in STEMS]
    one = [decode_webp(d) for d in datas]
    with ThreadPoolExecutor(8) as pool:
        many = list(pool.map(decode_webp, datas * 3))
    for a, b in zip(one * 3, many):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size,flip_p", [(24, 0.5), (None, 0.0)])
def test_lsun_webp_tree_matches_jax(tmp_path, size, flip_p):
    """LSUN as LSUN's export lays it out: ``<key>.webp`` files and a txt
    filelist; ``LSUNBase`` items and batches equal the JAX package's (which
    reads them through PIL)."""
    names = []
    for k, stem in enumerate(["lossy_lsun_256x341", "lossy_q10_37x29", "lossless_photo_q75",
                              "lossy_alpha_pil", "anim_lossy_offset", "vp8x_icc_exif"]):
        name = f"{k:07x}{'0' * 33}.webp"
        shutil.copy(FIXTURES / f"{stem}.webp", tmp_path / name)
        names.append(name)
    (tmp_path / "list.txt").write_text("\n".join(names) + "\n")
    kw = dict(txt_file=str(tmp_path / "list.txt"), data_root=str(tmp_path), size=size,
              interpolation="bicubic", flip_p=flip_p)
    ds, jds = port_ldm.LSUNBase(**kw), jax_ldm.LSUNBase(**kw)
    assert ds.items == jds.items and len(ds) == 6
    random.seed(3)
    got = [ds[i] for i in range(len(ds))]
    random.seed(3)
    want = [jds[i] for i in range(len(jds))]
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        assert gy == wy
