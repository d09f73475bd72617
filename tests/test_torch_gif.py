"""The port's GIF reader (``utils/gif.py`` over ``native/lzw_decoder.cpp``)
against PIL 12's ``GifImagePlugin`` + ``convert("RGB")``, bit for bit: the
committed fixtures (``tests/data/gif/make_fixtures.py``: PIL's own files
and hand-built ones for each quirk of the first frame), random frames, LZW
streams and byte flips, files cut short; the files PIL refuses raise
``ValueError`` naming the file.

Then the four readers of this slice together (GIF, TIFF, PNM, ICO/CUR):
an image folder of such files named ``.jpg`` and ``.png`` and an LSUN
filelist naming ``.gif``, ``.tif``, ``.ppm`` and ``.ico`` files give the JAX
package's items, with PIL importable and with PIL blocked on the port's
side; without PIL, ``refused_images`` names every file that would need it
and ``extract`` stops at its check.
"""
import builtins
import importlib.util
import io
import random
import shutil
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from test_torch_common import REPO, one_thread  # noqa: F401
from test_torch_extract import S, vaes  # noqa: F401
from vavae_tpu.data import ldm_datasets as jax_ldm
from vavae_tpu.data.image_folder import ImageFolderDataset as JaxFolder
from vavae_tpu_torch.data import ldm_datasets as port_ldm
from vavae_tpu_torch.data.image_folder import ImageFolderDataset
from vavae_tpu_torch.pipelines import extract_features as text
from vavae_tpu_torch.utils.gif import decode_gif, gif_head_refusal
from vavae_tpu_torch.utils.png import read_image_rgb, refused_images
from vavae_tpu_torch.utils.tiff import decode_tiff

pytestmark = pytest.mark.usefixtures("one_thread")

DATA = REPO / "tests" / "data"
FIXTURES = DATA / "gif"
GOOD = sorted(p.stem for p in FIXTURES.glob("*.gif") if not p.stem.startswith("refused_"))
REFUSED = sorted(p.stem for p in FIXTURES.glob("refused_*.gif"))


def _make():
    spec = importlib.util.spec_from_file_location("gif_fixtures", FIXTURES / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _make()


@pytest.fixture(scope="module")
def expected():
    return dict(np.load(FIXTURES / "expected.npz"))


def _pil(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(io.BytesIO(data)) as im:
                return np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 - any refusal of PIL's
        return None


def _same_outcome(data: bytes, what) -> None:
    want = _pil(data)
    try:
        got = decode_gif(data)
    except ValueError:
        got = None
    assert (want is None) == (got is None), (what, "PIL refuses" if want is None else "port refuses")
    if want is not None:
        np.testing.assert_array_equal(got, want, err_msg=str(what))


@pytest.mark.parametrize("stem", GOOD)
def test_fixtures_match_pil(stem, expected):
    """Each committed fixture reads bit-equal to PIL's committed and live
    decode through ``read_image_rgb``."""
    path = FIXTURES / f"{stem}.gif"
    np.testing.assert_array_equal(read_image_rgb(str(path)), expected[stem])
    with Image.open(path) as im:
        assert im.format == "GIF"
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), expected[stem])


def test_pinned_quirks(expected):
    """Outside a first frame the canvas holds index 0, or the transparency
    index when one is given (not the background index); an index past the
    palette reads black; a gray-ramp palette is read as gray."""
    pal = np.frombuffer(MAKE._pal(16, 2), np.uint8).reshape(16, 3)
    np.testing.assert_array_equal(expected["frame_offset"][0, 0], pal[0])
    np.testing.assert_array_equal(expected["frame_offset_transparency"][0, 0], pal[9])
    assert (expected["index_past_palette"] == 0).all(axis=2).any()
    assert (expected["gray_ramp_palette"].max() < 16)


@pytest.mark.parametrize("stem", REFUSED)
def test_refused_fixtures_raise_as_pil(stem):
    """Each file PIL refuses (an early EOI, data cut short, a code past the
    table, no frame) raises ``ValueError`` naming the file."""
    path = FIXTURES / f"{stem}.gif"
    assert _pil(path.read_bytes()) is None
    with pytest.raises(ValueError, match=f"^{path}: "):
        read_image_rgb(str(path))


@pytest.mark.parametrize("stem", GOOD)
def test_cut_files_as_pil(stem):
    """Each fixture cut at 10 places: refused or decoded as PIL does."""
    data = (FIXTURES / f"{stem}.gif").read_bytes()
    rs = np.random.default_rng(len(data))
    for cut in sorted(set(rs.integers(6, len(data), 8).tolist() + [13, len(data) - 1])):
        _same_outcome(data[:cut], ("cut", cut))


def test_random_frames_and_flips_as_pil():
    """Random first frames (sizes, palettes, code sizes 2-8, offsets and
    canvases, interlace, extensions, cleared and deferred tables, EOIs
    planted early) and a byte of each flipped: refused or decoded as PIL
    does."""
    rs = np.random.default_rng(1)
    for t in range(250):
        ms = int(rs.integers(2, 9))
        w, h = int(rs.integers(1, 40)), int(rs.integers(1, 30))
        idx = (rs.integers(0, 1 << ms, w * h) if t % 3
               else np.repeat(rs.integers(0, 1 << ms, w * h // 7 + 1), 7)[:w * h]).tolist()
        kw = dict(interlace=bool(t % 4 == 1), bg=int(rs.integers(0, 256)),
                  palette=rs.integers(0, 256, 3 * int(rs.integers(2, (1 << ms) + 1)))
                  .astype(np.uint8).tobytes())
        if t % 5 == 0:
            kw["ext"] = MAKE.gce(int(rs.integers(0, 256)) if t % 2 else None)
        if t % 7 == 0:
            kw["ext"] = kw.get("ext", b"") + b"!\xfe\x03abc\0!\x01\x02xy\0"
        cw, ch = w, h
        if t % 6 == 0:
            kw["box"] = (int(rs.integers(0, 5)), int(rs.integers(0, 5)), w, h)
            cw, ch = max(1, w + int(rs.integers(-3, 6))), max(1, h + int(rs.integers(-3, 6)))
        if t % 11 == 0:
            kw["local"] = rs.integers(0, 256, 3 * int(rs.integers(1, 9))).astype(np.uint8).tobytes()
        codes = MAKE.lzw_codes(idx, ms, deferred=bool(t % 2))
        if t % 13 == 0 and len(codes) > 4:
            k = int(rs.integers(2, len(codes) - 1))
            codes = codes[:k] + [(codes[0][0] + 1, codes[k][1])] + codes[k:]
        data = MAKE.gif(cw, ch, idx, ms, data=MAKE.pack(codes), **kw)
        _same_outcome(data, ("frame", t))
        flipped = bytearray(data)
        pos = int(rs.integers(13, len(data)))
        flipped[pos] = int(rs.integers(0, 256))
        _same_outcome(bytes(flipped), ("flip", t, pos))


@pytest.mark.parametrize("size", [0, 1, 9, 12, 13, 255])
def test_minimum_code_sizes_outside_2_to_8_as_pil(size):
    """Minimum code sizes PIL's decoder takes (0-12; at 1 its width never
    grows) and refuses (13 and more), over random and zero data."""
    for seed in range(3):
        lzw = np.random.default_rng(seed).integers(0, 256, 300).astype(np.uint8).tobytes()
        for data in (lzw, bytes(40)):
            _same_outcome(MAKE.gif(8, 8, [], size, palette=bytes(range(48)), data=data),
                          (size, seed))


def test_whole_canvas_quirk_as_pil():
    """A frame of width 0 at x = 0 decodes the whole canvas (PIL's
    ``setimage`` reads the box (0, y, 0, y1) as the whole image); at x = 1
    it is refused."""
    data = MAKE.pack(MAKE.lzw_codes([1] * 12, 2))
    _same_outcome(MAKE.gif(4, 3, [], 2, palette=bytes(range(12)), box=(0, 0, 0, 2), data=data),
                  "x0")
    _same_outcome(MAKE.gif(4, 3, [], 2, palette=bytes(range(12)), box=(1, 0, 0, 2), data=data),
                  "x1")


def test_decompression_bomb_refused_as_pil(tmp_path):
    """A first frame that grows the canvas past twice PIL's
    ``MAX_IMAGE_PIXELS`` is refused with PIL's message, from the headers."""
    data = MAKE.gif(10, 10, [0], 2, palette=bytes(12), box=(0, 0, 40000, 30000))
    with pytest.raises(Image.DecompressionBombError) as pil:
        Image.open(io.BytesIO(data))
    path = tmp_path / "bomb.gif"
    path.write_bytes(data)
    with pytest.raises(ValueError) as port:
        read_image_rgb(str(path))
    assert str(port.value) == f"{path}: {pil.value}"
    with open(path, "rb") as f:
        assert gif_head_refusal(f.read(6), f) == str(pil.value)


def test_header_refusals():
    """``gif_head_refusal`` names what the headers alone refuse, and passes
    the files whose LZW data PIL refuses."""
    for stem in GOOD + ["refused_early_eoi", "refused_code_past_table"]:
        with open(FIXTURES / f"{stem}.gif", "rb") as f:
            assert gif_head_refusal(f.read(64), f) is None, stem
    with open(FIXTURES / "refused_no_frame.gif", "rb") as f:
        assert gif_head_refusal(f.read(64), f) == "no more images in GIF file"
    assert refused_images([str(FIXTURES / f"{s}.gif") for s in GOOD]) == []


def test_threads_decode_in_parallel():
    """GIF and TIFF LZW decodes on 8 threads equal the one-thread ones
    (ctypes releases the interpreter lock during each call)."""
    gifs = [(FIXTURES / f"{s}.gif").read_bytes() for s in GOOD]
    tiffs = [p.read_bytes() for p in sorted((DATA / "tiff").glob("*lzw*.tif"))
             if not p.stem.startswith(("refused_", "pil_only_"))]
    jobs = [(decode_gif, d) for d in gifs] + [(decode_tiff, d) for d in tiffs]
    one = [fn(d) for fn, d in jobs]
    with ThreadPoolExecutor(8) as pool:
        many = list(pool.map(lambda j: j[0](j[1]), jobs * 3))
    for a, b in zip(one * 3, many):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------- the four readers together ---

# one file of each reader, and the name each is given
MISNAMED = {"gif/pil_adaptive_64x48.gif": "a.jpg", "gif/interlaced_odd_height.gif": "b.png",
            "tiff/pil_rgb_lzw.tif": "c.jpg", "tiff/planar_rgb_lzw_predictor.tif": "d.png",
            "tiff/orientation_6_lzw.tif": "e.jpeg", "pnm/pil_p6.ppm": "f.jpg",
            "pnm/p2_plain_maxval_300.pgm": "g.png", "ico/pil_png_sizes.ico": "h.jpg",
            "ico/dib_4bit.ico": "i.png", "ico/cursor_one.cur": "j.bmp"}


def _no_pil(monkeypatch):
    """PIL made unimportable for the code that imports it from now on."""
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)


@pytest.fixture(scope="module")
def misnamed_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("misnamed")
    for k, (src, name) in enumerate(MISNAMED.items()):
        cls = root / f"class_{k % 2}"
        cls.mkdir(exist_ok=True)
        shutil.copy(DATA / src, cls / name)
    return root


@pytest.mark.parametrize("pil", [True, False], ids=["with_pil", "pil_blocked"])
def test_misnamed_image_folder_matches_jax(misnamed_folder, pil, monkeypatch):
    """GIF, TIFF, PNM, ICO and CUR files named ``.jpg``, ``.png`` and
    ``.bmp``: ``ImageFolderDataset`` items equal the JAX package's
    (``_load_image`` through PIL, which opens by content)."""
    jds = JaxFolder(str(misnamed_folder), image_size=24)
    want = [jds[i] for i in range(len(jds))]
    if not pil:
        _no_pil(monkeypatch)
    ds = ImageFolderDataset(str(misnamed_folder), image_size=24)
    assert ds.items == jds.items and len(ds) == len(MISNAMED)
    for i, (wx, wy) in enumerate(want):
        gx, gy = ds[i]
        np.testing.assert_array_equal(gx, wx)
        assert gy == wy


@pytest.mark.parametrize("pil", [True, False], ids=["with_pil", "pil_blocked"])
def test_lsun_filelist_of_other_types_matches_jax(tmp_path, pil, monkeypatch):
    """An LSUN txt filelist naming ``.gif``, ``.tif``, ``.ppm``, ``.pgm``,
    ``.ico`` and ``.cur`` files: ``LSUNBase`` items equal the JAX
    package's."""
    names = []
    for k, src in enumerate(MISNAMED):
        name = f"{k:07x}{'0' * 33}{src[src.rindex('.'):]}"
        shutil.copy(DATA / src, tmp_path / name)
        names.append(name)
    (tmp_path / "list.txt").write_text("\n".join(names) + "\n")
    kw = dict(txt_file=str(tmp_path / "list.txt"), data_root=str(tmp_path), size=24,
              interpolation="bicubic", flip_p=0.5)
    jds = jax_ldm.LSUNBase(**kw)
    random.seed(3)
    want = [jds[i] for i in range(len(jds))]
    if not pil:
        _no_pil(monkeypatch)
    ds = port_ldm.LSUNBase(**kw)
    assert ds.items == jds.items and len(ds) == len(MISNAMED)
    random.seed(3)
    for i, (wx, wy) in enumerate(want):
        gx, gy = ds[i]
        np.testing.assert_array_equal(gx, wx)
        assert gy == wy


def _tga(path) -> None:
    """A TGA file (a type only PIL reads) of 8 × 6 pixels."""
    Image.fromarray(np.full((6, 8, 3), 90, np.uint8)).save(path, "TGA")


def test_without_pil_refused_images_names_what_needs_it(misnamed_folder, tmp_path, monkeypatch):
    """With PIL blocked, ``refused_images`` names the TGA file and the
    JPEG-compressed TIFF (a compression the port leaves to PIL) as needing
    it, and nothing the port reads; with PIL, neither."""
    root = tmp_path / "tree"
    shutil.copytree(misnamed_folder, root)
    _tga(root / "class_0" / "x.jpg")
    shutil.copy(DATA / "tiff" / "pil_only_jpeg.tif", root / "class_1" / "y.png")
    paths = sorted(str(p) for p in root.rglob("*.*"))
    assert refused_images(paths) == []
    _no_pil(monkeypatch)
    refused = dict(refused_images(paths))
    assert sorted(refused) == [str(root / "class_0" / "x.jpg"), str(root / "class_1" / "y.png")]
    assert "needs PIL (Pillow), which is not installed" in refused[str(root / "class_0" / "x.jpg")]
    assert "TIFF compression 7" in refused[str(root / "class_1" / "y.png")]
    with pytest.raises(ImportError, match=f"{root / 'class_1' / 'y.png'}: reading TIFF "
                                          "compression 7 needs PIL"):
        read_image_rgb(str(root / "class_1" / "y.png"))


def test_extract_without_pil_stops_at_its_check(vaes, misnamed_folder, tmp_path, monkeypatch):  # noqa: F811
    """``extract`` over a tree whose TGA file would need the blocked PIL
    stops at its check, naming the file, before any batch is encoded."""
    _, tv, _ = vaes
    root = tmp_path / "images"
    shutil.copytree(misnamed_folder, root)
    _tga(root / "class_1" / "z.png")
    _no_pil(monkeypatch)
    encoded = []
    monkeypatch.setattr(tv, "encode_images", lambda *a, **k: encoded.append(1))
    with pytest.raises(ValueError, match="1 of 11 images are JPEGs, WebP or BMP files") as e:
        text.extract(str(root), str(tmp_path / "out"), tv, batch_size=2, image_size=S)
    assert f"{root / 'class_1' / 'z.png'}: reading " in str(e.value)
    assert "needs PIL (Pillow), which is not installed" in str(e.value)
    assert not encoded and not list((tmp_path / "out").glob("*.safetensors"))


def test_bytes_past_the_trailer_as_pil():
    """Bytes after a GIF's ``;`` trailer are not read."""
    data = (FIXTURES / "gif87a.gif").read_bytes() + b"bytes after the trailer"
    np.testing.assert_array_equal(decode_gif(data), _pil(data))
