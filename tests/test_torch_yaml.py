"""The port's YAML reader and writer (``vavae_tpu_torch/utils/yaml_io.py``)
and its shipped configs (``vavae_tpu_torch/configs``), held against PyYAML
and the JAX package's ``utils/config.py``. The port's side runs with
PyYAML made unimportable, as on the card's machine."""
import datetime
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from test_torch_common import REPO, one_thread  # noqa: F401
from vavae_tpu.utils.config import load_config as jax_load_config
from vavae_tpu.utils.config import save_config as jax_save_config
from vavae_tpu_torch.utils import yaml_io
from vavae_tpu_torch.utils.config import Config, load_config, save_config

pytestmark = pytest.mark.usefixtures("one_thread")

JAX_CONFIGS = REPO / "vavae_tpu" / "configs"
PORT_CONFIGS = REPO / "vavae_tpu_torch" / "configs"
NAMES = sorted(str(p.relative_to(JAX_CONFIGS)) for p in JAX_CONFIGS.rglob("*.yaml"))
# the override lists of tests/test_config.py and tests/test_torch_common.py
OVERRIDES = [
    ["model.use_rope=false", "train.lr=0.0002"],
    ["data.num_classes=32"],
    ["sample.num_sampling_steps=10", "data.extra.k=[1,2]"],
    ["model.base_learning_rate=1e-4", "train.flag=yes", "data.extra.k=[1,2]"],
]
FUZZ = settings(max_examples=500, deadline=None, database=None, derandomize=True,
                suppress_health_check=list(HealthCheck))


@pytest.fixture
def no_pyyaml(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)


def same(a, b) -> bool:
    """Equal values of equal types, all the way down (1, 1.0 and True
    differ; NaN equals NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict):
        return len(a) == len(b) and all(
            same(ka, kb) and same(a[ka], b[kb]) for ka, kb in zip(a, b))
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def pyyaml_or_refusal(text: str) -> None:
    """The port gives PyYAML's value, or ValueError; never another value,
    and never a value where PyYAML raises."""
    try:
        want, pyyaml_error = yaml.safe_load(text), None
    except Exception as e:  # noqa: BLE001 — any PyYAML failure
        want, pyyaml_error = None, e
    try:
        got = yaml_io.safe_load(text)
    except ValueError:
        return
    assert pyyaml_error is None, f"PyYAML raised {pyyaml_error!r}, the port gave {got!r}"
    assert same(got, want), f"{text!r}: the port gave {got!r}, PyYAML {want!r}"


def test_port_ships_every_config():
    assert NAMES == sorted(str(p.relative_to(PORT_CONFIGS))
                           for p in PORT_CONFIGS.rglob("*.yaml"))
    assert len(NAMES) == 10


@pytest.mark.parametrize("name", NAMES)
def test_port_config_loads_to_the_jax_tree(name, no_pyyaml):
    want = yaml.safe_load((JAX_CONFIGS / name).read_text())
    with open(PORT_CONFIGS / name) as f:
        got = yaml_io.safe_load(f)
    assert same(got, want)


@pytest.mark.parametrize("overrides", OVERRIDES, ids=range(len(OVERRIDES)))
@pytest.mark.parametrize("name", NAMES)
def test_load_config_matches_jax(name, overrides, monkeypatch):
    want = jax_load_config(str(JAX_CONFIGS / name), overrides=overrides)
    monkeypatch.setitem(sys.modules, "yaml", None)
    got = load_config(str(PORT_CONFIGS / name), overrides=overrides)
    assert same(got.to_dict(), want.to_dict())


@pytest.mark.parametrize("pair", [
    ("lightningdit_xl_vavae_f16d32.yaml",
     "reproductions/lightningdit_xl_vavae_f16d32_800ep_cfg.yaml"),
    ("config_details.yaml", "dit_s_microdoppler.yaml"),
    ("vavae_f16d32.yaml", "vavae_microdoppler_finetune.yaml"),
])
def test_load_config_merges_like_jax(pair, monkeypatch):
    want = jax_load_config(*(str(JAX_CONFIGS / n) for n in pair), overrides=OVERRIDES[3])
    monkeypatch.setitem(sys.modules, "yaml", None)
    got = load_config(*(str(PORT_CONFIGS / n) for n in pair), overrides=OVERRIDES[3])
    assert same(got.to_dict(), want.to_dict())


@pytest.mark.parametrize("name", NAMES)
def test_safe_dump_and_save_config_match_pyyaml(name, tmp_path, monkeypatch):
    tree = yaml.safe_load((JAX_CONFIGS / name).read_text())
    jax_path, port_path = tmp_path / "jax.yaml", tmp_path / "port.yaml"
    jax_save_config(jax_load_config(str(JAX_CONFIGS / name)), str(jax_path))
    want = {keys: yaml.safe_dump(tree, sort_keys=keys) for keys in (False, True)}
    monkeypatch.setitem(sys.modules, "yaml", None)
    for keys in (False, True):
        assert yaml_io.safe_dump(tree, sort_keys=keys) == want[keys]
    assert same(yaml_io.safe_load(yaml_io.safe_dump(tree)), tree)
    cfg = load_config(str(PORT_CONFIGS / name))
    save_config(cfg, str(port_path))
    assert port_path.read_text() == jax_path.read_text() == want[False]
    assert same(load_config(str(port_path)).to_dict(), cfg.to_dict())


# PyYAML 6.0's YAML 1.1 quirks, each as the text alone and as a mapping value
QUIRKS = [("1e-4", "1e-4"), ("1.e4", "1.e4"), ("09", "09"), ("0o10", "0o10"),
          ("1.0e-04", 1e-4), ("1.0E+3", 1000.0), (".5", 0.5), ("+.inf", math.inf),
          (".NaN", math.nan), ("010", 8), ("0x1F", 31), ("0b101", 5), ("1_000", 1000),
          ("1:30", 90), ("-1:30.5", -90.5), ("yes", True), ("On", True), ("off", False),
          ("~", None), ("", None), ("null", None), ("2001-12-14", datetime.date(2001, 12, 14)),
          ("'yes'", "yes"), ('"a\\tb\\u00e9"', "a\tb\u00e9"), ("'it''s'", "it's"),
          ("http://x/y", "http://x/y"), ("a b # c", "a b"), ("a#b", "a#b")]


@pytest.mark.parametrize("text,value", QUIRKS, ids=[q[0] or "empty" for q in QUIRKS])
def test_scalar_resolution_matches_pyyaml(text, value, no_pyyaml):
    assert same(yaml_io.safe_load(text), value)
    assert same(yaml_io.safe_load(f"k: {text}"), {"k": value})


def test_scalar_table_is_pyyaml():
    """The table above is PyYAML's own reading."""
    for text, value in QUIRKS:
        assert same(yaml.safe_load(text), value), text


def test_structures_match_pyyaml(no_pyyaml):
    docs = [
        "a: 1\nb:\n  c: [1, 2.5, x]\n  d: {e: f, 'g h': null}\n",
        "- a: 1\n  b: 2\n- - x\n  - y\n-\n- {}\n",
        "stages:\n- {epochs: 100, vf_weight: 0.5}\n  # a comment\n- {epochs: 15}\nx: 1\n",
        "a:\n  - 1\n  -   k: v\n      l: w\n",
        "1: n01440764\n2: n01443537\n",
        "# only a comment\n\n",
        "[a, 'b', \"c\", [], {}, -1, -a, 1:2]",
        "k: [a b, c,]\n",
        "'q': \"d\"\n\"r s\": 't u'   # trailing\n",
    ]
    for text in docs:
        pyyaml_or_refusal(text)
        yaml_io.safe_load(text)  # none of these is refused


def test_index_synset_reads_as_pyyaml(no_pyyaml):
    """ImageNet's ``index_synset.yaml``: integer keys, one synset each."""
    synsets = {i: f"n{10_000_000 + 7919 * i:08d}" for i in range(1000)}
    text = "".join(f"{i}: {s}\n" for i, s in synsets.items())
    assert same(yaml_io.safe_load(text), synsets)
    assert yaml_io.safe_dump(synsets) == text


REFUSED = [
    ("a: &x 1", "anchor"), ("a: *x", "alias"), ("a: !!str 1", "tag"),
    ("a: |\n  x\n", "block scalar"), ("a: >\n  x\n", "block scalar"),
    ("a: 1\n---\nb: 2\n", "document marker"), ("---\na: 1\n", "document marker"),
    ("a: 1\n...\n", "document marker"), ("<<: {a: 1}\n", "merge"), ("a: <<", "merge"),
    ("a: =", "value key"), ("? a\n: b\n", "complex key"), ("{? a: b}", "not a scalar"),
    ("a: b\n  c\n", "indented deeper"), ("a: [1,\n  2]\n", "spans lines"),
    ("a: 'b\n  c'\n", "spans lines"), ('a: "b\\\n  c"\n', "continued"),
    ("t: 2001-12-14 21:59:43.10 -5", "timestamp with a time"), ("a:\t1", "tab"),
    ("a: 1\r\n", "carriage return"), ("a: \x07", "non-printable"), ("a: 0x_", "int"),
    ("d: 2001-13-14", "timestamp"), ('a: "\\q"', "unknown escape"), ("[a: b]", "pair inside"),
    ("a: b: c", "mapping value"), ("a: 'x' y", "text after"), ("- a\nb: 1\n", "after the doc"),
    ("@a", "reserved"), ("%YAML 1.1", "directive"),
]


@pytest.mark.parametrize("text,construct", REFUSED, ids=[r[1] for r in REFUSED])
def test_refusals_name_the_line_and_construct(text, construct, no_pyyaml):
    with pytest.raises(ValueError, match=f"YAML line [0-9]+: .*{construct}"):
        yaml_io.safe_load(text)


def test_dump_refusals(no_pyyaml):
    shared = [1]
    for obj, what in [({"a": Config({"b": 1})}, "not Config"), ({"a": (1, 2)}, "not tuple"),
                      ({"a": shared, "b": shared}, "reached twice"), (1, "at the top"),
                      ({"k" * 128: 1}, "simple key"), ({"a": "x\ny"}, "multi-line"),
                      ({"a": " ".join(["word"] * 30)}, "fold"), ({("a",): 1}, "not tuple"),
                      ({"a": np.float32(1)}, "not float32")]:
        with pytest.raises(ValueError, match=what):
            yaml_io.safe_dump(obj)


_CHARS = list("0123456789.-+_:eExbo aAyYnNtTfFlu#'\"\\[]{},?!&*|>%@`<=~\t\nZ/") + \
    ["\u00e9", "\x07", "\u2028", "\r"]
_TOKENS = ["1e-4", "1.e4", "09", "0o10", "1.0e-04", "1.0E+3", ".5", "+.inf", ".NaN", "010",
           "0x1F", "0b101", "1_000", "1:30", "yes", "On", "~", "null", "2001-12-14",
           "2001-12-14 21:59:43.10 -5", "<<", "=", "-", ":", "?", "a b", "http://x", "# c",
           " #c", "'q'", '"d\\n"', '"\\x41"', "'it''s'", "0b_", "0x_", "-0", "+12_3", "1:60",
           "190:20:30", "True", "FALSE", "Off", "---", "...", "!tag", "&a", "*a", "|", ">"]
_SCALARS = st.one_of(st.text(alphabet=st.sampled_from(_CHARS), max_size=8),
                     st.lists(st.sampled_from(_TOKENS + _CHARS), max_size=4).map("".join))


@FUZZ
@given(_SCALARS)
def test_drawn_scalars_give_pyyaml_or_refusal(text):
    for doc in (text, f"k: {text}", f"- {text}", f"[{text}]", f"{{a: {text}}}", f"{text}: v"):
        pyyaml_or_refusal(doc)


_LINES = st.lists(st.tuples(
    st.integers(0, 4),
    st.sampled_from(["", "- ", "k: ", "a b: ", "'q': ", '"d": ', "- k: ", "1: ", "- - ", "k:",
                     "-", "? "]),
    _SCALARS), min_size=1, max_size=6)


@FUZZ
@given(_LINES)
def test_drawn_documents_give_pyyaml_or_refusal(lines):
    pyyaml_or_refusal("\n".join(" " * i + prefix + s for i, prefix, s in lines))


_KEYS = st.one_of(st.text(min_size=1, max_size=6), st.integers(-5, 300), st.booleans(),
                  st.none(), st.sampled_from(["yes", "1.0", "null", "a b", "-x", "#", "a: b"]))
_LEAVES = st.one_of(st.none(), st.booleans(), st.integers(), st.floats(), st.text(max_size=40),
                    st.text(alphabet=st.sampled_from(list("ab '\"#:-\\\u00e9\x07")), max_size=90),
                    st.sampled_from(_TOKENS))
_TREES = st.recursive(_LEAVES, lambda c: st.one_of(st.lists(c, max_size=4),
                                                   st.dictionaries(_KEYS, c, max_size=4)),
                      max_leaves=12)


@FUZZ
@given(st.one_of(st.dictionaries(_KEYS, _TREES, max_size=5), st.lists(_TREES, max_size=4)))
def test_drawn_trees_dump_as_pyyaml(obj):
    """``safe_dump`` writes PyYAML's text or refuses; what it writes reads
    back equal; and the reader takes PyYAML's own dump or refuses it."""
    want = yaml.safe_dump(obj, sort_keys=False)
    pyyaml_or_refusal(want)
    try:
        got = yaml_io.safe_dump(obj)
    except ValueError:
        return
    assert got == want
    assert same(yaml_io.safe_load(got), yaml.safe_load(want))


def test_vae_config_builds_the_default_f16d32(no_pyyaml):
    """``VA_VAE(config=...)`` reads the tokenizer config without PyYAML, and
    the f16d32 config builds the default f16d32 architecture, parameter for
    parameter (so seeded random weights agree: ``chip_smoke.py`` phase 35
    holds its ``extract_features --config`` shards to phase 21's)."""
    from vavae_tpu_torch.models.vae import AutoencoderKL, vae_from_ddconfig

    cfg = yaml_io.safe_load((PORT_CONFIGS / "vavae_f16d32.yaml").read_text())
    p = cfg["model"]["params"]
    a = vae_from_ddconfig(p["embed_dim"], {**p["ddconfig"], "resolution": 256},
                          model_type="vavae")
    b = AutoencoderKL(embed_dim=32, ch_mult=(1, 1, 2, 2, 4), resolution=256, model_type="vavae")
    assert [(k, v.shape) for k, v in a.state_dict().items()] == \
        [(k, v.shape) for k, v in b.state_dict().items()]


def test_tokenizer_reads_its_config_without_pyyaml(no_pyyaml, tmp_path):
    from vavae_tpu_torch.tokenizer import VA_VAE

    path = tmp_path / "tiny_vae.yaml"
    path.write_text(yaml_io.safe_dump({"ckpt_path": None, "model": {"params": {
        "embed_dim": 4, "ddconfig": {"double_z": True, "z_channels": 4, "resolution": 16,
                                     "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 2],
                                     "num_res_blocks": 1, "attn_resolutions": []}}}}))
    vae = VA_VAE(str(path), img_size=16, device="cpu")
    assert (vae.embed_dim, vae.downsample) == (4, 2)
    z = vae.encode_images(np.zeros((1, 16, 16, 3), np.float32))
    assert tuple(z.shape) == (1, 8, 8, 4)


def test_train_dit_command_from_the_shipped_config(tmp_path):
    """``python -m vavae_tpu_torch train_dit`` from the port's micro-Doppler
    config (DiT-S/2) for 2 steps at batch 2 on the CPU, PyYAML blocked."""
    from vavae_tpu_torch.utils.safetensors_io import write_safetensors

    rs = np.random.default_rng(0)
    lat = rs.standard_normal((8, 32, 16, 16)).astype(np.float32)
    write_safetensors(str(tmp_path / "latents" / "latents_rank00_shard000.safetensors"), {
        "latents": lat, "latents_flip": np.ascontiguousarray(lat[..., ::-1]),
        "labels": rs.integers(0, 31, 8).astype(np.int32)})
    argv = ["python -m vavae_tpu_torch", "train_dit", "--device", "cpu", "--config",
            str(PORT_CONFIGS / "dit_s_microdoppler.yaml"), f"data.data_path={tmp_path / 'latents'}",
            "train.max_steps=2", "train.global_batch_size=2", "train.ckpt_every=2",
            "train.log_every=1", f"train.output_dir={tmp_path / 'out'}"]
    code = ("import runpy, sys\nsys.modules['yaml'] = None\nsys.argv = " + repr(argv) +
            "\nrunpy.run_module('vavae_tpu_torch', run_name='__main__')\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    ckpts = sorted(os.listdir(tmp_path / "out" / "dit_s_microdoppler" / "checkpoints"))
    assert ckpts == ["0000002.safetensors", "config.json"]
    assert "(step=0000002) Train Loss" in res.stdout
