"""Export to the reference's torch formats (``utils/torch_export.py``,
``apps/export_torch.py``) against the JAX package's exporters: the same
keys and bit-equal arrays for the same weights, and ``.pt``/``.ckpt`` round
trips through the port's loaders that give back the weights bit for bit."""
import numpy as np
import pytest
import torch

from test_torch_common import one_thread, tiny_dit_pair, tiny_vae_pair  # noqa: F401
from vavae_tpu.utils.torch_export import dit_params_to_torch, vae_params_to_torch
from vavae_tpu_torch.utils.torch_export import dit_state_to_reference, vae_state_to_reference
from vavae_tpu_torch.utils.weights import dit_state_from_reference

pytestmark = pytest.mark.usefixtures("one_thread")

DIT_VARIANTS = {
    "rope": {},
    "qknorm_rms_rope": {"use_qknorm": True},
    "qknorm_ln_no_rope_p2": {"use_qknorm": True, "use_rmsnorm": False, "use_rope": False,
                             "use_swiglu": False, "patch_size": 2},
}


def _assert_bit_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.shape == v.shape and g.dtype == np.float32, k
        np.testing.assert_array_equal(g, v, err_msg=k)


@pytest.mark.parametrize("variant", sorted(DIT_VARIANTS))
def test_dit_export_matches_jax(variant):
    """The port's DiT export of the same weights equals JAX's
    ``dit_params_to_torch`` key for key and bit for bit (the frozen
    ``pos_embed`` included), and ``dit_state_from_reference`` inverts it."""
    jm, params, tm = tiny_dit_pair(0, **DIT_VARIANTS[variant])
    rope = tm.num_heads if tm.use_rope else 0
    want = dit_params_to_torch(params, tm.patch_size, rope_heads=rope, input_size=tm.input_size)
    got = dit_state_to_reference(tm.state_dict(), tm.patch_size, tm.num_heads, tm.use_rope,
                                 tm.input_size)
    _assert_bit_equal(got, want)
    back = dit_state_from_reference(got, tm.num_heads, tm.use_rope)
    own = tm.state_dict()
    assert set(back) == set(own)
    for k, v in own.items():
        assert torch.equal(back[k], v), k


def test_vae_export_matches_jax(tmp_path):
    jv, tv = tiny_vae_pair(tmp_path)
    _assert_bit_equal(vae_state_to_reference(tv.model.state_dict()), vae_params_to_torch(jv.params))


def test_export_cli_round_trips(tmp_path, monkeypatch):
    """``export_torch`` on port train states: the DiT ``.pt`` loaded by
    ``load_dit_params`` (EMA and model) and the VAE ``.ckpt`` loaded by
    ``VA_VAE`` give back every weight bit for bit, and equal the JAX CLI's
    export of the same files."""
    import json

    import vavae_tpu_torch.models.dit as dit
    from vavae_tpu.apps import export_torch as jax_export
    from vavae_tpu.models import dit as jax_dit
    from vavae_tpu_torch.apps import export_torch
    from vavae_tpu_torch.models.dit import create_dit
    from vavae_tpu_torch.pipelines.sample import load_dit_params
    from vavae_tpu_torch.tokenizer import VA_VAE
    from vavae_tpu_torch.train import checkpoint as ckpt_lib
    from vavae_tpu_torch.train.dit_trainer import DiTTrainer
    from vavae_tpu_torch.transport import create_transport
    from vavae_tpu_torch.utils.config import Config

    for mod in (dit, jax_dit):
        monkeypatch.setitem(mod._VARIANTS, "S", dict(depth=2, hidden_size=144, num_heads=2))
    cfg = {"data": {"image_size": 16, "num_classes": 10}, "vae": {"downsample_ratio": 2},
           "model": {"model_type": "LightningDiT-S/1", "use_swiglu": True, "use_rope": True,
                     "use_rmsnorm": True, "in_chans": 4}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    _, _, tm = tiny_dit_pair(0)
    model = create_dit(Config(cfg["model"]), 8, 10)
    model.load_state_dict(tm.state_dict())
    state = DiTTrainer(model, create_transport("Linear", "velocity")).init_state()
    with torch.no_grad():
        for e in state.ema_params:
            e.mul_(0.5)
    state.step = 7
    ckpt = ckpt_lib.save_checkpoint(str(tmp_path / "ck"), 7, state)
    out = str(tmp_path / "dit.pt")
    export_torch.main(["--kind", "dit", "--config", str(tmp_path / "cfg.json"), "--ckpt", ckpt,
                       "--out", out])
    jax_export.export_dit(str(tmp_path / "cfg.json"), ckpt, str(tmp_path / "jax_dit.pt"))
    payload = torch.load(out, weights_only=False)
    want = torch.load(str(tmp_path / "jax_dit.pt"), weights_only=False)
    assert payload["steps"] == want["steps"] == 7
    for key in ("model", "ema"):
        _assert_bit_equal(payload[key], {k: v.numpy() for k, v in want[key].items()})
    for prefer_ema, source in ((True, state.ema_params), (False, state.params)):
        fresh = LightningDiTLike(tm)
        load_dit_params(fresh, out, prefer_ema=prefer_ema)
        for p, s in zip(fresh.parameters(), source):
            assert torch.equal(p.detach(), s.detach())

    from vavae_tpu_torch.train.vae_trainer import VAETrainer

    jv, tv = tiny_vae_pair(tmp_path)
    trainer = VAETrainer(tv.model, use_vf=False)
    vstate = trainer.init_state(0)
    vckpt = ckpt_lib.save_checkpoint(str(tmp_path / "vae"), 3, vstate)
    vout = str(tmp_path / "vae.ckpt")
    export_torch.main(["--kind", "vae", "--ckpt", vckpt, "--out", vout])
    jax_export.export_vae(vckpt, str(tmp_path / "jax_vae.ckpt"))
    sd = torch.load(vout, weights_only=False)["state_dict"]
    jsd = torch.load(str(tmp_path / "jax_vae.ckpt"), weights_only=False)["state_dict"]
    _assert_bit_equal(sd, {k: v.numpy() for k, v in jsd.items()})
    from test_torch_common import tiny_vae_config

    back = VA_VAE(tiny_vae_config(tmp_path), ckpt_path=vout, img_size=16, device="cpu")
    for (k, a), b in zip(back.model.state_dict().items(), vstate.gen_params):
        assert torch.equal(a, b.detach()), k
    with pytest.raises(SystemExit, match="gen_params"):
        export_torch.main(["--kind", "vae", "--ckpt", ckpt, "--out", str(tmp_path / "x.ckpt")])


def LightningDiTLike(tm):
    """A fresh port DiT of ``tm``'s architecture, its weights zeroed."""
    from vavae_tpu_torch.models.dit import LightningDiT

    fresh = LightningDiT(input_size=tm.input_size, patch_size=tm.patch_size,
                         in_channels=tm.in_channels, hidden_size=144, depth=2, num_heads=2,
                         num_classes=10, use_swiglu=True, use_rmsnorm=True, use_rope=True)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    return fresh
