"""The big-variant command (``vavae_tpu_torch/apps/big_variant.py``, the
port of ``scripts/dryrun_big_variant.py``) on the CPU: its two train steps
against the JAX ``DiTTrainer`` set up as the JAX script sets it up, the
command's record, its refusal without a card, its FSDP world of two over
gloo against one process, and its imports.
"""
import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from test_torch_common import REPO, max_rel, one_thread  # noqa: F401
from vavae_tpu_torch.apps import big_variant

pytestmark = pytest.mark.usefixtures("one_thread")

# the JAX script's model (scripts/dryrun_big_variant.py:54-58), narrowed to
# depth 2 and two heads of 64 (N = 256 tokens, as the big variants')
NARROW = dict(input_size=16, patch_size=1, in_channels=32, hidden_size=128, depth=2,
              num_heads=2, num_classes=1000, use_swiglu=True, use_rope=True, use_rmsnorm=True,
              use_checkpoint=True, checkpoint_policy="dots")
BATCH = 8


def _jax_fields() -> list[str]:
    """The keys of the JSON line the JAX script prints."""
    tree = ast.parse((REPO / "scripts" / "dryrun_big_variant.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps of a dict in the JAX script")


def _jax_draws(jm, params, jtr, step_rng, x, y):
    """t, x0 and the label-drop mask that the JAX trainer's step draws from
    ``step_rng`` (dit_trainer.py:199, transport.py:158-160). The mask is the
    rows of the y embedding that the model's own draw set to the null
    class, read from the forward's intermediates."""
    drop_rng, t_rng = jax.random.split(step_rng)
    t_rng, x0_rng = jax.random.split(t_rng)
    t = jtr.sample_t(t_rng, x.shape[0])
    x0 = jax.random.normal(x0_rng, x.shape, jnp.float32)
    _, inter = jm.apply({"params": params}, jnp.asarray(x), t, jnp.asarray(y), train=True,
                        rngs={"label_dropout": drop_rng}, capture_intermediates=True,
                        mutable=["intermediates"])
    emb = np.asarray(inter["intermediates"]["y_embedder"]["__call__"][0].astype(jnp.float32))
    null = np.asarray(params["y_embedder"]["table"]["embedding"][NARROW["num_classes"]]
                      .astype(jnp.bfloat16).astype(jnp.float32))
    drop = (emb == null).all(-1).astype(np.int32)
    return np.asarray(t), np.asarray(x0), drop


def test_two_steps_match_jax_trainer():
    """The stepping function (``train_steps``) on the narrowed model, from
    the JAX init carried across by ``dit_state_from_jax``, against two steps
    of the JAX ``DiTTrainer`` as the JAX script builds it (bf16 compute over
    fp32 weights, bf16 Adam μ, remat "dots", Linear/velocity, lr 2e-4, no
    clipping, EMA 0.9999), the port fed JAX's draws: t, x0 and the
    label-dropout mask. Each step's loss within 1e-5 relative (measured
    4.8e-7); the parameters and the EMA after two steps within 1e-4
    relative, Frobenius over all tensors (measured 1.0e-5 and 6.9e-8), and
    each element within 2·lr a step (measured 2.5e-4 of 8e-4), since
    Adam's normalised update can flip sign on a gradient within bf16
    rounding of 0. The mask replays JAX's draw: its forward with
    train=True equals its forward with that mask forced."""
    from vavae_tpu.models.dit import LightningDiT as JaxDiT
    from vavae_tpu.parallel.mesh import make_mesh
    from vavae_tpu.train.dit_trainer import DiTTrainer as JaxTrainer
    from vavae_tpu.transport import create_transport as create_jax_transport
    from vavae_tpu_torch.models.dit import LightningDiT
    from vavae_tpu_torch.utils.weights import dit_state_from_jax

    jm = JaxDiT(**NARROW, dtype=jnp.bfloat16)
    jtr = create_jax_transport("Linear", "velocity")
    jt = JaxTrainer(jm, jtr, make_mesh(devices=jax.devices("cpu")[:1]), adam_mu_dtype="bfloat16")
    rng = jax.random.PRNGKey(0)
    jstate = jt.replicate(jt.init_state(rng, (BATCH, 16, 16, 32)))
    params0 = jax.device_get(jstate.params)

    tm = LightningDiT(**NARROW, dtype=torch.bfloat16)
    tm.load_state_dict(dit_state_from_jax(params0), strict=True)
    trainer = big_variant.build_trainer(tm)
    state = trainer.init_state()

    x, y = (a.numpy() for a in big_variant.draw_batch(BATCH, 0))
    draws, want = [], []
    for step in range(2):
        params = jax.device_get(jstate.params)
        t, x0, drop = _jax_draws(jm, params, jtr, jax.random.fold_in(rng, step), x, y)
        forced = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
                          force_drop_ids=jnp.asarray(drop))
        dropped = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
                           train=True, rngs={"label_dropout": jax.random.split(
                               jax.random.fold_in(rng, step))[0]})
        np.testing.assert_array_equal(np.asarray(forced), np.asarray(dropped))
        draws.append((t, x0, drop))
        jstate, m = jt.train_step(jstate, rng, jt.shard_batch((x, y)))
        want.append(float(m["loss"]))
    assert sum(d[2].sum() for d in draws) > 0  # the draws dropped some labels

    out = big_variant.train_steps(trainer, state, (torch.from_numpy(x), torch.from_numpy(y)), 2,
                                  draws=draws)
    for got, w in zip(out["losses"], want):
        assert max_rel(got, w) < 1e-5, (out["losses"], want)
    assert state.step == int(jstate.step) == 2
    lr = trainer.lr
    for got, ref in ((state.params, jstate.params), (state.ema_params, jstate.ema_params)):
        ref = dit_state_from_jax(jax.device_get(ref))
        g = [p.detach().double().numpy() for p in got]
        r = [ref[n].double().numpy() for n in state.names]
        flat_g, flat_r = np.concatenate([a.ravel() for a in g]), np.concatenate([a.ravel() for a in r])
        assert np.linalg.norm(flat_g - flat_r) / np.linalg.norm(flat_r) < 1e-4
        assert np.abs(flat_g - flat_r).max() <= 2 * 2 * lr


def _cpu_record(*args: str) -> dict:
    out = subprocess.run([sys.executable, "-m", "vavae_tpu_torch", "big_variant", *args],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_command_prints_the_jax_fields_on_cpu():
    """``python -m vavae_tpu_torch big_variant LightningDiT-S/2 2 --device
    cpu``: every field of the JAX script's line, S/2's 32,960,768
    parameters, its largest tensor adaLN's (2304, 384) unsharded, finite
    losses, each part of the state at its arithmetic (14 bytes an element of
    state, 4 of gradients), and no kernel launched: on the CPU the
    attention wrappers take their plain versions."""
    rec = _cpu_record("LightningDiT-S/2", "2", "--device", "cpu")
    fields = _jax_fields()
    assert len(fields) == 13 and set(fields) <= set(rec)
    n = 32960768
    assert (rec["model"], rec["batch"], rec["platform"], rec["n_devices"], rec["mesh"]) == (
        "LightningDiT-S/2", 2, "cpu", 1, "fsdp=1")
    assert rec["params"] == n and rec["params_b"] == 0.033
    assert rec["largest_param_shape"] == rec["largest_param_shard_shape"] == [2304, 384]
    assert all(np.isfinite([rec["loss_step1"], rec["loss_step2"]]))
    assert rec["launches_per_step"] == rec["launches_expected"] == [0, 0]
    want = {"params": 4 * n, "ema": 4 * n, "mu": 2 * n, "nu": 4 * n, "grads": 4 * n}
    assert rec["state_bytes"] == {k: {"measured": v, "arithmetic": v} for k, v in want.items()}


def _stand_in_launchers(monkeypatch):
    """The CUDA path's wiring on the CPU: ``_FusedQKVAttention`` with its two
    launchers stood in by the plain versions, counted as the launchers
    count (as tests/test_torch_train.py runs it)."""
    from vavae_tpu_torch.models import layers
    from vavae_tpu_torch.ops import flash_attention as fa

    def fwd(qkv5, tables):
        fa.fused_qkv_attention.launches += 1
        return fa.fused_qkv_attention_reference(qkv5, tables)

    def bwd(qkv5, g, tables):
        fa.fused_qkv_attention.bwd_launches += 1
        return fa.fused_qkv_attention_bwd_reference(qkv5, g, fa.fold_sin(tables))

    monkeypatch.setattr(fa, "_launch_fwd", fwd)
    monkeypatch.setattr(fa, "_launch_bwd", bwd)
    monkeypatch.setattr(layers, "fused_qkv_attention", lambda qkv5, rope=None: (
        fa._FusedQKVAttention.apply(qkv5, *rope)))


def test_steps_launch_both_kernels_twice_and_once_a_block(monkeypatch):
    """On the kernels' path (launchers stood in on the CPU), each of the
    command's steps on LightningDiT-S/2 at full width (depth 12) launches #1
    24 times and #2 12 times: remat "dots" runs the forward again in the
    backward. The losses are those of the plain path within bf16's spread."""
    dev = torch.device("cpu")
    x, y = big_variant.draw_batch(2, 0)
    plain_tr = big_variant.build_trainer(big_variant.build_model("LightningDiT-S/2", dev))
    plain = big_variant.train_steps(plain_tr, plain_tr.init_state(), (x, y), 2)
    assert plain["launches"] == [[0, 0], [0, 0]]
    _stand_in_launchers(monkeypatch)
    trainer = big_variant.build_trainer(big_variant.build_model("LightningDiT-S/2", dev))
    out = big_variant.train_steps(trainer, trainer.init_state(), (x, y), 2)
    assert out["launches"] == [[24, 12], [24, 12]]
    assert out["losses"][0] == plain["losses"][0]  # the forward is the plain version's
    assert max_rel(out["losses"][1], plain["losses"][1]) < 1e-2


def test_command_raises_without_a_card(monkeypatch):
    """Without ``--device cpu`` on a machine with no card, the command
    raises before it builds anything."""
    assert not torch.cuda.is_available()
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        big_variant.main(["LightningDiT-S/2", "2"])


def test_fsdp_world_of_two_matches_one_process(tmp_path):
    """A gloo world of two (``tests/torch_dist_worker.py``) runs the
    command's body on LightningDiT-S/2 at batch 2: each rank holds half of
    adaLN's (2304, 384), its state at FSDP2's padded arithmetic, and the
    losses equal one process's within 2e-4 relative (the JAX mesh tests'
    tolerance)."""
    world = W.Launch(["big_variant"], 2, tmp_path)
    one = big_variant.run("LightningDiT-S/2", 2, 2, 0, "cpu")
    world.wait()
    for rank in range(2):
        rec = torch.load(tmp_path / f"big_variant_{rank}.pt")
        assert (rec["rank"], rec["n_devices"], rec["mesh"], rec["backend"]) == (
            rank, 2, "fsdp=2", "gloo")
        assert rec["largest_param_shape"] == [2304, 384]
        assert rec["largest_param_shard_shape"] == [1152, 384]
        for key in ("loss_step1", "loss_step2"):
            assert max_rel(rec[key], one[key]) < 2e-4, (key, rec[key], one[key])
        assert all(v["measured"] == v["arithmetic"] for v in rec["state_bytes"].values())
        # half the state on each rank, less than half where a dim is odd
        # (the 1,001-row label table: 501 rows on rank 0, 500 on rank 1)
        n = one["state_bytes"]["nu"]["measured"] // 4
        assert rec["state_bytes"]["params"]["measured"] == 4 * (n + 384) // 2
        assert rec["state_bytes"]["nu"]["measured"] == 4 * (n + (384 if rank == 0 else -384)) // 2


def test_big_variant_imports_neither_jax_nor_the_jax_package():
    """The command's module, and the command run on the CPU, with jax,
    flax and ``vavae_tpu`` made unimportable."""
    text = (REPO / "vavae_tpu_torch" / "apps" / "big_variant.py").read_text()
    for word in ("import jax", "from jax", "vavae_tpu.", "import vavae_tpu\n"):
        assert word not in text
    code = (
        "import sys, runpy\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vavae_tpu'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.argv = ['vavae_tpu_torch', 'big_variant', 'LightningDiT-S/2', '2', '--device',"
        " 'cpu', '--steps', '1']\n"
        "try:\n"
        "    runpy.run_module('vavae_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax', 'vavae_tpu') for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(REPO),
                                           "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0 and out.stdout.splitlines()[-1] == "ok", out.stderr[-4000:]
    assert json.loads(out.stdout.splitlines()[-2])["loss_step2"] is None
