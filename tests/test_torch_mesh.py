"""The port's (data, fsdp, tensor) mesh over worlds of two processes on
gloo (mirrors tests/test_mesh.py).

One launch (``tests/torch_dist_worker.py``) runs, in each of two
processes: the meshes and collectives; two DiT train steps under data
parallelism, FSDP and tensor parallelism (fused-qkv, QK-norm and GELU-MLP
models); grad_accum = 2 under DP; and one DP, FSDP and tensor-parallel step
from the JAX init with the JAX draws. A second launch, of four processes,
runs the DiT steps on the two-axis meshes (data × fsdp, data × tensor,
fsdp × tensor) and under tensor sizes that divide neither the heads nor
the MLP width (tensor = 4 on 170 MLP rows, on 6 and on 2 heads, with
QK-norm; fsdp × tensor on 3 heads and on 1), the tensor = 4 step from the
JAX init, and a checkpoint passed between tensor = 4 and tensor = 1. Each
is held against one process on the global batch, and the steps from the
JAX init against the JAX ``DiTTrainer`` on the 8-device CPU mesh under the
same layout.
"""
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

LR = W.TRAIN_OPT["lr"]
JAX_OPT = dict(lr=1e-3, beta2=0.95, weight_decay=0.01, max_grad_norm=1.0, ema_decay=0.9)


def _jax_reference(*outs):
    """The JAX DiTTrainer's step on mesh8 from its own init under each
    layout of JAX_LAYOUTS, and the port's inputs for the same step
    (``jax_inputs.pt`` in each of ``outs``)."""
    import jax

    from test_torch_train import _jax_draws, create_jax_transport
    from vavae_tpu.models.dit import LightningDiT as JaxDiT
    from vavae_tpu.parallel.mesh import make_mesh
    from vavae_tpu.train.dit_trainer import DiTTrainer as JaxTrainer
    from vavae_tpu_torch.utils.weights import dit_state_from_jax

    jm = JaxDiT(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=2,
                num_heads=4, num_classes=8, use_swiglu=True, use_rope=True,
                use_rmsnorm=True, class_dropout_prob=0.0)
    x, y = W.dit_batches(1, seed=11)[0]
    jtr = create_jax_transport(path_type="Linear", prediction="velocity")
    rng = jax.random.PRNGKey(0)
    t, x0 = _jax_draws(jtr, jax.random.fold_in(rng, 0), x.shape)
    res = {}
    for name, (_, mesh_kw) in W.JAX_LAYOUTS.items():
        jt = JaxTrainer(jm, jtr, make_mesh(devices=jax.devices("cpu")[:8], **mesh_kw), **JAX_OPT)
        jstate = jt.replicate(jt.init_state(rng, x.shape))
        if name == "dp":
            params0 = dit_state_from_jax(jax.device_get(jstate.params))
            for out in outs:
                torch.save({"params": params0, "opt": JAX_OPT, "batch": (x, y),
                            "draws": (t, x0, None)}, out / "jax_inputs.pt")
        jstate, jmetrics = jt.train_step(jstate, rng, jt.shard_batch((x, y)))
        res[name] = {"loss": float(jmetrics["loss"]), "grad_norm": float(jmetrics["grad_norm"]),
                     "params": dit_state_from_jax(jax.device_get(jstate.params)),
                     "ema": dit_state_from_jax(jax.device_get(jstate.ema_params))}
    return res


def _single():
    """Two steps of each DIT_CASES model in one process on the global batches."""
    out = {}
    for name, (_, kw) in W.DIT_CASES.items():
        tr = W.dit_trainer(W.tiny_dit(**kw))
        state = tr.init_state()
        losses, norms = W.run_dit_steps(tr, state, W.dit_batches(2))
        out[name] = {"losses": losses, "norms": norms, "names": state.names,
                     "params": [p.detach().clone() for p in state.params],
                     "ema": state.ema_params, "mu": state.opt.mu, "nu": state.opt.nu}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, mesh8):
    """The worlds of 2's and of 4's results (the DiT steps of each layout in
    ``dit_steps``, by layout); the JAX reference before they start, one
    process's steps while they run."""
    out = tmp_path_factory.mktemp("mesh")
    out4 = tmp_path_factory.mktemp("mesh4")
    jax_ref = _jax_reference(out, out4)
    cases = ("mesh", "dit_steps", "grad_accum", "jax_inputs")
    cases4 = ("dit_steps", "jax_inputs", "tp_ckpt")
    launch = W.Launch(cases, 2, out)
    launch4 = W.Launch(cases4, 4, out4)
    single = _single()
    launch.wait()
    launch4.wait()

    def load(case, root=out, n=2):
        return [torch.load(root / f"{case}_{r}.pt", weights_only=False) for r in range(n)]

    res = {case: load(case) for case in cases} | {"jax": jax_ref, "single": single}
    res |= {case + "4": load(case, out4, 4) for case in cases4}
    return res


def _layout_ranks(world, layout, case="dit_steps"):
    """Every rank's result of ``case`` under ``layout``, from the world it
    spans."""
    return [r[layout] for r in world[case if layout in world[case][0] else case + "4"]]


# -- the mesh ------------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axis", [((2, 1, 1), "data"), ((1, 2, 1), "fsdp"),
                                        ((1, 1, 2), "tensor"), ((None, 1, 1), "data")])
def test_mesh_shape_and_batch_rows(world, shape, axis):
    """make_mesh lays two ranks along the named axis (data=None takes the
    rest); shard_batch gives each data rank its half of the batch, tensor
    ranks the whole; the DP mean of the rows' means is the global mean."""
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    for rank, res in enumerate(world["mesh"]):
        m = res["meshes"][str(shape)]
        assert m["shape"] == {"data": 1, "fsdp": 1, "tensor": 1} | {axis: 2}
        assert m["coords"] == {"data": 0, "fsdp": 0, "tensor": 0} | {axis: rank}
        want = x if axis == "tensor" else x[4 * rank: 4 * rank + 4]
        np.testing.assert_array_equal(m["rows"].numpy(), want)
        assert m["mean"] == pytest.approx(x.mean())


def test_allgather_and_process_names(world):
    r0, r1 = world["mesh"]
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, 2)
    assert r0["allgather"] == r1["allgather"] == [[0.0, 7.0], [1.0, 7.0]]
    assert r0["fname"] == "latents_rank00_shard003.safetensors"
    assert r1["fname"] == "latents_rank01_shard003.safetensors"


def test_dp_gradient_matches_single_process(world):
    """The mean of the ranks' gradients of mean((x @ w)²) is the gradient on
    the global batch (tests/test_mesh.py::test_sharded_grad_matches_single_device)."""
    w = torch.ones(4, 4, requires_grad=True)
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    torch.square(torch.from_numpy(x) @ w).mean().backward()
    for res in world["mesh"]:
        torch.testing.assert_close(res["grad"], w.grad, atol=1e-5, rtol=1e-6)


def test_launch_env_contracts(monkeypatch):
    """torchrun's variables, the JAX package's mapped onto them, none (a
    single process), and a world named without its address refused."""
    from vavae_tpu_torch.parallel.mesh import launch_env, multihost_init

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert launch_env() is None
    assert multihost_init("cpu") == torch.device("cpu")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    env = launch_env()
    assert (env["rank"], env["world_size"], env["addr"], env["port"]) == (3, 4, "10.0.0.1", 1234)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        launch_env()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("LOCAL_RANK", "0")
    env = launch_env()  # torchrun's names win
    assert (env["rank"], env["world_size"], env["local_rank"]) == (1, 2, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost_init("cuda")


# -- DiT training under each layout -----------------------------------------------------------


@pytest.mark.parametrize("layout", list(W.DIT_CASES))
def test_layout_step_matches_single_process(world, layout):
    """Two steps under DP, FSDP = 2 and tensor = 2 (fused qkv with SwiGLU,
    QK-norm, GELU MLP) in a world of 2, and under data × fsdp (HSDP), data
    × tensor, fsdp × tensor and the uneven tensor splits in a world of 4
    (tensor = 4 on 170 MLP rows, 6 heads, 2 heads, with QK-norm; fsdp 2 ×
    tensor 2 on 3 heads and on 1): every rank's losses equal
    and within 2e-4 of one process's (tests/test_mesh.py's tolerance), grad
    norms (clipping on) within 1e-5; the gathered params, EMA and Adam first
    moment within 1e-4 relative, each weight within 2·lr a step."""
    ranks = _layout_ranks(world, layout)
    r0 = ranks[0]
    ref = world["single"][layout]
    for r in ranks[1:]:
        assert r["losses"] == r0["losses"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=2e-4)
    np.testing.assert_allclose(r0["norms"], ref["norms"], rtol=1e-5)
    for key in ("params", "ema", "mu"):
        for name in ref["names"]:
            for r in ranks[1:]:
                assert torch.equal(r0[key][name], r[key][name]), (key, name)
        got = [r0[key][n] for n in ref["names"]]
        assert W.rel(got, ref[key]) < 1e-4, key
    assert max((r0["params"][n] - p).abs().max().item()
               for n, p in zip(ref["names"], ref["params"])) <= 2 * 2 * LR


def test_fsdp_shards_the_state(world):
    """FSDP = 2: the parameters are FSDP2 DTensors and each rank holds half
    of every parameter (dim 0), as the JAX trainer shards every leaf."""
    total = sum(p.numel() for p in world["single"]["fsdp"]["params"])
    for rank, res in enumerate(world["dit_steps"]):
        f = res["fsdp"]
        assert f["qkv_dtensor"]
        assert f["local_numel"] < 0.55 * total
        full = f["params"]["blocks.0.attn.qkv.weight"]
        torch.testing.assert_close(f["qkv_local"], full.chunk(2)[rank], rtol=0, atol=0)
        assert not res["dp"]["qkv_dtensor"] and res["dp"]["local_numel"] == total


@pytest.mark.parametrize("layout", ["tp", "tp_qknorm", "tp_mlp"])
def test_tensor_parallel_splits_by_heads(world, layout):
    """tensor = 2: rank r holds q, k and v of heads 2r and 2r + 1 (qkv rows
    s·C + [r·C/2, (r+1)·C/2) for s = q, k, v) and runs attention on its 2
    local heads; w12 holds the matching halves of gate and up, fc1 a plain
    half."""
    C = 64
    for rank, res in enumerate(world["dit_steps"]):
        t = res[layout]
        assert t["num_heads"] == 2
        rows = torch.cat([s * C + torch.arange(rank * C // 2, (rank + 1) * C // 2)
                          for s in range(3)])
        qkv = t["params"]["blocks.0.attn.qkv.weight"]
        torch.testing.assert_close(t["qkv_local"], qkv[rows], rtol=0, atol=0)
        name = next(n for n in t["params"] if n.startswith("blocks.0.mlp.")
                    and n.endswith(".weight"))
        fan_out = t["params"][name]
        F = fan_out.shape[0] // (2 if "w12" in name else 1)
        segs = range(2) if "w12" in name else range(1)
        rows = torch.cat([s * F + torch.arange(rank * F // 2, (rank + 1) * F // 2) for s in segs])
        torch.testing.assert_close(t["fan_out_local"], fan_out[rows], rtol=0, atol=0)


def test_grad_accum_under_dp_is_one_step_on_the_mean_gradient(world):
    """grad_accum = 2 under DP: two micro-steps on two global batches give
    one optimizer step (clip, then AdamW) on the mean of the two global
    gradients, each drawn from its micro-step's generator."""
    from vavae_tpu_torch.train.dit_trainer import (
        adam_init, adamw_update, clip_by_global_norm, global_draws)

    tr = W.dit_trainer(W.tiny_dit(class_dropout_prob=0.0))
    names, params = zip(*tr.model.named_parameters())
    acc = [torch.zeros_like(p) for p in params]
    for k, (x, y) in enumerate(W.dit_batches(2, seed=3)):
        t, x0, _ = global_draws(tr.model, tr.transport, 8, x.shape[1:], tr.generator(k))
        x, y = torch.from_numpy(x), torch.from_numpy(y).long()
        loss = tr.transport.losses_at(lambda xt, tt: tr.model(xt, tt, y, train=True),
                                      t, x0, x)["loss"].mean()
        for a, g in zip(acc, torch.autograd.grad(loss, params)):
            a.add_(g / 2)
    grads = clip_by_global_norm(acc, W.TRAIN_OPT["max_grad_norm"])
    want = [p.detach().clone() for p in params]
    adamw_update(want, grads, adam_init(want), LR, tr.beta2)
    for res in world["grad_accum"]:
        got = [res["params"][n] for n in names]
        assert W.rel(got, want) < 1e-4
        assert max((g - w).abs().max().item() for g, w in zip(got, want)) <= 2 * LR


def _check_against_jax(world, layout):
    want = world["jax"][layout]
    ranks = _layout_ranks(world, layout, "jax_inputs")
    r0 = ranks[0]
    assert all(r["loss"] == r0["loss"] for r in ranks)
    for key in ("loss", "grad_norm"):
        assert abs(r0[key] - want[key]) <= 1e-4 * abs(want[key]), key
    names = list(want["params"])
    for key in ("params", "ema"):
        got = [r0[key][n] for n in names]
        ref = [want[key][n] for n in names]
        assert W.rel(got, ref) < 1e-4, key
        assert max((g - w).abs().max().item() for g, w in zip(got, ref)) <= 2 * JAX_OPT["lr"]


def test_dp_step_matches_jax_mesh8(world):
    """The port's world-2 DP step on rank shards, from the JAX init with the
    JAX draws handed in, against the JAX DiTTrainer's step on mesh8 on the
    global batch: loss and grad norm within 1e-4 relative, params and EMA
    within 1e-4 (Frobenius over all tensors) and each element within 2·lr,
    the tolerance of tests/test_torch_train.py's trainer parity."""
    _check_against_jax(world, "dp")


@pytest.mark.parametrize("layout", ["fsdp", "tp", "tp4"])
def test_sharded_step_matches_jax_mesh8(world, layout):
    """As test_dp_step_matches_jax_mesh8, for the port's FSDP = 2 and tensor
    = 2 steps (gathered) against the JAX DiTTrainer's step on mesh8 with
    fsdp = 4 and tensor = 2, and for the port's tensor = 4 step in a world
    of 4 (MLP rows 43, 43, 42, 42 of 170) against the JAX step on mesh8
    with data = 2 and tensor = 4 (where GSPMD leaves ``w3`` replicated), at
    the same tolerance."""
    _check_against_jax(world, layout)


def test_fsdp_over_tensor_split_shards_the_heads(world):
    """fsdp = 2 × tensor = 2 (rank = 2·fsdp + tensor): each rank's qkv is
    the fsdp half (dim 0) of its tensor rank's heads' q, k and v rows, and
    attention runs on the 2 local heads."""
    C = 64
    for rank, res in enumerate(world["dit_steps4"]):
        f = res["fsdp_tp"]
        assert f["qkv_dtensor"] and f["num_heads"] == 2
        t, k = rank % 2, rank // 2
        rows = torch.cat([s * C + torch.arange(t * C // 2, (t + 1) * C // 2) for s in range(3)])
        full = f["params"]["blocks.0.attn.qkv.weight"]
        torch.testing.assert_close(f["qkv_local"], full[rows].chunk(2)[k], rtol=0, atol=0)


def _sizes(n: int, parts: int) -> list[int]:
    return [n // parts + (r < n % parts) for r in range(parts)]


@pytest.mark.parametrize("layout", ["tp4", "tp4_heads6", "tp4_heads2", "tp4_qknorm",
                                    "tp4_qknorm_heads2", "fsdp_tp_heads3", "fsdp_tp_heads1"])
def test_uneven_tensor_split(world, layout):
    """A tensor size that divides neither the heads nor the MLP width: the
    heads cut whole and the MLP rows one by one into contiguous pieces whose
    sizes differ by at most one, the first ``size % tensor`` ranks holding
    one more (tensor = 4 on 6 heads: 2, 2, 1, 1; on 170 rows: 43, 43, 42,
    42; on 2 heads: 1, 1, 0, 0). Rank r's qkv is q, k and v of its heads (its
    FSDP half under fsdp × tensor, where a rank with no heads keeps its
    empty piece whole), and its fan-out rows are its rows of gate and of
    up."""
    shape, kw = W.DIT_CASES[layout]
    tensor, fsdp = shape[2], shape[1]
    C = kw.get("hidden_size", 64)
    H = kw.get("num_heads", 4)
    D = C // H
    for rank, res in enumerate(_layout_ranks(world, layout)):
        t, k = rank % tensor, rank // tensor % fsdp
        heads = _sizes(H, tensor)
        assert res["num_heads"] == heads[t]
        h0 = sum(heads[:t])
        rows = torch.cat([s * C + torch.arange(h0 * D, (h0 + heads[t]) * D) for s in range(3)])
        want = res["params"]["blocks.0.attn.qkv.weight"][rows]
        if fsdp > 1 and want.numel():
            want = want.chunk(fsdp)[k]
        torch.testing.assert_close(res["qkv_local"], want, rtol=0, atol=0)
        fan_out = res["params"]["blocks.0.mlp.w12.weight"]
        F = fan_out.shape[0] // 2
        sizes = _sizes(F, tensor)
        r0 = sum(sizes[:t])
        rows = torch.cat([s * F + torch.arange(r0, r0 + sizes[t]) for s in range(2)])
        want = fan_out[rows]
        if fsdp > 1:
            want = want.chunk(fsdp)[k]
        torch.testing.assert_close(res["fan_out_local"], want, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["tensor4_to_1", "tensor1_to_4"])
def test_checkpoint_moves_between_tensor_layouts(world, case):
    """A checkpoint written after step 1 under tensor = 4 (MLP 170 rows,
    uneven) and restored into a state of another init under tensor = 1, and
    the reverse: step 2 there gives one process's two steps, as the JAX
    package's layout-free checkpoints do. Losses within 2e-4 relative, the
    params, EMA and both Adam moments within 1e-4 (Frobenius), each weight
    within 2·lr a step; every rank alike."""
    ranks = [r[case] for r in world["tp_ckpt4"]]
    r0 = ranks[0]
    ref = world["single"]["tp4"]
    assert r0["step"] == 2 and r0["tensor"] == ([4, 1] if case == "tensor4_to_1" else [1, 4])
    for r in ranks[1:]:
        assert r["losses"] == r0["losses"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=2e-4)
    for key in ("params", "ema", "mu", "nu"):
        for name in ref["names"]:
            for r in ranks[1:]:
                assert torch.equal(r0[key][name], r[key][name]), (key, name)
        got = [r0[key][n] for n in ref["names"]]
        assert W.rel(got, ref[key]) < 1e-4, key
    assert max((r0["params"][n] - p).abs().max().item()
               for n, p in zip(ref["names"], ref["params"])) <= 2 * 2 * LR
