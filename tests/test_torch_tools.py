"""The port's training tools on the CPU against the JAX package: the LR
schedules, step timing and the ``VAVAE_PROFILE`` window, TensorBoard event
files (scalars and text read back equal to what the JAX package's
``MetricsLogger`` wrote), the async checkpoint writer (the five cases of
``tests/test_async_checkpoint.py`` on a port train state) and both trainers
with it on and off, and the ``VAVAE_ATTN_NATURAL=0`` attention route."""
import glob
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import max_rel, one_thread, tiny_dit_pair  # noqa: F401
from vavae_tpu.utils import schedulers as jax_sched
from vavae_tpu_torch.train import checkpoint as ckpt_lib
from vavae_tpu_torch.utils import profiling
from vavae_tpu_torch.utils import schedulers as sched

pytestmark = pytest.mark.usefixtures("one_thread")

STEPS = list(range(0, 1300, 3)) + [10, 100, 999, 1000, 1001]


# -- schedules -------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(1e-4, 100, 1000), (2e-4, 0, 500, 1e-6, 1e-5),
                                  (1.0, 10, 20, 0.1, 0.01), (3e-4, 1000, 800)])
def test_warmup_cosine_matches_jax(args):
    jax_fn, port_fn = jax_sched.warmup_cosine(*args), sched.warmup_cosine(*args)
    assert max(abs(float(jax_fn(s)) - port_fn(s)) for s in STEPS) <= 1e-7


def test_cycle_and_epoch_schedules_match_jax():
    cyc = ([1.0, 0.5], [0.1, 0.01], [10, 5], [100, 200], [1e-6, 0.2])
    for args in (cyc, cyc[:4]):
        jax_fn, port_fn = jax_sched.warmup_cosine_cycles(*args), sched.warmup_cosine_cycles(*args)
        assert max(abs(jax_fn(s) - port_fn(s)) for s in STEPS) <= 1e-7
    for args in ((2e-4, 100), (1e-3, 50, 1e-5)):
        jax_fn, port_fn = jax_sched.cosine_epochs(*args), sched.cosine_epochs(*args)
        assert max(abs(jax_fn(e) - port_fn(e)) for e in range(150)) <= 1e-7


# -- timing and the profiler window ------------------------------------------------------


def test_step_timer_counts_steps_after_the_fence():
    timer = profiling.StepTimer()
    x = torch.randn(64, 64)
    for _ in range(5):
        x = x @ x / 64
        timer.step()
    rate = timer.rate(sync_on={"loss": x})
    assert 0 < rate < float("inf")
    timer.reset()
    assert timer.rate() == 0.0


def _run_window(monkeypatch, tmp_path, steps, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    started = []
    real = profiling._start_profiler
    monkeypatch.setattr(profiling, "_start_profiler",
                        lambda d: (started.append(current[0]), real(d))[1])
    tracer = profiling.WindowTracer()
    current = [None]
    for i in steps:
        current[0] = i
        tracer.step(i, sync_on=torch.ones(2) * i)
        active = tracer._prof is not None
        yield i, active
    tracer.close()
    assert tracer._prof is None
    assert len(started) == (1 if "VAVAE_PROFILE" in env else 0)


def test_window_tracer_traces_only_its_window(monkeypatch, tmp_path):
    log_dir = str(tmp_path / "prof")
    seen = dict(_run_window(monkeypatch, tmp_path, range(1, 10), VAVAE_PROFILE=log_dir,
                            VAVAE_PROFILE_AT="3", VAVAE_PROFILE_STEPS="2"))
    assert [i for i, a in seen.items() if a] == [3, 4]
    traces = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(traces) == 1 and json.load(open(traces[0]))["traceEvents"]


def test_window_tracer_resumed_past_at_and_closed_early(monkeypatch, tmp_path):
    """A resumed loop starts past VAVAE_PROFILE_AT: the first step seen opens
    the window (the >= rule); close() stops a window cut short."""
    log_dir = str(tmp_path / "prof")
    seen = dict(_run_window(monkeypatch, tmp_path, range(40, 42), VAVAE_PROFILE=log_dir))
    assert all(seen.values())
    assert len(glob.glob(os.path.join(log_dir, "*.pt.trace.json"))) == 1


def test_window_tracer_does_nothing_unset(monkeypatch, tmp_path):
    monkeypatch.delenv("VAVAE_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    assert not any(a for _, a in _run_window(monkeypatch, tmp_path, range(1, 20)))
    assert os.listdir(tmp_path) == []


def test_trace_block_and_memory_stats(tmp_path):
    """``trace`` writes one Chrome trace of its block; without CUDA there
    is no device memory to report."""
    with profiling.trace(str(tmp_path / "t")):
        torch.randn(32, 32) @ torch.randn(32, 32)
    (path,) = glob.glob(str(tmp_path / "t" / "*.pt.trace.json"))
    assert any(e.get("name") == "aten::mm" for e in json.load(open(path))["traceEvents"])
    assert profiling.device_memory_stats() == {}


# -- TensorBoard event files -----------------------------------------------------------------


def _tb_records(log_dir):
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    (path,) = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    out = []
    for e in EventFileLoader(path).Load():
        if e.HasField("summary"):
            for v in e.summary.value:
                out.append((v.tag, e.step, v.metadata.plugin_data.plugin_name,
                            list(v.tensor.float_val) or list(v.tensor.string_val)))
        else:
            out.append(("file_version", e.step, "", [e.file_version]))
    return path, out


def test_tensorboard_records_match_jax(tmp_path, monkeypatch):
    """Scalars and text through both MetricsLoggers (the JAX one writes with
    torch's SummaryWriter), read back by tensorboard's reader: the same
    records; the port's file passes its CRCs; JSONL lines alike."""
    import sys

    pytest.importorskip("tensorboard")
    # tensorboard's reader on its own record code, without importing TensorFlow
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    from vavae_tpu.utils.metrics_logger import MetricsLogger as JaxLogger
    from vavae_tpu_torch.utils.metrics_logger import MetricsLogger, read_events

    for cls, d in ((JaxLogger, "jax"), (MetricsLogger, "port")):
        log = cls(str(tmp_path / d), enabled=True)
        log.log_text("config", "{'train': {'max_steps': 8}, 'é': 1}")
        log.log_scalars(2, {"train/loss": 0.5, "train/steps_per_sec": 3.25})
        log.log_scalars(4, {"val/loss": 1.0 / 3.0})
        log.close()
    _, want = _tb_records(str(tmp_path / "jax"))
    path, got = _tb_records(str(tmp_path / "port"))
    assert got == want and len(got) == 5
    assert len(read_events(path)) == 5
    strip = lambda d: [{k: v for k, v in json.loads(x).items() if k != "time"}  # noqa: E731
                       for x in open(tmp_path / d / "metrics.jsonl")]
    assert strip("port") == strip("jax")
    data = bytearray(open(path, "rb").read())
    data[30] ^= 1
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_events(path)


# -- the async checkpoint writer --------------------------------------------------------------


def _state():
    """A tiny port DiT train state on the CPU."""
    from vavae_tpu_torch.models.dit import LightningDiT
    from vavae_tpu_torch.train.dit_trainer import DiTTrainer
    from vavae_tpu_torch.transport import create_transport

    torch.manual_seed(0)
    model = LightningDiT(input_size=4, patch_size=1, in_channels=4, hidden_size=32, depth=1,
                         num_heads=2, num_classes=3, use_swiglu=True, use_rope=True,
                         use_rmsnorm=True)
    return DiTTrainer(model, create_transport("Linear", "velocity")).init_state()


def _gated(monkeypatch, gate):
    real = ckpt_lib.write_safetensors
    monkeypatch.setattr(ckpt_lib, "write_safetensors",
                        lambda *a: (gate.wait(timeout=30), real(*a))[-1])


def test_save_overlaps_and_wait_is_durable(tmp_path, monkeypatch):
    gate = threading.Event()
    _gated(monkeypatch, gate)
    state = _state()
    w = ckpt_lib.AsyncCheckpointer()
    path = w.save(str(tmp_path), 5, state)
    assert path.endswith("0000005.safetensors") and not os.path.exists(path)
    gate.set()
    w.wait()
    fresh = _state()
    for p in fresh.params:
        p.data.zero_()
    ckpt_lib.restore_checkpoint(path, fresh)
    assert all(torch.equal(a, b) for a, b in zip(fresh.params, state.params))


def test_snapshot_is_consistent_despite_later_mutation(tmp_path, monkeypatch):
    """On the CPU the host arrays are views of the live tensors: the
    snapshot must own its memory, so an in-place update while the write is
    in flight stays out of the file."""
    gate = threading.Event()
    _gated(monkeypatch, gate)
    state = _state()
    before = [p.clone() for p in state.params] + [m.clone() for m in state.opt.mu]
    w = ckpt_lib.AsyncCheckpointer()
    path = w.save(str(tmp_path), 5, state)
    with torch.no_grad():
        for t in state.params + state.opt.mu + state.ema_params:
            t.fill_(-1.0)  # the optimizer's next in-place step
    gate.set()
    w.wait()
    restored = _state()
    ckpt_lib.restore_checkpoint(path, restored)
    assert all(torch.equal(a, b) for a, b in zip(restored.params + restored.opt.mu, before))
    sync = tmp_path / "sync"
    for t, b in zip(state.params + state.opt.mu, before):
        t.data.copy_(b)
    with torch.no_grad():
        for e, p in zip(state.ema_params, restored.ema_params):
            e.copy_(p)
    ckpt_lib.save_checkpoint(str(sync), 5, state)
    assert (sync / "0000005.safetensors").read_bytes() == open(path, "rb").read()


def test_on_complete_runs_after_durable_write(tmp_path):
    w = ckpt_lib.AsyncCheckpointer()
    seen = {}

    def record():
        seen["exists"] = os.path.exists(os.path.join(tmp_path, "0000005.safetensors"))
        with open(os.path.join(tmp_path, "epoch.json"), "w") as f:
            json.dump({"epochs_done": 1}, f)

    w.save(str(tmp_path), 5, _state(), config={"a": 1}, on_complete=record)
    w.wait()
    assert seen["exists"] is True
    assert json.load(open(tmp_path / "epoch.json"))["epochs_done"] == 1
    assert json.load(open(tmp_path / "config.json"))["a"] == 1


def test_writer_error_surfaces_on_next_call(tmp_path, monkeypatch):
    def boom(*a):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_lib, "write_safetensors", boom)
    w = ckpt_lib.AsyncCheckpointer()
    state = _state()
    w.save(str(tmp_path), 1, state)
    with pytest.raises(OSError, match="disk full"):
        w.wait()
    monkeypatch.setattr(ckpt_lib, "write_safetensors", lambda *a: None)
    w.save(str(tmp_path), 2, state)  # the error was raised once and cleared
    w.wait()


def test_second_save_drains_first(tmp_path, monkeypatch):
    order = []
    real = ckpt_lib.write_safetensors

    def slow(path, *a):
        time.sleep(0.1)
        order.append(os.path.basename(path))
        real(path, *a)

    monkeypatch.setattr(ckpt_lib, "write_safetensors", slow)
    w = ckpt_lib.AsyncCheckpointer()
    state = _state()
    w.save(str(tmp_path), 1, state)
    w.save(str(tmp_path), 2, state)  # blocks until save 1 is written
    w.wait()
    assert order == ["0000001.safetensors", "0000002.safetensors"]
    assert ckpt_lib.latest_checkpoint(str(tmp_path)).endswith("0000002.safetensors")


def _tree_bytes(root):
    return {os.path.relpath(p, root): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(root, "**", "*"), recursive=True))
            if p.endswith((".safetensors", ".json")) and os.path.isfile(p)}


def test_do_train_async_checkpoints_equal_sync(tmp_path, monkeypatch):
    """do_train with train.async_checkpoint on (the default) and off writes
    the same files byte for byte (whatever torch's global stream held before:
    the fresh weights come from train.global_seed), and VAVAE_PROFILE traces
    its window; the config goes to TensorBoard as text."""
    import vavae_tpu_torch.models.dit as dit
    from test_torch_train import _tiny_train_config
    from vavae_tpu_torch.pipelines.train_dit import do_train

    monkeypatch.setitem(dit._VARIANTS, "S", dict(depth=2, hidden_size=144, num_heads=2))
    monkeypatch.setenv("VAVAE_PROFILE", str(tmp_path / "prof"))
    monkeypatch.setenv("VAVAE_PROFILE_AT", "2")
    monkeypatch.setenv("VAVAE_PROFILE_STEPS", "2")
    trees = {}
    for mode in (True, False):
        cfg = _tiny_train_config(tmp_path, 4).merged_with({"train": {
            "async_checkpoint": mode, "output_dir": str(tmp_path / f"out_{mode}"),
            "sample_every": None}})
        torch.manual_seed(int(mode))  # do_train seeds the fresh weights itself
        do_train(cfg, device="cpu")
        exp = tmp_path / f"out_{mode}" / "tiny"
        trees[mode] = _tree_bytes(str(exp))
        _, records = _tb_records(str(exp / "tb"))
        assert records[1][0] == "config/text_summary"
    assert set(trees[True]) >= {"checkpoints/0000002.safetensors",
                                "checkpoints/0000004.safetensors", "checkpoints/config.json"}
    cfg_key = "checkpoints/config.json"
    for mode in (True, False):  # the output_dir differs, so config.json does
        trees[mode].pop(cfg_key)
    assert trees[True] == trees[False]
    assert len(glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))) == 2


def test_train_vavae_async_checkpoints_equal_sync(tmp_path):
    """run_stages with async on and off: the same checkpoints, epoch.json
    and best/metric.json, byte for byte."""
    from test_torch_train_vavae import tiny_cfg
    from vavae_tpu_torch.data.image_folder import ImageFolderDataset
    from vavae_tpu_torch.pipelines import train_vavae as tv
    from vavae_tpu_torch.utils.png import write_pngs

    rs = np.random.default_rng(0)
    for c in ("a", "b"):
        os.makedirs(tmp_path / "img" / c)
        write_pngs(rs.integers(0, 256, (4, 40, 40, 3)).astype(np.uint8),
                   [str(tmp_path / "img" / c / f"{i}.png") for i in range(4)])
    ds = ImageFolderDataset(str(tmp_path / "img"), image_size=32)
    trees = {}
    for mode in (True, False):
        cfg = tiny_cfg().merged_with({"train": {"async_checkpoint": mode, "log_images_every": 0}})
        out = tmp_path / f"out_{mode}"
        torch.manual_seed(0)
        tv.run_stages(cfg, ds, ds, stages=[{"epochs": 1}, {"epochs": 1}], output_dir=str(out),
                      batch_size=4, device="cpu")
        trees[mode] = _tree_bytes(str(out))
    assert "stage1/epoch.json" in trees[True] and "stage2/best/metric.json" in trees[True]
    assert trees[True] == trees[False]


# -- the VAVAE_ATTN_NATURAL=0 route ------------------------------------------------------------


def _dit_io(seed=0):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((3, 8, 8, 4)).astype(np.float32)
    t = rs.random(3).astype(np.float32)
    y = np.array([1, 4, 9], np.int32)
    return x, t, y


def test_attention_route_matches_jax(monkeypatch):
    """A non-qk-norm DiT under VAVAE_ATTN_NATURAL=0: the port's forward and
    the loss gradients against the JAX model under the same value, fp32, at
    the attention tests' tolerances; with the port's plain attention on the
    CPU the natural route agrees to fp32 rounding (the variable is read at
    every forward)."""
    monkeypatch.setenv("VAVAE_ATTN_NATURAL", "0")
    jm, params, tm = tiny_dit_pair(0)
    x, t, y = _dit_io()

    def jax_loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
        return jnp.sum(out * jnp.cos(out)), out

    (_, want), jax_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    xt, tt, yt = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long()
    out = tm(xt, tt, yt)
    torch.sum(out * torch.cos(out)).backward()
    assert max_rel(out.detach().numpy(), np.asarray(want)) < 1e-5
    from vavae_tpu_torch.utils.weights import dit_state_to_jax

    got = dit_state_to_jax({n: p.grad for n, p in tm.named_parameters()})
    qkv_got = got["blocks"]["block"]["attn"]["qkv"]["kernel"]
    qkv_want = np.asarray(jax_grads["blocks"]["block"]["attn"]["qkv"]["kernel"])
    assert max_rel(qkv_got, qkv_want) < 1e-4
    flat = lambda tree: np.concatenate([np.asarray(v).ravel()  # noqa: E731
                                        for v in jax.tree_util.tree_leaves(tree)])
    assert max_rel(flat(got), flat(jax_grads)) < 1e-4
    monkeypatch.setenv("VAVAE_ATTN_NATURAL", "1")
    with torch.no_grad():
        other = tm(xt, tt, yt)
    assert max_rel(other.numpy(), out.detach().numpy()) < 1e-6
