"""The tensor-parallel check (``vavae_tpu_torch/apps/tensor_parallel_check.py``)
on the CPU: ``train_dit`` from one saved init under tensor = 4 and fsdp 2 ×
tensor 2 in gloo worlds of four, held against one process, at
LightningDiT-S/2's width (6 heads: 2, 2, 1, 1 a rank under tensor = 4) cut
to depth 1; its record; its refusal without the cards.
"""
import json

import pytest

from test_torch_common import one_thread  # noqa: F401
from vavae_tpu_torch.apps import tensor_parallel_check as tpc

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    out = tmp_path_factory.mktemp("tpc")
    tpc.main(["--device", "cpu", "--model", "LightningDiT-S/2", "--depth", "1", "--batch", "4",
              "--steps", "3", "--layouts", "tensor4,fsdp2_tensor2", "--workdir", str(out / "w"),
              "--out", str(out / "record.json")])
    return json.loads((out / "record.json").read_text())


def test_layouts_match_one_process(record):
    """Each layout's losses and gradient norms of steps 1-2 and parameters
    after step 2 within phase 33's limits of the one-process run's; every
    rank's losses equal (checked by the command); the CPU launches nothing."""
    assert set(record["layouts"]) == {"tensor4", "fsdp2_tensor2"}
    assert list(record["one_card"]) == ["one_card"]
    for out in record["layouts"].values():
        dist = out["to_one_card"]
        assert dist["loss"] <= tpc.LOSS_TOL and dist["grad_norm"] <= tpc.NORM_TOL
        assert dist["params"] <= tpc.PARAM_TOL
        assert len(out["losses"]) == 3 and len(out["ranks"]) == 4
        assert all(r["launches_per_step"] == {} for r in out["ranks"])


def test_uneven_heads_and_rows_per_rank(record):
    """tensor = 4 cuts S/2's 6 heads 2, 2, 1, 1 and its 1,024 MLP rows into
    256 a rank; fsdp 2 × tensor 2 holds 3 heads and 512 rows a rank, each
    rank's state a quarter of the split parameters' and half of the rest."""
    t4, ft = record["layouts"]["tensor4"], record["layouts"]["fsdp2_tensor2"]
    assert [r["local_heads"] for r in t4["ranks"]] == [2, 2, 1, 1]
    assert [r["mlp_rows"] for r in t4["ranks"]] == [256] * 4
    assert [r["local_heads"] for r in ft["ranks"]] == [3] * 4
    assert [r["mlp_rows"] for r in ft["ranks"]] == [512] * 4
    for out in (t4, ft):
        for r in out["ranks"]:
            assert r["state_bytes"]["ema"] == r["state_bytes"]["nu"] == 4 * r["local_params"]
    assert sum(r["local_params"] for r in ft["ranks"][:2]) < t4["ranks"][0]["local_params"] * 2


def test_cmd_is_the_documented_train_dit(record):
    cmd = record["layouts"]["tensor4"]["cmd"]
    assert cmd.startswith("torchrun --nproc_per_node=4 -m vavae_tpu_torch train_dit --config ")
    assert "parallel.tensor=4" in cmd and "model.model_type=LightningDiT-S/2" in cmd


def test_refuses_without_the_cards():
    if tpc.torch.cuda.device_count() >= 4:
        pytest.skip("four cards present")
    with pytest.raises(RuntimeError, match="4 cards wanted"):
        tpc.main([])
