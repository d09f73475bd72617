"""User-ID classifier training (port of ``vavae_tpu/apps/train_classifier.py``).

Four modes: ``baseline`` (ResNet-18, cross-entropy), ``improved`` (a 256-d
head and a 64-d projection with a supervised, inter-user or global-negative
contrastive term; ``global`` keeps a class memory bank), ``calibrated``
(label smoothing + focal loss, or soft targets under mixup) and
``domain_adaptive`` (``DomainAdaptiveClassifier`` with its EMA prototype
bank). ``freeze_stages`` k keeps the stem and the first k ResNet stages
fixed (top-level ``conv1``/``bn1``/``layer{s}_`` names, under ``backbone.``
in the domain-adaptive mode; 3 there by default): they get no update and no
Adam moments, as under optax's ``multi_transform``; their batch-norm stats
still move in train mode. The optimizer is optax's ``adamw(lr,
weight_decay)`` (b1 0.9, b2 0.999, eps 1e-8) over the trainable parameters.

The step runs in fp32 with TF32 off in cuBLAS and cuDNN (``full_fp32``)
and no autocast, so the card's step holds to the CPU's. Random draws (mixup,
dropout) come from a generator seeded from ``(seed, step)``; ``train_step``
also takes them as ``draws`` (tests hand in the JAX package's).

Data-parallel (``mesh``; ``train_classifier`` under torchrun or the JAX
package's ``JAX_*`` variables): each rank steps on its rows of the global
batch, and the step is the global batch's, as the JAX step on its sharded
batch. The batch norms take the global moments (``sync_batch_norms``);
mixup mixes the gathered global batch with the global permutation and
each rank keeps its rows; the dropout masks are drawn at the global
shape; the contrastive term runs on the all-gathered projections (the
differentiable all-gather, whose backward returns each rank its rows'
gradient of every rank's copy of the term) and the memory and prototype
banks take the gathered batch; the gradients, the loss and the accuracy
are averaged over the ranks.

The state file is the JAX package's ``ClassifierState`` tree
(``classifier_state_tensors``): ``step``, ``params|…``, ``batch_stats|…``,
optax's AdamW state (``opt_state|0|…``, or under
``opt_state|inner_states|train|inner_state|0|…`` with frozen stages, their
moments empty nodes) and ``extras``, so the JAX package's
``restore_checkpoint`` reads a port file and ``restore_classifier`` a JAX
one (``.safetensors`` or legacy ``.msgpack``). Runs on the card unless
``--device cpu`` is passed.

    python -m vavae_tpu_torch.apps.train_classifier --real_dir DATA --epochs 30 --out clf.safetensors
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vavae_tpu_torch.apps.regularization import (
    expected_calibration_error,
    focal_loss,
    global_negative_contrastive,
    init_memory_bank,
    interuser_contrastive_loss,
    label_smoothing_loss,
    mixup,
    supcon_loss,
    update_memory_bank,
)
from vavae_tpu_torch.data.prefetch import prefetch
from vavae_tpu_torch.models.resnet import (
    DomainAdaptiveClassifier,
    ResNet18,
    init_flax_,
    update_feature_bank,
)
from vavae_tpu_torch.models.discriminator import sync_batch_norms
from vavae_tpu_torch.parallel import mesh as mesh_lib
from vavae_tpu_torch.parallel.mesh import DP, Mesh
from vavae_tpu_torch.train.checkpoint import find_adam, read_state_file
from vavae_tpu_torch.train.dit_trainer import AdamState, adam_init, adamw_update, step_seed
from vavae_tpu_torch.utils.device import full_fp32, resolve_device
from vavae_tpu_torch.utils.safetensors_io import (
    flatten,
    tree_metadata,
    unflatten,
    write_safetensors,
)
from vavae_tpu_torch.utils.weights import resnet_state_from_jax, resnet_state_to_jax

MODES = ("baseline", "improved", "calibrated", "domain_adaptive")


@dataclasses.dataclass
class ClassifierState:
    step: int
    names: list[str]            # the model's parameter names
    params: list[torch.Tensor]  # the model's own parameters, updated in place
    stat_names: list[str]       # its batch norms' running stats
    stats: list[torch.Tensor]
    trainable: list[bool]       # per parameter: False under a frozen stage
    opt: AdamState              # over the trainable parameters, in order
    # the global-contrastive memory bank ({"bank", "ptr"}, improved +
    # global) or the EMA prototype bank (domain_adaptive); None otherwise
    extras: Any = None


@dataclasses.dataclass
class ClassifierTrainer:
    num_classes: int = 31
    mode: str = "baseline"
    lr: float = 1e-3
    weight_decay: float = 1e-4
    supcon_weight: float = 0.5
    contrastive_type: str = "supcon"  # supcon | interuser | global
    contrastive_temperature: float = 0.07
    contrastive_margin: float = 0.5
    memory_size: int = 200
    smoothing: float = 0.1
    focal_gamma: float = 2.0
    use_mixup: bool = False
    mixup_alpha: float = 0.2
    dropout_rate: float = 0.3
    freeze_stages: Optional[int] = None
    seed: int = 0
    device: str | torch.device = "cuda"
    # data-parallel processes (parallel/mesh.py); None: one process
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r}: expected one of {MODES}")
        if self.mode == "domain_adaptive" and self.contrastive_type == "global":
            raise ValueError(
                "contrastive_type='global' (memory bank) is an improved-mode option; "
                "domain_adaptive uses supcon/interuser + its EMA prototype bank")
        if self.freeze_stages is None:
            self.freeze_stages = 3 if self.mode == "domain_adaptive" else 0
        self.device = resolve_device(self.device)
        if self.mode == "domain_adaptive":
            model = DomainAdaptiveClassifier(self.num_classes, dropout_rate=self.dropout_rate)
        else:
            improved = self.mode == "improved"
            model = ResNet18(self.num_classes, head_dim=256 if improved else 0,
                             proj_dim=64 if improved else 0)
        self.model = model.to(self.device)
        self.distributed = self.mesh is not None and self.mesh.distributed
        if self.distributed:
            if self.mesh.size(DP) != self.mesh.world:
                raise ValueError(f"the classifier is data-parallel only, got mesh {self.mesh.shape}")
            sync_batch_norms(self.model, self.mesh.group(DP))
        stem = "backbone." if self.mode == "domain_adaptive" else ""
        self.frozen_prefixes = tuple(
            [f"{stem}conv1.", f"{stem}bn1."]
            + [f"{stem}layer{s}_" for s in range(1, self.freeze_stages + 1)]) \
            if self.freeze_stages > 0 else ()

    # -- state --------------------------------------------------------------------

    @torch.no_grad()
    def init_state(self, seed: Optional[int] = None) -> ClassifierState:
        """Fresh flax-default weights (lecun-normal kernels, zero biases, unit
        batch-norm scales) drawn from ``seed``, fresh stats, optimizer and
        extras."""
        seed = self.seed if seed is None else seed
        init_flax_(self.model, torch.Generator().manual_seed(seed))
        for name, buf in self.model.named_buffers():
            buf.fill_(1.0 if name.endswith("running_var") else 0.0)
        names, params = zip(*self.model.named_parameters())
        stat_names, stats = zip(*self.model.named_buffers())
        trainable = [not n.startswith(self.frozen_prefixes) for n in names]
        extras = None
        if self.mode == "improved" and self.contrastive_type == "global":
            extras = init_memory_bank(self.num_classes, 64, self.memory_size,
                                      torch.Generator().manual_seed(seed + 1), self.device)
        elif self.mode == "domain_adaptive":
            extras = torch.zeros((self.num_classes, self.model.feature_dim), device=self.device)
        return ClassifierState(
            step=0, names=list(names), params=list(params), stat_names=list(stat_names),
            stats=list(stats), trainable=trainable,
            opt=adam_init([p for p, t in zip(params, trainable) if t]), extras=extras)

    # -- the step -----------------------------------------------------------------

    def _contrastive(self, proj, y, extras):
        if self.contrastive_type == "global":
            # the bank is updated first, the loss taken against the updated bank
            extras = update_memory_bank(extras, proj, y)
            loss = global_negative_contrastive(proj, y, extras, self.contrastive_temperature,
                                               self.contrastive_margin)
        elif self.contrastive_type == "interuser":
            loss = interuser_contrastive_loss(proj, y, self.contrastive_temperature)
        else:
            loss = supcon_loss(proj, y, self.contrastive_temperature)
        return loss, extras

    def _gather(self, t: torch.Tensor, grad: bool = False) -> torch.Tensor:
        """The global batch's ``t`` (this rank's ``t`` in one process)."""
        if not self.distributed:
            return t
        return mesh_lib.all_gather_cat(t, self.mesh.group(DP), grad=grad)

    def _rows(self, t: torch.Tensor, b: int) -> torch.Tensor:
        """This rank's ``b`` rows of a global-batch tensor."""
        if not self.distributed:
            return t
        i = self.mesh.index(DP)
        return t[i * b:(i + 1) * b]

    def _loss(self, state: ClassifierState, x, y, gen, draws: dict):
        b = x.shape[0]
        y_all = self._gather(y)
        y_soft = None
        if self.use_mixup:
            lam, perm = draws.get("mixup", (None, None))
            x_mix, y_soft = mixup(self._gather(x), y_all, self.num_classes, self.mixup_alpha,
                                  gen, lam=lam, perm=perm)
            x, y_soft = self._rows(x_mix, b), self._rows(y_soft, b)
        if self.mode == "domain_adaptive":
            masks = draws.get("dropout")
            if masks is None and self.distributed and self.model.dropout_rate > 0:
                # the draws the model takes in one process, at the global shape
                keep, n = 1.0 - self.model.dropout_rate, len(y_all)
                masks = [torch.rand((n, d), generator=gen, device=x.device) < keep
                         for d in (self.model.feature_dim, self.model.cls_fc1.out_features)]
            if masks is not None:
                masks = [self._rows(torch.as_tensor(m, device=x.device), b) for m in masks]
            logits, feat, proj = self.model(x, train=True, return_all=True, generator=gen,
                                            dropout_masks=masks)
        else:
            logits, feat, proj = self.model(x, train=True, return_all=True)
        extras = state.extras
        if y_soft is not None:
            loss = -torch.mean(torch.sum(y_soft * F.log_softmax(logits, dim=-1), dim=-1))
        elif self.mode in ("calibrated", "domain_adaptive"):
            loss = (0.5 * label_smoothing_loss(logits, y, self.smoothing)
                    + 0.5 * focal_loss(logits, y, self.focal_gamma))
        else:
            loss = F.cross_entropy(logits, y)
        if self.mode == "improved" and proj is not None:
            c_loss, extras = self._contrastive(self._gather(proj, grad=True), y_all, extras)
            loss = loss + self.supcon_weight * c_loss
        elif self.mode == "domain_adaptive":
            c_loss, _ = self._contrastive(self._gather(proj, grad=True), y_all, None)
            loss = loss + self.supcon_weight * c_loss
            extras = update_feature_bank(extras.clone(), self._gather(feat.detach()), y_all)
        acc = torch.mean((torch.argmax(logits, -1) == y).float())
        return loss, acc, extras

    def train_step(self, state: ClassifierState, batch, draws: Optional[dict] = None) -> dict:
        """One step on ``batch`` = (x NHWC in [-1, 1], y), updating ``state``
        in place (weights, batch-norm stats, moments, extras). ``draws`` may
        hold ``"mixup"``: (λ, permutation) and ``"dropout"``: the two keep
        masks of the domain-adaptive heads. Returns {"loss", "acc"}."""
        x, y = (torch.as_tensor(np.asarray(a), device=self.device) for a in batch)
        x, y = x.float(), y.long()
        gen = torch.Generator(device=self.device).manual_seed(step_seed(self.seed, state.step))
        self.model.train()
        with full_fp32():
            loss, acc, extras = self._loss(state, x, y, gen, draws or {})
            train = [p for p, t in zip(state.params, state.trainable) if t]
            grads = list(torch.autograd.grad(loss, train))
            loss = loss.detach().clone()
            if self.distributed:
                mesh_lib.all_reduce_mean_(grads + [loss, acc], self.mesh.group(DP))
            adamw_update(train, grads, state.opt, self.lr, 0.999, self.weight_decay)
        state.extras = extras
        state.step += 1
        return {"loss": loss, "acc": acc}

    @torch.no_grad()
    def logits(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x), device=self.device).float()
        self.model.eval()
        with full_fp32():
            out = self.model(x, train=False)
        return out[0] if isinstance(out, tuple) else out

    @torch.no_grad()
    def eval_step(self, state: ClassifierState, batch) -> dict:
        x, y = batch
        logits = self.logits(x)
        y = torch.as_tensor(np.asarray(y), device=self.device).long()
        probs = torch.softmax(logits, dim=-1)
        acc = torch.mean((torch.argmax(logits, -1) == y).float())
        return {"acc": acc, "ece": expected_calibration_error(probs, y)}

    def predict_fn(self, state: ClassifierState):
        """(images NHWC in [-1, 1]) → softmax probabilities (numpy): the
        filter gate."""
        return lambda x: torch.softmax(self.logits(x), dim=-1).cpu().numpy()

    def feature_fn(self, state: ClassifierState):
        """(images) → the 512-d pooled backbone features (the projected
        features in the domain-adaptive mode), numpy."""
        @torch.no_grad()
        def features(x):
            x = torch.as_tensor(np.asarray(x), device=self.device).float()
            self.model.eval()
            with full_fp32():
                return self.model(x, train=False, features=True).cpu().numpy()

        return features

    # -- the state file in the JAX tree ---------------------------------------------

    def _opt_prefix(self) -> str:
        return ("opt_state|inner_states|train|inner_state|0" if self.frozen_prefixes
                else "opt_state|0")

    def state_tensors(self, state: ClassifierState, extras: bool = True
                      ) -> tuple[dict[str, np.ndarray], list[str], list[str]]:
        """The file's tensors, its empty subtrees and its None leaves."""
        sd = dict(zip(state.names, state.params))
        sd.update(zip(state.stat_names, state.stats))
        tree = resnet_state_to_jax(sd)
        out = {"step": np.asarray(state.step, np.int32)}
        out.update(flatten(tree["params"], "params"))
        out.update(flatten(tree["batch_stats"], "batch_stats"))
        prefix = self._opt_prefix()
        out[f"{prefix}|count"] = np.asarray(state.opt.count, np.int32)
        train_names = [n for n, t in zip(state.names, state.trainable) if t]
        frozen = [n for n, t in zip(state.names, state.trainable) if not t]
        for group, tensors in (("mu", state.opt.mu), ("nu", state.opt.nu)):
            out.update(flatten(resnet_state_to_jax(dict(zip(train_names, tensors)))["params"],
                               f"{prefix}|{group}"))
        if self.frozen_prefixes:
            base = "opt_state|inner_states"
            empty = [f"{base}|freeze|inner_state", f"{base}|train|inner_state|1",
                     f"{base}|train|inner_state|2"]
            leaves = flatten(resnet_state_to_jax(
                {n: t for n, t in zip(state.names, state.params) if n in frozen})["params"])
            empty += [f"{prefix}|{g}|{k}" for g in ("mu", "nu") for k in leaves]
        else:
            empty = ["opt_state|1", "opt_state|2"]
        none = []
        if not extras or state.extras is None:
            none.append("extras")
        elif isinstance(state.extras, dict):
            out["extras|bank"] = state.extras["bank"].detach().cpu().numpy()
            out["extras|ptr"] = state.extras["ptr"].detach().cpu().numpy().astype(np.int32)
        else:
            out["extras"] = state.extras.detach().cpu().numpy()
        return out, empty, none


def save_classifier(path: str, trainer: ClassifierTrainer, state: ClassifierState,
                    extras: bool = False) -> str:
    """The state as the JAX package's ``save_state_file`` writes it (extras
    left out unless asked: the saved artifact is an inference classifier)."""
    tensors, empty, none = trainer.state_tensors(state, extras)
    write_safetensors(path, tensors, tree_metadata(empty_keys=empty, none_keys=none))
    return path


@torch.no_grad()
def restore_classifier(path: str, trainer: ClassifierTrainer, state: ClassifierState
                       ) -> ClassifierState:
    """A classifier state file (the port's or the JAX package's,
    ``.safetensors`` or ``.msgpack``) into ``state`` in place: weights,
    batch-norm stats, step, the Adam moments of the trainable parameters and
    the extras (dropped with a note when ``state`` holds none)."""
    flat = read_state_file(path)
    tree = unflatten(flat)
    sd = resnet_state_from_jax({"params": tree["params"],
                                "batch_stats": tree.get("batch_stats", {})})
    want = set(state.names) | set(state.stat_names)
    if set(sd) != want:
        raise ValueError(f"{path} does not match the classifier: "
                         f"{sorted(set(sd) ^ want)[:5]}")
    for name, t in zip(state.names + state.stat_names, state.params + state.stats):
        if sd[name].shape != t.shape:
            raise ValueError(f"{path}: {name} is {tuple(sd[name].shape)}, "
                             f"the classifier's {tuple(t.shape)}")
        t.copy_(sd[name])
    adam = find_adam(tree.get("opt_state", {}))
    if adam is not None:
        train_names = [n for n, t in zip(state.names, state.trainable) if t]
        for group, dst in (("mu", state.opt.mu), ("nu", state.opt.nu)):
            moments = resnet_state_from_jax({"params": adam[group]})
            for name, t in zip(train_names, dst):
                t.copy_(moments[name])
        state.opt.count = int(adam["count"])
    state.step = int(tree["step"])
    file_extras = tree.get("extras")
    if state.extras is None:
        if file_extras is not None:
            print(f"[restore] dropped the extras of {path} (the classifier holds none)")
    elif file_extras is not None:
        dev = trainer.device
        if isinstance(state.extras, dict):
            state.extras = {"bank": torch.as_tensor(np.array(file_extras["bank"]), device=dev),
                            "ptr": torch.as_tensor(np.array(file_extras["ptr"]), device=dev)}
        else:
            state.extras = torch.as_tensor(np.array(file_extras), device=dev)
    return state


def train_classifier(dataset, val_dataset=None, *, mode: str = "baseline",
                     contrastive_type: str = "supcon", num_classes: int = 31, epochs: int = 30,
                     batch_size: int = 64, lr: float = 1e-3, seed: int = 0, log_every: int = 50,
                     image_size: int = 224, patience: Optional[int] = None,
                     device: str | torch.device = "cuda") -> tuple:
    """Train for ``epochs`` (early stopping on validation accuracy after
    ``patience`` epochs without a gain); returns (trainer, state), the
    state of the best validation epoch when a validation set is given.
    Under a launcher the processes train data-parallel, each on its stripe
    of every epoch at ``batch_size`` a process, and validate on their
    stripes of the validation set, the counts summed."""
    device = mesh_lib.multihost_init(device)
    world = mesh_lib.process_count()
    trainer = ClassifierTrainer(num_classes=num_classes, mode=mode, lr=lr,
                                contrastive_type=contrastive_type, seed=seed, device=device,
                                mesh=mesh_lib.make_mesh() if world > 1 else None)
    # this process's stripe of every epoch (any dataset with ``batches``
    # serves a single process)
    stripe = dict(process_index=mesh_lib.process_index(), process_count=world) if world > 1 else {}
    state = trainer.init_state(seed)
    best_acc, since_best, best = 0.0, 0, None
    for epoch in range(epochs):
        t0, steps = time.time(), 0
        for batch in prefetch(dataset.batches(batch_size, seed=seed + epoch, epochs=1, **stripe)):
            metrics = trainer.train_step(state, batch)
            steps += 1
            if steps % log_every == 0:
                print(f"epoch {epoch} step {steps}: loss {metrics['loss'].item():.4f} "
                      f"acc {metrics['acc'].item():.3f} ({steps / (time.time() - t0):.1f} it/s)")
        if val_dataset is None:
            continue
        correct, total = 0, 0
        for x, y in val_dataset.batches(batch_size, shuffle=False, drop_last=False, epochs=1,
                                        **stripe):
            probs = trainer.predict_fn(state)(x)
            correct += int((probs.argmax(axis=-1) == np.asarray(y)).sum())
            total += len(y)
        correct, total = (int(v) for v in mesh_lib.process_allgather(
            np.asarray([correct, total], np.int64)).sum(axis=0))
        if total == 0:
            import warnings

            warnings.warn("validation split is empty — early stopping inert")
        acc = correct / total if total else 0.0
        if acc > best_acc:
            best_acc, since_best = acc, 0
            best = snapshot(state)  # the state early stopping selects
        else:
            since_best += 1
        print(f"epoch {epoch}: val acc {acc:.4f} (best {best_acc:.4f})")
        if patience is not None and since_best >= patience:
            print(f"early stop: no val improvement for {patience} epochs")
            break
    if best is not None:
        load_snapshot(state, best)
    return trainer, state


@torch.no_grad()
def snapshot(state: ClassifierState) -> dict:
    extras = state.extras
    if isinstance(extras, dict):
        extras = {k: v.clone() for k, v in extras.items()}
    elif extras is not None:
        extras = extras.clone()
    return {"step": state.step, "tensors": [t.clone() for t in state.params + state.stats],
            "opt": (state.opt.count, [t.clone() for t in state.opt.mu + state.opt.nu]),
            "extras": extras}


@torch.no_grad()
def load_snapshot(state: ClassifierState, snap: dict) -> None:
    torch._foreach_copy_(state.params + state.stats, snap["tensors"])
    count, moments = snap["opt"]
    torch._foreach_copy_(state.opt.mu + state.opt.nu, moments)
    state.opt.count, state.step, state.extras = count, snap["step"], snap["extras"]


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser()
    ap.add_argument("--split_file", default=None,
                    help="presplit JSON (required unless --real_dir is given)")
    ap.add_argument("--real_dir", default=None,
                    help="real data root with ID_*/User_* user dirs; deterministic per-user "
                         "80/20 split when no --split_file is given")
    ap.add_argument("--generated_dir", action="append", default=None,
                    help="generated data dir (repeatable); merged into the train split with "
                         "--use_generated")
    ap.add_argument("--use_generated", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--patience", type=int, default=None,
                    help="early-stop after N epochs without val-acc improvement")
    ap.add_argument("--mode", default="baseline", choices=list(MODES))
    ap.add_argument("--contrastive_type", default="supcon",
                    choices=["supcon", "interuser", "global"])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--num_classes", type=int, default=31)
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--out", default="classifier.safetensors")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from vavae_tpu_torch.data.image_folder import MixedDomainDataset, SplitFileDataset

    mesh_lib.multihost_init(args.device)
    if args.real_dir or args.generated_dir:
        if not args.real_dir:
            raise SystemExit("--generated_dir requires --real_dir")

        def mk(split):
            return MixedDomainDataset(real_dir=args.real_dir, generated_dirs=args.generated_dir,
                                      split=split, image_size=args.image_size,
                                      use_generated=args.use_generated,
                                      split_file=args.split_file)

        train_ds, val_ds = mk("train"), mk("val")
    elif args.split_file:
        train_ds = SplitFileDataset(args.split_file, "train", image_size=args.image_size)
        val_ds = SplitFileDataset(args.split_file, "val", image_size=args.image_size)
    else:
        raise SystemExit("one of --split_file or --real_dir is required")
    trainer, state = train_classifier(
        train_ds, val_ds, mode=args.mode, contrastive_type=args.contrastive_type,
        num_classes=args.num_classes, lr=args.lr, patience=args.patience, epochs=args.epochs,
        batch_size=args.batch_size, image_size=args.image_size, device=args.device)
    out = args.out if args.out.endswith(".safetensors") else args.out + ".safetensors"
    if mesh_lib.process_index() == 0:
        save_classifier(out, trainer, state)
        print(f"saved classifier state to {out}")
    mesh_lib.barrier()
    return trainer, state


if __name__ == "__main__":
    main()
