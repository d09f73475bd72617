"""Iterative self-training: generate → filter → re-encode → finetune, repeated
(port of ``vavae_tpu/apps/iterative_finetune.py``).

Each round samples every user with the current EMA weights, keeps the
images the classifier assigns to their user (``generate_and_filter``),
encodes them back into normalised latents, mixes them into the real latent
set (one synthetic batch after each real batch while any remain, the
synthetic set in a seeded order, the real set reshuffled with the round as
its seed) and finetunes the DiT for ``steps_per_iteration`` steps. The
sampler is built once over a copy of the DiT, whose weights are swapped for
the EMA weights each round. Runs on the card unless ``--device cpu`` is
passed. Under a launcher (``parallel/mesh.py``) the finetune is
data-parallel: ``--batch_size`` is the global batch and each process reads
its rows of every batch, real and synthetic, one process would read; every
process generates the (same) synthetic set, and process 0 writes the state.

    python -m vavae_tpu_torch.apps.iterative_finetune --config CFG.yaml \\
        --classifier_ckpt clf.safetensors ckpt_path=DIT.safetensors data.data_path=LATENTS
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from vavae_tpu_torch.apps.generate_and_filter import FilterConfig, generate_and_filter_for_user
from vavae_tpu_torch.train.dit_trainer import step_seed


@dataclasses.dataclass
class IterativeTraining:
    trainer: "DiTTrainer"          # vavae_tpu_torch.train.dit_trainer.DiTTrainer
    generate_fn_builder: Callable  # (state) -> generate_fn(generator, labels)
    decode_fn: Callable            # latents -> uint8 NHWC images
    encode_fn: Callable            # images [-1, 1] NHWC -> normalised latents
    classifier_fn: Callable        # images [-1, 1] -> softmax probabilities
    num_users: int
    iterations: int = 3
    steps_per_iteration: int = 1000
    samples_per_user: int = 100
    confidence: float = 0.9
    batch_size: int = 16
    max_batches_per_user: int = 20
    device: str | torch.device = "cuda"

    def _generate_synthetic(self, state, seed: int) -> tuple[np.ndarray, np.ndarray, int]:
        """(synthetic latents, labels, total accepted); user u samples from a
        generator seeded with ``step_seed(seed, u)``."""
        generate_fn = self.generate_fn_builder(state)
        fcfg = FilterConfig(
            confidence_threshold=self.confidence,
            target_per_user=self.samples_per_user,
            # the generation batch follows the configured batch size, capped
            # by the per-user target
            batch_size=min(self.samples_per_user, self.batch_size),
            max_batches=self.max_batches_per_user,
        )
        latents: List[np.ndarray] = []
        labels: List[int] = []
        accepted = 0
        for uid in range(self.num_users):
            gen = torch.Generator(device=self.device).manual_seed(step_seed(seed, uid))
            stats = generate_and_filter_for_user(
                uid, generate_fn, self.decode_fn, self.classifier_fn, fcfg, gen,
                return_images=True,
            )
            imgs = stats.pop("images")
            accepted += stats["accepted"]
            if len(imgs):
                x = imgs.astype(np.float32) / 127.5 - 1.0
                z = np.asarray(self.encode_fn(x))
                latents.append(z)
                labels.extend([uid] * len(z))
        if latents:
            return np.concatenate(latents), np.asarray(labels, np.int32), accepted
        return np.zeros((0,)), np.zeros((0,), np.int32), 0

    def run(self, state, real_batches_fn, seed: int = 0) -> tuple:
        """real_batches_fn(extra_latents, extra_labels, iteration) -> batch
        iterator over the real latent set augmented with the accepted
        synthetic latents; ``iteration`` keys the shuffle, so each round
        sees a different order of the real set. Updates ``state`` in place;
        returns (state, history)."""
        history: List[Dict] = []
        for it in range(self.iterations):
            it_seed = step_seed(seed, it)
            # 1) generate + filter + re-encode synthetic samples
            synth_z, synth_y, accepted = self._generate_synthetic(state, it_seed)
            history.append({"iteration": it, "accepted": accepted})

            # 2) finetune on the augmented latent set
            batches = real_batches_fn(
                synth_z if len(synth_z) else None,
                synth_y if len(synth_y) else None,
                it,
            )
            metrics = None
            for step, batch in enumerate(batches):
                if step >= self.steps_per_iteration:
                    break
                metrics = self.trainer.train_step(state, batch)
            if metrics is not None:
                history[-1]["final_loss"] = float(metrics["loss"])
        return state, history


def interleaved_batches(dataset, batch_size: int, extra_z, extra_y, iteration: int,
                        rows: tuple = (0, 1)):
    """The real set's batches (shuffled with ``iteration`` as the seed),
    each followed by one full batch of the synthetic set, in an order drawn
    from ``iteration``, while any remain. ``rows`` = (i, n): data rank i's
    rows of each of those global batches."""
    extras = None
    if extra_z is not None and len(extra_z):
        order = np.random.default_rng(iteration).permutation(len(extra_z))
        extras = (extra_z[order], extra_y[order])
    ei = 0
    i, n = rows
    b = batch_size // n
    real = (dataset.batches(batch_size, seed=iteration, rows=rows) if n > 1
            else dataset.batches(batch_size, seed=iteration))
    for lats, labels in real:
        yield lats, labels
        if extras is not None and ei < len(extras[0]):
            ez = extras[0][ei : ei + batch_size]
            ey = extras[1][ei : ei + batch_size]
            ei += len(ez)
            if len(ez) == batch_size:
                yield (ez[i * b:(i + 1) * b].astype(np.float32),
                       ey[i * b:(i + 1) * b].astype(np.int32))


def main(argv=None) -> tuple:
    """Generate → filter via the classifier → re-encode the accepted samples
    → finetune the DiT on the augmented latent set, for --iterations rounds;
    saves the finetuned train state. Returns (state, history, path)."""
    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer, restore_classifier
    from vavae_tpu_torch.data.latent_dataset import ImgLatentDataset
    from vavae_tpu_torch.models.dit import create_dit
    from vavae_tpu_torch.parallel import mesh as mesh_lib
    from vavae_tpu_torch.pipelines.sample import build_sample_fn, load_dit_params
    from vavae_tpu_torch.tokenizer import VA_VAE
    from vavae_tpu_torch.train.checkpoint import save_checkpoint
    from vavae_tpu_torch.train.dit_trainer import DiTTrainer
    from vavae_tpu_torch.transport import build_transport
    from vavae_tpu_torch.utils.config import load_config, num_real_users

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, help="DiT config (ckpt_path set)")
    ap.add_argument("--classifier_ckpt", required=True)
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--steps_per_iteration", type=int, default=1000)
    ap.add_argument("--samples_per_user", type=int, default=100)
    ap.add_argument("--confidence", type=float, default=0.9)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--out_dir", default="output/iterative")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    dev = mesh_lib.multihost_init(args.device)
    mesh = mesh_lib.make_mesh()
    world = mesh_lib.process_count()
    if args.batch_size % world:
        raise SystemExit(f"global batch {args.batch_size} must divide the process count ({world})")
    cfg = load_config(args.config, overrides=args.overrides)
    latent_size = cfg.data.image_size // cfg.get("vae", {}).get("downsample_ratio", 16)
    num_users = num_real_users(cfg)
    model = create_dit(cfg.model, latent_size, cfg.data.num_classes, device=dev)
    load_dit_params(model, cfg.ckpt_path)
    trainer = DiTTrainer(
        model, build_transport(cfg),
        lr=cfg.get("optimizer", {}).get("lr", 5e-5),
        ema_decay=cfg.train.get("ema_decay", 0.999),
        mesh=mesh,
    )
    state = trainer.init_state()  # EMA = the loaded weights

    dataset = ImgLatentDataset(
        cfg.data.data_path,
        latent_norm=cfg.data.get("latent_norm", False),
        # the DiT trainer's default (pipelines/train_dit.py)
        latent_multiplier=cfg.data.get("latent_multiplier", 0.18215),
    )
    mean, std = dataset.latent_stats  # (1, C, 1, 1)
    mean_nhwc = np.transpose(mean[0], (1, 2, 0))[None]
    std_nhwc = np.transpose(std[0], (1, 2, 0))[None]
    mult = dataset.latent_multiplier

    vae = VA_VAE(cfg.get("vae", {}).get("config"), ckpt_path=cfg.get("vae", {}).get("ckpt_path"),
                 img_size=cfg.data.image_size, device=dev)

    clf = ClassifierTrainer(num_classes=cfg.data.num_classes, device=dev)
    clf_state = restore_classifier(args.classifier_ckpt, clf, clf.init_state(0))

    # the sampler is built ONCE over a copy of the DiT; each round swaps the
    # EMA weights into the copy
    sample_model = copy.deepcopy(model).eval()
    sample_params = list(sample_model.parameters())
    base_sample = build_sample_fn(cfg, sample_model, latent_stats=(mean, std), device=dev)

    def generate_fn_builder(st):
        with torch.no_grad():
            torch._foreach_copy_(sample_params, st.ema_params)
        return lambda gen, labels: base_sample(labels, generator=gen)

    def encode_fn(images):
        z = vae.encode_images(np.asarray(images)).cpu().numpy()
        if cfg.data.get("latent_norm", False):
            z = (z - mean_nhwc) / std_nhwc
        return z * mult

    it = IterativeTraining(
        trainer=trainer,
        generate_fn_builder=generate_fn_builder,
        decode_fn=vae.decode_to_images,
        encode_fn=encode_fn,
        classifier_fn=clf.predict_fn(clf_state),
        num_users=num_users,
        iterations=args.iterations,
        steps_per_iteration=args.steps_per_iteration,
        samples_per_user=args.samples_per_user,
        confidence=args.confidence,
        batch_size=args.batch_size,
        device=dev,
    )
    rows = (mesh_lib.process_index(), world)
    state, history = it.run(
        state, lambda z, y, i: interleaved_batches(dataset, args.batch_size, z, y, i, rows))
    for h in history:
        print(h)
    path = save_checkpoint(args.out_dir, state.step, state)
    print(f"saved finetuned state to {path}")
    return state, history, path


if __name__ == "__main__":
    main()
