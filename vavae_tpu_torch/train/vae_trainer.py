"""VA-VAE training on one device (port of ``vavae_tpu/train/vae_trainer.py``):
the two-optimizer (autoencoder + discriminator) GAN step with the adaptive
GAN and VF weights.

One ``train_step``:
  - one forward of the VAE (the posterior sampled with the step's noise),
    LPIPS, the discriminator in train mode on the reconstruction (its batch
    norm's running stats take the step's first update) and the VF loss of
    the 1×1 reverse projection of z against the frozen foundation features;
  - the adaptive weights from ``torch.autograd.grad`` of nll and g against
    ``decoder.conv_out.weight`` and of nll and vf against
    ``encoder.conv_out.weight`` on that one graph (``retain_graph``), as the
    reference's ``calculate_adaptive_weight``; the JAX step pulls one
    ``jax.vjp`` back three times. Frobenius norms do not see the layout;
  - the total loss's gradient with respect to the generator's parameters
    only (no gradient reaches the discriminator), Adam(b1 0.5, b2 0.9);
  - the discriminator on the real batch and the detached reconstruction
    (pre-step weights; its running stats chain fake → real → fake) under
    the ``disc_start`` gate, Adam(b1 0.5, b2 0.9).

The state is updated in place (the parameters are the modules' own). The
VAE, the discriminator, the losses and both optimizers are fp32, and fp32
means fp32 on the card too: ``train_step``, ``eval_step`` and
``reconstruct`` run under ``full_fp32()`` (TF32 off in cuDNN and cuBLAS,
whatever the caller set). ``compute_dtype=torch.bfloat16`` runs the VAE's
encode and decode under ``torch.autocast`` (fp32 parameters, GroupNorm
statistics, attention logits and losses). ``frozen_bf16`` (on by default,
as in JAX) casts the frozen nets, the foundation model and LPIPS, to bf16
in place: their inputs go in as bf16, their outputs come back as fp32.

Randomness: the posterior noise of step s comes from a ``torch.Generator``
seeded from ``(seed, s)``, so a resumed run draws what an unbroken one
would; ``train_step(..., noise=)`` takes it from the caller instead (JAX's
``jax.random`` stream cannot be replayed in torch).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from vavae_tpu_torch.models.discriminator import (
    NLayerDiscriminator,
    hinge_d_loss,
    init_discriminator_weights,
    vanilla_d_loss,
)
from vavae_tpu_torch.models.vae import AutoencoderKL
from vavae_tpu_torch.tokenizer import init_vae_weights
from vavae_tpu_torch.train.dit_trainer import AdamState, adam_init, adamw_update, step_seed
from vavae_tpu_torch.train.vae_loss import (
    VAELossConfig,
    adaptive_weight,
    adopt_weight,
    nll_loss,
    vf_loss,
)
from vavae_tpu_torch.utils.device import full_fp32
from vavae_tpu_torch.utils.weights import lecun_normal_

B1, B2 = 0.5, 0.9  # configure_optimizers' betas, both optimizers


@dataclasses.dataclass
class VAETrainState:
    step: int
    gen_names: list[str]          # "vae.…" and, with VF, "proj.weight"
    gen_params: list[torch.Tensor]
    disc_names: list[str]
    disc_params: list[torch.Tensor]
    stat_names: list[str]         # the discriminator's "bn{n}.running_mean/var"
    disc_stats: list[torch.Tensor]
    gen_opt: AdamState
    disc_opt: AdamState


def _norm(t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(t.float())


@dataclasses.dataclass
class VAETrainer:
    vae: AutoencoderKL
    loss_cfg: VAELossConfig = dataclasses.field(default_factory=VAELossConfig)
    lr: float = 1e-4
    use_vf: bool = True
    vf_dim: int = 1024  # the foundation model's feature width (ViT-L: 1024)
    # frozen nets: foundation(images NHWC) -> (B, h, w, vf_dim); lpips(a, b) -> (B,)
    foundation: Optional[nn.Module] = None
    lpips: Optional[nn.Module] = None
    disc_layers: int = 3
    frozen_bf16: bool = True
    compute_dtype: torch.dtype = torch.float32
    seed: int = 0  # the posterior noise's stream

    def __post_init__(self):
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {self.compute_dtype}")
        self.device = next(self.vae.parameters()).device
        self.gen = nn.Module()
        self.gen.vae = self.vae
        if self.use_vf:  # reverse projection z -> vf_dim (autoencoder.py:322-324)
            embed_dim = self.vae.post_quant_conv.in_channels
            self.gen.proj = nn.Conv2d(embed_dim, self.vf_dim, 1, bias=False).to(self.device)
        self.disc = NLayerDiscriminator(n_layers=self.disc_layers).to(self.device)
        for net in (self.foundation, self.lpips):
            if net is not None:
                net.requires_grad_(False).eval()
                if self.frozen_bf16:
                    net.to(torch.bfloat16)

    # -- state -----------------------------------------------------------------

    def init_state(self, seed: int = 0) -> VAETrainState:
        """Fresh weights from ``seed`` (the JAX init's rules: lecun-normal
        VAE and projector kernels, taming's discriminator init), step 0,
        fresh optimizers."""
        gen = torch.Generator().manual_seed(seed)
        init_vae_weights(self.vae, gen)
        if self.use_vf:
            lecun_normal_(self.gen.proj.weight, gen)
        init_discriminator_weights(self.disc, gen)
        return self.fresh_state()

    def fresh_state(self) -> VAETrainState:
        """A state over the modules' current weights with fresh optimizers."""
        gen_names, gen_params = zip(*self.gen.named_parameters())
        disc_names, disc_params = zip(*self.disc.named_parameters())
        stat_names, stats = zip(*self.disc.named_buffers())
        return VAETrainState(
            step=0, gen_names=list(gen_names), gen_params=list(gen_params),
            disc_names=list(disc_names), disc_params=list(disc_params),
            stat_names=list(stat_names), disc_stats=list(stats),
            gen_opt=adam_init(list(gen_params)), disc_opt=adam_init(list(disc_params)),
        )

    # -- pieces ------------------------------------------------------------------

    def _autocast(self):
        if self.compute_dtype == torch.bfloat16:
            return torch.autocast(self.device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def _frozen(self, net: nn.Module, *xs: torch.Tensor) -> torch.Tensor:
        if self.frozen_bf16:
            return net(*(x.to(torch.bfloat16) for x in xs)).float()
        return net(*xs)

    def _noise_shape(self, x: torch.Tensor) -> tuple[int, ...]:
        down = 2 ** (len(self.vae.encoder.down) - 1)
        return (x.shape[0], x.shape[1] // down, x.shape[2] // down,
                self.vae.post_quant_conv.in_channels)

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(images).to(self.device, torch.float32)

    # -- steps -------------------------------------------------------------------

    @full_fp32()
    def train_step(self, state: VAETrainState, images, *, noise=None) -> dict:
        """One step on ``images`` (B, H, W, 3) in [-1, 1], updating
        ``state`` in place. Returns the metrics as detached tensors."""
        cfg = self.loss_cfg
        x = self._images(images)
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(step_seed(self.seed, state.step))
            noise = torch.randn(self._noise_shape(x), generator=gen, device=self.device)
        noise = (noise if torch.is_tensor(noise) else torch.from_numpy(np.array(noise))).to(
            self.device, torch.float32)
        with torch.no_grad():
            aux = (self._frozen(self.foundation, x)
                   if self.use_vf and self.foundation is not None else None)

        # -- generator: one forward -------------------------------------------------
        with self._autocast():
            posterior = self.vae.encode(x)
            z = posterior.mean + posterior.std * noise
            dec = self.vae.decode(z).float()
        p_loss = self._frozen(self.lpips, x, dec) if self.lpips is not None else None
        nll, rec_mean = nll_loss(x, dec, p_loss, cfg)
        kl = torch.mean(posterior.kl())
        logits_fake = self.disc(dec, train=True)
        g_loss = -torch.mean(logits_fake)
        zero = torch.zeros((), device=self.device)
        vf_on = self.use_vf and aux is not None
        if vf_on:
            z_proj = self.gen.proj(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            vf, vf_dm, vf_cos = vf_loss(z_proj, aux, cfg)
        else:
            vf, vf_dm, vf_cos = zero, zero, zero

        # -- adaptive weights on the same graph ---------------------------------------
        enc_w = self.vae.encoder.conv_out.weight
        dec_w = self.vae.decoder.conv_out.weight
        want_d = cfg.disc_factor > 0.0
        want_vf = self.use_vf and cfg.adaptive_vf
        targets = ([dec_w] if want_d else []) + ([enc_w] if want_vf else [])
        g_nll = list(torch.autograd.grad(nll, targets, retain_graph=True)) if targets else []
        if want_d:
            (g_g_dec,) = torch.autograd.grad(g_loss, dec_w, retain_graph=True)
            d_weight = adaptive_weight(_norm(g_nll.pop(0)), _norm(g_g_dec), cfg.disc_weight, 1e4)
        else:
            d_weight = zero
        if want_vf:
            g_vf = (torch.autograd.grad(vf, enc_w, retain_graph=True)[0] if vf_on
                    else torch.zeros_like(enc_w))
            vf_weight = adaptive_weight(_norm(g_nll.pop(0)), _norm(g_vf), cfg.vf_weight, 1e8)
        else:
            vf_weight = torch.full((), cfg.vf_weight if self.use_vf else 0.0, device=self.device)
        disc_factor = adopt_weight(cfg.disc_factor, state.step, cfg.disc_start)

        total = nll + cfg.kl_weight * kl + d_weight * disc_factor * g_loss + vf_weight * vf
        grads = torch.autograd.grad(total, state.gen_params, allow_unused=True,
                                    materialize_grads=True)
        adamw_update(state.gen_params, list(grads), state.gen_opt, self.lr, B2, b1=B1)

        # -- discriminator: pre-step weights, detached reconstruction -------------------
        dec = dec.detach()
        logits_real = self.disc(x, train=True)
        logits_fake_d = self.disc(dec, train=True)
        d_loss_fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
        disc_loss = disc_factor * d_loss_fn(logits_real, logits_fake_d)
        disc_grads = torch.autograd.grad(disc_loss, state.disc_params)
        adamw_update(state.disc_params, list(disc_grads), state.disc_opt, self.lr, B2, b1=B1)
        state.step += 1

        return {k: v.detach() for k, v in {
            "rec_loss": rec_mean, "kl_loss": kl, "g_loss": g_loss, "vf_loss": vf,
            "vf_distmat": vf_dm, "vf_cos": vf_cos, "total_loss": total, "nll_loss": nll,
            "d_weight": d_weight, "vf_weight": vf_weight,
            "disc_factor": torch.full((), disc_factor, device=self.device),
            "disc_loss": disc_loss, "logits_real": logits_real.mean(),
            "logits_fake": logits_fake_d.mean(),
        }.items()}

    @torch.no_grad()
    @full_fp32()
    def reconstruct(self, state: VAETrainState, images) -> torch.Tensor:
        """Deterministic reconstructions (posterior mean → decode), fp32, for
        the image grids."""
        with self._autocast():
            return self.vae.decode(self.vae.encode(self._images(images)).mean).float()

    @torch.no_grad()
    @full_fp32()
    def eval_step(self, state: VAETrainState, images) -> dict:
        """Validation metrics on the posterior mean (rec_loss selects the
        best checkpoint)."""
        x = self._images(images)
        with self._autocast():
            posterior = self.vae.encode(x)
            dec = self.vae.decode(posterior.mean).float()
        return {"val/rec_loss": torch.mean(torch.abs(x - dec)),
                "val/kl_loss": torch.mean(posterior.kl())}
