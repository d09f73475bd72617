"""VA_VAE / MAR_VAE tokenizer facades (port of ``vavae_tpu/tokenizer.py``).

Images and latents are NHWC, as in the JAX package. Checkpoints: a reference
torch ``.pt``/``.ckpt`` state dict (the port's module names are the
reference's) or a JAX-package ``.safetensors`` param tree, through the
weight bridge. The JAX facade's batch padding and mesh sharding have no
counterpart on one card.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from vavae_tpu_torch.models.vae import AutoencoderKL, DiagonalGaussian, vae_from_ddconfig
from vavae_tpu_torch.utils.device import resolve_device


@torch.no_grad()
def init_vae_weights(model: AutoencoderKL, generator: torch.Generator) -> None:
    """The JAX package's fresh init: lecun-normal conv kernels, zero bias,
    unit GroupNorm scale."""
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            torch.nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                        generator=generator)
            torch.nn.init.zeros_(m.bias)
        elif isinstance(m, torch.nn.GroupNorm):
            torch.nn.init.ones_(m.weight)
            torch.nn.init.zeros_(m.bias)


class VA_VAE:
    """Vision-foundation-model-aligned VAE (f16d32 by default)."""

    model_type = "vavae"

    def __init__(
        self,
        config: Optional[str] = None,
        *,
        embed_dim: int = 32,
        ckpt_path: Optional[str] = None,
        img_size: int = 256,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        ddconfig = None
        if config is not None:
            import yaml

            with open(config) as f:
                cfg = yaml.safe_load(f)
            embed_dim = cfg["model"]["params"]["embed_dim"]
            # the config wins only when it names a checkpoint
            ckpt_path = cfg.get("ckpt_path") or ckpt_path
            ddconfig = cfg["model"]["params"].get("ddconfig")
        self.embed_dim = embed_dim
        self.img_size = img_size
        if ddconfig is not None:
            self.model = vae_from_ddconfig(
                embed_dim, {**ddconfig, "resolution": img_size}, model_type=self.model_type
            )
            self.downsample = 2 ** (len(ddconfig.get("ch_mult", (1, 1, 2, 2, 4))) - 1)
        else:
            self.model = AutoencoderKL(embed_dim=embed_dim, ch_mult=(1, 1, 2, 2, 4),
                                       resolution=img_size, model_type=self.model_type)
            self.downsample = 16
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._load_weights(ckpt_path, seed)
        self.model.to(self.device).eval()

    def _load_weights(self, ckpt_path: Optional[str], seed: int) -> None:
        if ckpt_path is None:
            init_vae_weights(self.model, torch.Generator().manual_seed(seed))
            return
        if not os.path.exists(str(ckpt_path)):
            raise FileNotFoundError(
                f"VAE checkpoint {ckpt_path!r} does not exist (pass "
                "ckpt_path=None explicitly for fresh random weights)"
            )
        if str(ckpt_path).endswith(".safetensors"):
            from vavae_tpu_torch.utils.safetensors_io import load_tree
            from vavae_tpu_torch.utils.weights import vae_state_from_jax

            sd = vae_state_from_jax(load_tree(str(ckpt_path)))
        else:  # reference torch checkpoint
            sd = torch.load(str(ckpt_path), map_location="cpu", weights_only=False)
            sd = sd.get("state_dict", sd)
            sd = {
                k: v for k, v in sd.items()
                if torch.is_tensor(v)
                and not k.startswith(("loss.", "foundation_model.", "linear_proj"))
            }
        self.model.load_state_dict(sd, strict=True)

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def encode_images(self, images, generator: torch.Generator | None = None) -> torch.Tensor:
        """images: (B, H, W, 3) in [-1, 1] → sampled latents (B, h, w, C)."""
        post = self.model.encode(self._input(images))
        return post.sample(generator if generator is not None else self._generator)

    @torch.no_grad()
    def encode_moments(self, images) -> DiagonalGaussian:
        return self.model.encode(self._input(images))

    @torch.no_grad()
    def decode(self, z) -> torch.Tensor:
        return self.model.decode(self._input(z))

    def decode_to_images(self, z) -> np.ndarray:
        """latents → (B, H, W, 3) uint8 numpy (clamp(127.5·x + 128))."""
        dec = self.decode(z).float()
        return torch.clamp(127.5 * dec + 128.0, 0, 255).to(torch.uint8).cpu().numpy()


class MAR_VAE(VA_VAE):
    """MAR's f16d16 VAE (no decoder attention)."""

    model_type = "marvae"

    def __init__(self, ckpt_path: Optional[str] = None, img_size: int = 256, **kw):
        super().__init__(None, embed_dim=16, ckpt_path=ckpt_path, img_size=img_size, **kw)
