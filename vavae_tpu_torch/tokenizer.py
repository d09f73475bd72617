"""VA_VAE / MAR_VAE tokenizer facades (port of ``vavae_tpu/tokenizer.py``).

Images and latents are NHWC, as in the JAX package. Checkpoints: a reference
torch ``.pt``/``.ckpt`` state dict (the port's module names are the
reference's) or a JAX-package ``.safetensors`` param tree, through the
weight bridge. The JAX facade's batch padding and mesh sharding have no
counterpart on one card.

``dtype=torch.bfloat16`` runs the VAE in bf16 (the module is cast; the
attention logits stay fp32 and the posterior's moments leave in fp32), as
the JAX facade's ``dtype=jnp.bfloat16``. At fp32 the encode pins TF32
off. The ADM crop takes decoded uint8 arrays where the JAX package
takes PIL images, and resizes with ``utils/pil_resize.py``, PIL's own
fixed-point rule, so both feed the VAE the same pixels.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import numpy as np
import torch

from vavae_tpu_torch.models.vae import AutoencoderKL, DiagonalGaussian, vae_from_ddconfig
from vavae_tpu_torch.utils.device import full_fp32, resolve_device
from vavae_tpu_torch.utils.pil_resize import resize_uint8
from vavae_tpu_torch.utils.weights import lecun_normal_


def center_crop_arr(img: np.ndarray, image_size: int) -> np.ndarray:
    """ADM center crop of an (H, W, 3) uint8 image: BOX halving while the
    short side is at least twice the target, BICUBIC to the target on the
    short side, center crop. Returns (S, S, 3) uint8."""
    while min(img.shape[:2]) >= 2 * image_size:
        img = resize_uint8(img, (img.shape[1] // 2, img.shape[0] // 2), "box")
    scale = image_size / min(img.shape[:2])
    img = resize_uint8(img, (round(img.shape[1] * scale), round(img.shape[0] * scale)), "bicubic")
    cy = (img.shape[0] - image_size) // 2
    cx = (img.shape[1] - image_size) // 2
    return img[cy:cy + image_size, cx:cx + image_size]


def preprocess_images(images, image_size: int, hflip: bool = False) -> np.ndarray:
    """(H, W, 3) uint8 images (as ``read_image_rgb`` gives them) → (B, S, S,
    3) float32 in [-1, 1], optionally flipped horizontally."""
    x = np.stack([center_crop_arr(im, image_size) for im in images]).astype(np.float32) / 255.0
    if hflip:
        x = x[:, :, ::-1, :]
    return (x - 0.5) / 0.5


@torch.no_grad()
def init_vae_weights(model: AutoencoderKL, generator: torch.Generator) -> None:
    """The JAX package's fresh init: lecun-normal conv kernels, zero bias,
    unit GroupNorm scale."""
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            lecun_normal_(m.weight, generator)
            torch.nn.init.zeros_(m.bias)
        elif isinstance(m, torch.nn.GroupNorm):
            torch.nn.init.ones_(m.weight)
            torch.nn.init.zeros_(m.bias)


def reference_vae_state(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a reference torch ``.pt``/``.ckpt`` (its
    ``state_dict``) without the loss's and the foundation model's: the
    AutoencoderKL's under the port's names, and the reverse projector
    ``linear_proj.weight`` where the run trained one."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    sd = sd.get("state_dict", sd)
    return {k: v for k, v in sd.items()
            if torch.is_tensor(v) and not k.startswith(("loss.", "foundation_model."))}


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
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.device = resolve_device(device)
        self.dtype = dtype
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
        self.model.to(self.device, dtype).eval()

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
        else:
            sd = {k: v for k, v in reference_vae_state(str(ckpt_path)).items()
                  if not k.startswith("linear_proj")}
        self.model.load_state_dict(sd, strict=True)

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, self.dtype)

    @torch.no_grad()
    def encode_images(self, images, generator: torch.Generator | None = None) -> torch.Tensor:
        """images: (B, H, W, 3) in [-1, 1] → sampled latents (B, h, w, C), fp32."""
        post = self.encode_moments(images)
        return post.sample(generator if generator is not None else self._generator)

    @torch.no_grad()
    def encode_moments(self, images) -> DiagonalGaussian:
        """The posterior, its moments fp32; an fp32 VAE encodes with TF32
        off, so the latents a DiT trains on are the fp32 encoder's."""
        pin = full_fp32() if self.dtype == torch.float32 else contextlib.nullcontext()
        with pin:
            return self.model.encode(self._input(images))

    @torch.no_grad()
    def decode(self, z) -> torch.Tensor:
        """latents (B, h, w, C) → images (B, H, W, 3) in the VAE's dtype."""
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
