"""SimplifiedVAVAE: the scale-factor facade over ``VA_VAE`` for conditional
diffusion on micro-Doppler data (port of
``vavae_tpu/apps/simplified_vavae.py``).

``scale_factor`` comes from the argument, else from a reference
``.pt``/``.ckpt`` (its top-level ``scale_factor`` or its state dict's),
else 1.0. ``encode`` multiplies the latents by it; ``decode`` divides,
then maps the reconstruction to [0, 1]. Runs on the card unless
``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vavae_tpu_torch.tokenizer import VA_VAE


class SimplifiedVAVAE:
    def __init__(self, ckpt_path: Optional[str] = None, config: Optional[str] = None,
                 img_size: int = 256, scale_factor: Optional[float] = None,
                 device: str | torch.device = "cuda"):
        self.vae = VA_VAE(config, ckpt_path=ckpt_path, img_size=img_size, device=device)
        self.scale_factor = float(scale_factor if scale_factor is not None
                                  else self._scale_from_ckpt(ckpt_path))

    @staticmethod
    def _scale_from_ckpt(ckpt_path: Optional[str]) -> float:
        if not (ckpt_path and str(ckpt_path).endswith((".pt", ".ckpt"))):
            return 1.0
        sd = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        if isinstance(sd, dict):
            if "scale_factor" in sd:
                return float(sd["scale_factor"])
            state = sd.get("state_dict", {})
            if "scale_factor" in state:
                return float(np.asarray(state["scale_factor"]))
        return 1.0

    def encode(self, images, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images NHWC in [-1, 1] → sampled latents × scale_factor."""
        return self.vae.encode_images(images, generator) * self.scale_factor

    def decode(self, z) -> torch.Tensor:
        """latents → reconstruction mapped to [0, 1]."""
        dec = self.vae.decode(torch.as_tensor(z, device=self.vae.device) / self.scale_factor)
        return torch.clamp((dec.float() + 1.0) / 2.0, 0.0, 1.0)

    def decode_to_images(self, z) -> np.ndarray:
        return torch.clamp(self.decode(z) * 255.0, 0, 255).to(torch.uint8).cpu().numpy()
