"""Retrieval serving on the card (counterpart of the JAX package's
``serving.ServingBundle``): the two encoders and the ITM rerank head.

``RetrievalServer.from_npz`` loads the ``params.npz`` of a JAX retrieval
bundle through ``convert.py``; ``RetrievalServer(model)`` serves a model
built in the port. Requests run under ``torch.inference_mode`` and return
tensors on the serving device.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from x2vlm_tpu_torch.convert import convert_jax_params, load_params_npz
from x2vlm_tpu_torch.device import resolve_device
from x2vlm_tpu_torch.models.heads import XVLMForRetrieval
from x2vlm_tpu_torch.models.xvlm import XVLMConfig

__all__ = ["RetrievalServer"]

ArrayLike = Union[np.ndarray, torch.Tensor]


class RetrievalServer:
    def __init__(self, model: XVLMForRetrieval):
        self.model = model.eval()
        self.device = model.vision_encoder.cls_token.device

    @classmethod
    def from_npz(cls, path: Union[str, os.PathLike],
                 config: Optional[XVLMConfig] = None, *,
                 dtype: torch.dtype = torch.bfloat16, device=None) -> "RetrievalServer":
        """Serve the JAX parameters in ``path`` (a retrieval bundle's
        ``params.npz``) with ``config`` (X2VLM-base by default)."""
        device = resolve_device(device)
        state, _ = convert_jax_params(load_params_npz(path), device=device)
        model = XVLMForRetrieval(config or XVLMConfig.base(), dtype=dtype,
                                 device=device, seed=None)
        model.load_state_dict(state)
        return cls(model)

    def _in(self, x: ArrayLike) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    @torch.inference_mode()
    def encode_images(self, images: ArrayLike):
        """NHWC float or uint8 images -> (embeds, feat)."""
        return self.model.encode_images(self._in(images))

    @torch.inference_mode()
    def encode_texts(self, ids: ArrayLike, atts: ArrayLike):
        """(B, L) token ids and attention mask -> (embeds, feat)."""
        return self.model.encode_texts(self._in(ids), self._in(atts))

    @torch.inference_mode()
    def itm_score(self, image_embeds: ArrayLike, text_embeds: ArrayLike,
                  text_atts: ArrayLike) -> torch.Tensor:
        """(N,) ITM match logits of the candidate pairs, fp32."""
        return self.model.itm_score(self._in(image_embeds), self._in(text_embeds),
                                    self._in(text_atts))
