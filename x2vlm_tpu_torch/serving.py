"""Serving on the card (counterpart of the JAX package's
``serving.ServingBundle``, ``GroundingBundle``, ``VQABundle`` and
``CaptioningBundle``): retrieval's two encoders and ITM rerank head, the
grounding box predictor, VQA's answer ranking and the captioning beam
search.

``RetrievalServer.from_npz`` / ``GroundingServer.from_npz`` /
``VQAServer.from_npz`` load the ``params.npz`` of a retrieval / grounding /
VQA bundle (the JAX package's, or one ``export_serving.py`` wrote) through
``convert.py``; ``CaptioningServer.from_npz`` reads a captioning bundle's
directory (``params.npz`` and the search settings in ``manifest.json``).
Without a config given, the model is built from the ``config`` echo of
the bundle's ``manifest.json`` (the export's YAML: any vision tower), else
X2VLM-base. ``RetrievalServer(model)``
(and the others) serve a model built in the port. Requests run under
``torch.inference_mode`` and return tensors on the serving device.

``mesh=N`` (the JAX bundles' ``nr_devices``, ``export_serving.py
--mesh``) serves over N replicas of the model, one a device (the serving
card and the next visible ones, or N CPU replicas): each request's rows split into N
equal parts in order, each replica takes one, and the outputs are merged in
order on the serving device. As in the JAX bundles the batch sizes are
global and N must divide each request's rows.
"""

from __future__ import annotations

import copy
import json
import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from x2vlm_tpu_torch.convert import convert_jax_params, load_params_npz
from x2vlm_tpu_torch.device import resolve_device
from x2vlm_tpu_torch.factory import xvlm_config_from_yaml
from x2vlm_tpu_torch.models.captioning import XVLMForMLMCaptioning, beam_search_generate_device
from x2vlm_tpu_torch.models.generation import XVLMForVQA
from x2vlm_tpu_torch.models.grounding import XVLMForGrounding
from x2vlm_tpu_torch.models.heads import XVLMForRetrieval
from x2vlm_tpu_torch.models.xvlm import XVLMConfig

__all__ = ["RetrievalServer", "GroundingServer", "VQAServer", "CaptioningServer",
           "bundle_config"]

ArrayLike = Union[np.ndarray, torch.Tensor]


def _manifest(bundle_dir) -> dict:
    path = os.path.join(bundle_dir, "manifest.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def replica_devices(device: torch.device, n: int) -> List[torch.device]:
    """The devices of ``n`` serving replicas, ``device`` first: ``n`` CPU
    replicas for a CPU server, else ``device`` and the next visible cards."""
    if device.type == "cpu":
        return [device] * n
    others = [torch.device("cuda", i) for i in range(torch.cuda.device_count())
              if i != device.index]
    if len(others) < n - 1:
        raise ValueError(f"--mesh {n}: {torch.cuda.device_count()} CUDA devices visible")
    return [device] + others[:n - 1]


def bundle_config(bundle_dir: Union[str, os.PathLike], image_res: int) -> XVLMConfig:
    """The model config of the bundle in ``bundle_dir``: its manifest's
    ``config`` echo read as a YAML config, else X2VLM-base at
    ``image_res``."""
    echo = _manifest(bundle_dir).get("config") or {}
    return xvlm_config_from_yaml(echo) if echo else XVLMConfig.base(image_res=image_res)


class _Server:
    """A model in eval mode on its device, with ``mesh`` replicas (module
    doc); ``from_npz`` builds ``MODEL`` from a JAX bundle's parameters."""

    MODEL = XVLMForRetrieval
    IMAGE_RES = 224   # the default config's resolution

    def __init__(self, model, mesh: int = 1):
        self.model = model.eval()
        self.device = model.device
        devices = replica_devices(self.device, mesh)
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d) for d in devices[1:]]

    @classmethod
    def from_npz(cls, path: Union[str, os.PathLike],
                 config: Optional[XVLMConfig] = None, *,
                 dtype: torch.dtype = torch.bfloat16, device=None, mesh: Optional[int] = None):
        """Serve the JAX parameters in ``path`` (a bundle's ``params.npz``)
        with ``config`` (default: :func:`bundle_config` of its directory, at
        ``IMAGE_RES`` without an echo) over ``mesh`` replicas (default: the
        manifest's ``nr_devices``)."""
        device = resolve_device(device)
        bundle_dir = os.path.dirname(os.path.abspath(path))
        state, _ = convert_jax_params(load_params_npz(path), device=device)
        config = config or bundle_config(bundle_dir, cls.IMAGE_RES)
        model = cls.MODEL(config, dtype=dtype, device=device, seed=None,
                          **cls._model_kwargs(state))
        model.load_state_dict(state)
        return cls(model, mesh=mesh or int(_manifest(bundle_dir).get("nr_devices", 1)))

    @staticmethod
    def _model_kwargs(state) -> dict:
        """``MODEL``'s arguments that the parameters decide."""
        return {}

    def _in(self, x: ArrayLike) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def _split(self, call, rows: Sequence[ArrayLike], shared: Sequence[ArrayLike] = ()):
        """``call(model, *rows_part, *shared)`` on each replica with its
        part of ``rows``, the outputs (a tensor, a tuple of tensors or a
        list) merged in order on the serving device."""
        n = len(self.replicas)
        if n == 1:
            return call(self.model, *map(self._in, rows), *map(self._in, shared))
        total = torch.as_tensor(rows[0]).shape[0]
        if total % n:
            raise ValueError(f"a request of {total} rows does not split over {n} devices")
        step = total // n
        outs = []
        for i, m in enumerate(self.replicas):
            dev = m.device
            outs.append(call(m, *(torch.as_tensor(r)[i * step:(i + 1) * step].to(dev)
                                  for r in rows),
                             *(torch.as_tensor(x).to(dev) for x in shared)))
        if isinstance(outs[0], list):
            return [x for o in outs for x in o]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[j].to(self.device) for o in outs])
                         for j in range(len(outs[0])))
        return torch.cat([o.to(self.device) for o in outs])


class RetrievalServer(_Server):
    @torch.inference_mode()
    def encode_images(self, images: ArrayLike):
        """NHWC float or uint8 images -> (embeds, feat)."""
        return self._split(lambda m, x: m.encode_images(x), [images])

    @torch.inference_mode()
    def encode_texts(self, ids: ArrayLike, atts: ArrayLike):
        """(B, L) token ids and attention mask -> (embeds, feat)."""
        return self._split(lambda m, i, a: m.encode_texts(i, a), [ids, atts])

    @torch.inference_mode()
    def itm_score(self, image_embeds: ArrayLike, text_embeds: ArrayLike,
                  text_atts: ArrayLike) -> torch.Tensor:
        """(N,) ITM match logits of the candidate pairs, fp32."""
        return self._split(lambda m, e, t, a: m.itm_score(e, t, a),
                           [image_embeds, text_embeds, text_atts])


class GroundingServer(_Server):
    """Image + referring expression -> box (reference model_grounding.py),
    at 384 px by default, the shipped grounding config's resolution."""

    MODEL = XVLMForGrounding
    IMAGE_RES = 384

    @torch.inference_mode()
    def predict(self, image: ArrayLike, text_ids: ArrayLike, text_atts: ArrayLike
                ) -> torch.Tensor:
        """NHWC images, (B, L) token ids and attention mask -> (B, 4) boxes,
        cxcywh normalised to [0, 1], fp32."""
        return self._split(lambda m, x, i, a: m.predict(x, i, a), [image, text_ids, text_atts])


class VQAServer(_Server):
    """Image + question -> the answer list ranked (reference VQA.py's
    protocol), at 768 px by default, the shipped VQAv2 config's resolution.
    The decoder's depth is read from the parameters."""

    MODEL = XVLMForVQA
    IMAGE_RES = 768

    @staticmethod
    def _model_kwargs(state) -> dict:
        layers = {k.split(".")[4] for k in state
                  if k.startswith("text_decoder.bert.encoder.layer.")}
        return {"num_dec_layers": len(layers)}

    @torch.inference_mode()
    def rank(self, image: ArrayLike, q_ids: ArrayLike, q_atts: ArrayLike,
             answer_ids: ArrayLike, answer_atts: ArrayLike, k_test: int = 128):
        """NHWC images, (B, L) question ids and mask, the tokenised answer
        list (A, La) -> (answer indices (B, k), scores (B, k)), k =
        min(k_test, A); column 0 is each question's prediction."""
        k = min(k_test, torch.as_tensor(answer_ids).shape[0])

        def call(m, image, q_ids, q_atts, answer_ids, answer_atts):
            return m.predict({"image": image, "question_ids": q_ids.long(),
                              "question_atts": q_atts, "answer_ids": answer_ids.long(),
                              "answer_atts": answer_atts}, k)

        return self._split(call, [image, q_ids, q_atts], [answer_ids, answer_atts])


class CaptioningServer(_Server):
    """Image -> caption token ids by the beam search on the card (the JAX
    ``CaptioningBundle``: the search's settings are the bundle's manifest,
    the length penalty a knob of each request), at 384 px by default, the
    shipped COCO config's resolution."""

    MODEL = XVLMForMLMCaptioning
    IMAGE_RES = 384

    def __init__(self, model, manifest: Optional[dict] = None, mesh: int = 1):
        super().__init__(model, mesh=mesh)
        self.manifest = dict(manifest or {})

    @classmethod
    def from_npz(cls, bundle_dir: Union[str, os.PathLike],
                 config: Optional[XVLMConfig] = None, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 mesh: Optional[int] = None) -> "CaptioningServer":
        """Serve the bundle in ``bundle_dir`` (``params.npz``, and
        ``manifest.json``: prompt ids, [MASK] / EOS ids, beams, min / max
        length, image resolution) with ``config`` (default: the manifest's
        echo, else X2VLM-base at its resolution)."""
        with open(os.path.join(bundle_dir, "manifest.json")) as f:
            manifest = json.load(f)
        server = super().from_npz(os.path.join(bundle_dir, "params.npz"),
                                  config or bundle_config(bundle_dir, manifest["image_res"]),
                                  dtype=dtype, device=device, mesh=mesh)
        server.manifest = manifest
        return server

    def generate(self, images: ArrayLike, length_penalty: float = 0.0) -> List[List[int]]:
        """NHWC images -> each image's best token ids (without the prompt or
        the EOS; the caller detokenizes)."""
        m = self.manifest
        return self._split(lambda model, x: beam_search_generate_device(
            model, x, m["prompt_ids"], mask_token_id=m["mask_token_id"],
            eos_token_id=m["eos_token_id"], num_beams=m["num_beams"],
            min_length=m["min_length"], max_length=m["max_length"],
            length_penalty=length_penalty), [images])
