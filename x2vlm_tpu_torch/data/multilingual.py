"""Multilingual pretraining streams (the port's counterpart of
x2vlm_tpu/data/multilingual.py; reference
dataset/pretrain_dataset_multilingual.py, the CCLM data):

- ``ImageMultiTextStream``: captions keyed by language code; one of the
  configured languages the line has is drawn per sample (reference
  :174-203);
- ``RegionMultiTextStream``: the region stream with one language per image,
  or with ``code_switch`` a language per caption (reference :288, :394);
- ``ParaTextStream``: parallel text pairs, their direction swapped with
  probability ``swap_prob`` (reference :500-668).

Each draws from the stream's ``rng`` in the JAX package's order, so a
seeded stream gives the JAX one's samples bit for bit.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from x2vlm_tpu_torch.data.pretrain import ImageTextStream, RegionTextStream, _StreamBase

__all__ = ["ImageMultiTextStream", "RegionMultiTextStream", "ParaTextStream",
           "choose_language"]


def choose_language(caption_dict: Dict[str, str], languages: Sequence[str], rng) -> str:
    """The caption of a language drawn from those of ``languages`` the dict
    has (non-empty)."""
    avail = [lang for lang in languages if lang in caption_dict and caption_dict[lang]]
    if not avail:
        raise ValueError("no caption in requested languages")
    return caption_dict[rng.choice(avail)]


class ImageMultiTextStream(ImageTextStream):
    """The image-text stream over ``{language: caption}`` captions."""

    def __init__(self, reader, text_pre, transform, languages: Sequence[str],
                 image_key: str = "binary", caption_key: str = "caption",
                 is_image_rpath: bool = False, rng=None, max_consecutive_broken: int = 128):
        super().__init__(reader, text_pre, transform, image_key=image_key,
                         caption_key=caption_key, is_image_rpath=is_image_rpath, rng=rng,
                         max_consecutive_broken=max_consecutive_broken)
        self.languages = list(languages)

    def _text_sample(self, ann: dict, image: np.ndarray) -> Dict:
        caption = choose_language(ann[self.caption_key], self.languages, self.rng)
        ids, atts, ids_m, pos, labels = self.text_pre(caption, with_masking=True)
        return {"image": image, "text_ids": ids, "text_atts": atts, "text_ids_masked": ids_m,
                "masked_pos": pos, "masked_ids": labels}


class RegionMultiTextStream(RegionTextStream):
    """The region stream over ``{language: caption}`` captions: one
    language for the whole image (drawn from those every region has), or
    with ``code_switch`` a language drawn for each caption."""

    def __init__(self, *args, languages: Sequence[str] = ("en",), code_switch: bool = True,
                 **kw):
        super().__init__(*args, **kw)
        self.languages = list(languages)
        self.code_switch = code_switch
        self._fixed_language: Optional[str] = None

    def _sample(self, ann: dict) -> Dict:
        if not self.code_switch:
            avail = None
            for e in ann.get("elems", []):
                if isinstance(e.get("caption"), dict):
                    langs = [lang for lang in self.languages if lang in e["caption"]]
                    avail = langs if avail is None else [lang for lang in avail
                                                         if lang in langs]
            self._fixed_language = self.rng.choice(avail) if avail else None
        else:
            self._fixed_language = None
        try:
            return super()._sample(self._localized(ann))
        finally:
            self._fixed_language = None

    def _localized(self, ann: dict) -> dict:
        def localize(caption):
            if isinstance(caption, dict):
                if self._fixed_language and caption.get(self._fixed_language):
                    return caption[self._fixed_language]
                return choose_language(caption, self.languages, self.rng)
            return caption

        out = dict(ann)
        if isinstance(out.get("caption"), dict):
            out["caption"] = localize(out["caption"])
        out["elems"] = [dict(e, caption=localize(e["caption"])) for e in ann["elems"]]
        return out


class ParaTextStream(_StreamBase):
    """``{text1 (or text), text2}`` pairs -> TTC / TTM / TLM samples: the
    masked side is the first after a direction swap drawn with probability
    ``swap_prob`` (reference ParaTextDataset:500-668)."""

    def __init__(self, reader, text_pre, key_a: str = "text1", key_b: str = "text2",
                 swap_prob: float = 0.5, rng=None, max_consecutive_broken: int = 128):
        super().__init__(reader, text_pre, rng, max_consecutive_broken)
        self.key_a = key_a
        self.key_b = key_b
        self.swap_prob = swap_prob

    def _sample(self, ann: dict) -> Dict:
        a = ann.get(self.key_a, ann.get("text"))
        b = ann[self.key_b]
        if self.rng.random() < self.swap_prob:
            a, b = b, a
        ids, atts, ids_m, pos, labels = self.text_pre(a, with_masking=True)
        ids2, atts2 = self.text_pre(b)
        return {"text_ids": ids, "text_atts": atts, "text_ids_masked": ids_m,
                "masked_pos": pos, "masked_ids": labels, "text_ids_2": ids2,
                "text_atts_2": atts2}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self._samples(self._sample)
