"""Pretraining data streams (the port's counterpart of
x2vlm_tpu/data/pretrain.py): the image-text, the region-text, the
video-frame-text and the text-only JSONL streams over the sharded line
reader, emitting fixed-shape numpy samples; ``region_collate``, the region
stream's batches; ``sample_frame_ids`` / ``sample_clip_ids``, the temporal
sampling of the video stream and the video datasets.

A broken sample (an undecodable image, a missing key) is skipped and
counted in ``broken``, as in the JAX package; and once
``max_consecutive_broken`` samples in a row have broken (a batch's worth,
as the launcher sets it) the stream raises instead of spinning, so a
missing decoder cannot turn into a stream that never yields. A video line
whose caption is empty or in the skip set is passed over without counting,
as in the JAX package. The multilingual streams subclass these
(data/multilingual.py).

A transform with ``wants_bytes`` (``data/native.py``, the C++ decode and
augment) is handed the encoded bytes, never a PIL image: the image stream
transforms one image a call, the video stream a video's sampled frames in
one call, the region stream the crop it chose (the bbox-aware crop stays
here). The JAX package's image stream groups images into calls of several;
one image a call draws the same seeds from the transform's rng, and a
batch then reads no line past its end (the launcher seeds each batch from
its first line, ``run._stream_pairs``). That costs the image and region
streams the C++ thread pool: their images are decoded one after another on
the stream's prefetch thread (the launcher gives their transforms one
thread), where the JAX package's calls spread a chunk over the pool. Only
the video stream's calls, a video's frames each, use several threads.
"""

from __future__ import annotations

import math
import random
from base64 import b64decode
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from x2vlm_tpu_torch.core.io import hopen
from x2vlm_tpu_torch.data.imageio import decode_image, open_image, pil
from x2vlm_tpu_torch.data.loader import collate
from x2vlm_tpu_torch.data.streaming import DistLineReader
from x2vlm_tpu_torch.data.tokenization import TextPreprocessor
from x2vlm_tpu_torch.data.transforms import hflip

__all__ = ["ImageTextStream", "RegionTextStream", "TextStream", "VideoTextStream",
           "BrokenStreamError", "region_collate", "sample_frame_ids", "sample_clip_ids"]


class BrokenStreamError(RuntimeError):
    """Every one of the last ``max_consecutive_broken`` samples was broken."""


def _image(ann: dict, image_key: str, is_rpath: bool):
    if is_rpath:
        return open_image(ann[image_key])
    return decode_image(b64decode(ann[image_key]))


def _image_bytes(ann: dict, image_key: str, is_rpath: bool) -> bytes:
    """The encoded image, for a transform with ``wants_bytes``."""
    if not is_rpath:
        return b64decode(ann[image_key])
    with hopen(ann[image_key], "rb") as f:
        return f.read()


def _wants_bytes(transform) -> bool:
    return getattr(transform, "wants_bytes", False)


def _choose_caption(caption, rng) -> str:
    if isinstance(caption, list):
        return rng.choice(caption)
    return caption


class _StreamBase:
    def __init__(self, reader: DistLineReader, text_pre: TextPreprocessor,
                 rng: Optional[random.Random] = None, max_consecutive_broken: int = 128):
        self.reader = reader
        self.text_pre = text_pre
        self.rng = rng or random.Random()
        self.broken = 0
        self.max_consecutive_broken = max_consecutive_broken
        self._in_a_row = 0

    def _samples(self, make: Callable[[dict], Dict]) -> Iterator[Dict]:
        for ann in self.reader.iter_json():
            try:
                sample = make(ann)
            except Exception as e:  # noqa: BLE001 -- any broken sample is skipped and counted
                self.broken += 1
                self._in_a_row += 1
                if self._in_a_row >= self.max_consecutive_broken:
                    raise BrokenStreamError(
                        f"{type(self).__name__}: the last {self._in_a_row} samples were "
                        f"broken ({self.broken} in all); the last: "
                        f"{type(e).__name__}: {e}") from e
                continue
            if sample is None:     # passed over, not broken
                continue
            self._in_a_row = 0
            yield sample


class ImageTextStream(_StreamBase):
    """JSONL {image_key: b64|path, caption_key: str|[str]} -> multimodal MLM
    samples (reference ImageTextJsonDataset:131-287)."""

    def __init__(self, reader, text_pre, transform: Callable,
                 image_key: str = "binary", caption_key: str = "desc",
                 is_image_rpath: bool = False, rng=None, max_consecutive_broken: int = 128):
        super().__init__(reader, text_pre, rng, max_consecutive_broken)
        self.transform = transform
        self.image_key = image_key
        self.caption_key = caption_key
        self.is_image_rpath = is_image_rpath

    def _sample(self, ann: dict) -> Dict:
        if _wants_bytes(self.transform):
            image = self.transform(_image_bytes(ann, self.image_key, self.is_image_rpath))
        else:
            image = np.asarray(self.transform(_image(ann, self.image_key,
                                                     self.is_image_rpath)))
        return self._text_sample(ann, image)

    def _text_sample(self, ann: dict, image: np.ndarray) -> Dict:
        caption = _choose_caption(ann[self.caption_key], self.rng)
        ids, atts, ids_masked, pos, labels = self.text_pre(caption, with_masking=True)
        return {"image": image, "text_ids": ids, "text_atts": atts,
                "text_ids_masked": ids_masked, "masked_pos": pos, "masked_ids": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self._samples(self._sample)


class TextStream(_StreamBase):
    """Text-only MLM stream (reference TextJsonDataset:663-785)."""

    def __init__(self, reader, text_pre, caption_key: str = "text", rng=None,
                 max_consecutive_broken: int = 128):
        super().__init__(reader, text_pre, rng, max_consecutive_broken)
        self.caption_key = caption_key

    def _sample(self, ann: dict) -> Dict:
        caption = _choose_caption(ann[self.caption_key], self.rng)
        ids, atts, ids_masked, pos, labels = self.text_pre(caption, with_masking=True)
        return {"text_ids": ids, "text_atts": atts, "text_ids_masked": ids_masked,
                "masked_pos": pos, "masked_ids": labels}

    def __iter__(self):
        return self._samples(self._sample)


def sample_frame_ids(n_frames: int, frame_len: int, training: bool,
                     rng: Optional[random.Random] = None) -> List[int]:
    """Temporal sampling (reference dataset/utils.py:66-92): the video split
    into ``frame_len`` segments; training picks a random frame of each, eval
    its middle; a video of at most ``frame_len`` frames wraps."""
    rng = rng or random
    if n_frames <= frame_len:
        return [i % n_frames for i in range(frame_len)]
    seg = n_frames / frame_len
    ids = []
    for i in range(frame_len):
        lo = int(math.floor(seg * i))
        hi = max(lo, int(math.floor(seg * (i + 1))) - 1)
        ids.append(rng.randint(lo, hi) if training else (lo + hi) // 2)
    return ids


def sample_clip_ids(clips, minimum_frames: int, clip_captions=None, skip_caption_set=None,
                    rng=None) -> List[int]:
    """A contiguous run of clips grown around a random anchor, one side at a
    time, until it holds ``minimum_frames`` frames (reference
    dataset/utils.py:19-63); clips whose caption is in the skip set count no
    frames and are left out of the result."""
    rng = rng or random
    skip_caption_set = skip_caption_set or set()
    caps = [c.strip() for c in clip_captions] if clip_captions else None

    def count(ids):
        return sum(len(clips[i]) for i in ids
                   if caps is None or caps[i] not in skip_caption_set)

    mid = rng.randrange(len(clips))
    ids, left, right = [mid], mid, mid
    while count(ids) < minimum_frames and len(ids) < len(clips):
        if left - 1 < 0:
            right += 1
            ids.append(right)
        elif right + 1 >= len(clips):
            left -= 1
            ids.append(left)
        elif rng.random() < 0.5:
            right += 1
            ids.append(right)
        else:
            left -= 1
            ids.append(left)
    ids = sorted(ids)
    if caps is not None:
        ids = [i for i in ids if caps[i] not in skip_caption_set]
    return ids


class VideoTextStream(_StreamBase):
    """Frame-list videos -> (frame_len, H, W, 3) samples (reference
    FrameTextDataset:290-424), each frame a base64 image or a path. A
    clip-of-clips line (``frames`` a list of clips, each a frame list, with
    a caption per clip) takes one clip whose caption is not skipped, or,
    with ``combine_continuous_clips`` on an ``is_continuous`` line,
    neighbouring clips merged until ``minimum_frames_before_sampling``
    frames (``sample_clip_ids``), their captions joined. The frames keep the
    transform's dtype (uint8 from the pretraining transform)."""

    def __init__(self, reader, text_pre, transform: Callable, frame_len: int = 3,
                 frames_key: str = "frames", caption_key: str = "caption",
                 is_image_rpath: bool = False, training: bool = True,
                 skip_captions: Sequence[str] = ("[Music]",),
                 combine_continuous_clips: bool = False,
                 minimum_frames_before_sampling: int = -1, rng=None,
                 max_consecutive_broken: int = 128):
        super().__init__(reader, text_pre, rng, max_consecutive_broken)
        self.transform = transform
        self.frame_len = frame_len
        self.frames_key = frames_key
        self.caption_key = caption_key
        self.is_image_rpath = is_image_rpath
        self.training = training
        self.skip_captions = set(skip_captions)
        self.combine_continuous_clips = combine_continuous_clips
        self.minimum_frames_before_sampling = minimum_frames_before_sampling
        if combine_continuous_clips and minimum_frames_before_sampling <= 0:
            raise ValueError("combine_continuous_clips needs minimum_frames_before_sampling")

    def _get_clips(self, clips, captions, is_continuous):
        """(frames, clip ids) of a clip-of-clips line (reference get_clips,
        pretrain_dataset.py:321-345)."""
        if len(clips) == 1:
            return clips[0], [0]
        if is_continuous and self.combine_continuous_clips:
            ids = sample_clip_ids(clips, self.minimum_frames_before_sampling,
                                  clip_captions=captions, skip_caption_set=self.skip_captions,
                                  rng=self.rng)
            return [f for i in ids for f in clips[i]], ids
        if not isinstance(captions, list):   # one caption for every clip
            i = self.rng.randrange(len(clips))
            return clips[i], [i]
        eligible = [j for j, c in enumerate(captions) if c not in self.skip_captions]
        if not eligible:
            raise ValueError("every clip caption is in the skip set")
        i = self.rng.choice(eligible)
        return clips[i], [i]

    def _sample(self, ann: dict) -> Optional[Dict]:
        frames = ann[self.frames_key]
        raw_cap = ann[self.caption_key]
        if frames and isinstance(frames[0], list):
            frames, clip_ids = self._get_clips(frames, raw_cap, ann.get("is_continuous", False))
            caption = " ".join(raw_cap[i] for i in clip_ids) \
                if isinstance(raw_cap, list) else raw_cap
        else:
            caption = _choose_caption(raw_cap, self.rng)
        if not caption or caption in self.skip_captions:
            return None
        ids = sample_frame_ids(len(frames), self.frame_len, self.training, self.rng)
        if _wants_bytes(self.transform):   # the sampled frames in one call
            image, ok = self.transform.transform_batch(
                [_image_bytes({"f": frames[i]}, "f", self.is_image_rpath) for i in ids])
            if not ok.all():
                raise ValueError("broken frame (native decode failed)")
        else:
            image = np.stack([np.asarray(self.transform(
                _image({"f": frames[i]}, "f", self.is_image_rpath))) for i in ids])
        t_ids, atts, ids_masked, pos, labels = self.text_pre(caption, with_masking=True)
        return {"image": image, "text_ids": t_ids, "text_atts": atts,
                "text_ids_masked": ids_masked, "masked_pos": pos, "masked_ids": labels}

    def __iter__(self):
        return self._samples(self._sample)


class RegionTextStream(_StreamBase):
    """Region-text stream (reference RegionTextJsonDataset:427-610): a
    box-aware random crop around one region, a careful hflip (never when a
    caption names "left" or "right"), then per region its caption, its
    patch bitmap and its normalised cxcywh box, plus the full-image caption
    as a row of its own (``is_image`` 1) where the line has one. Each
    sample is ``{"image": (H, W, 3) float32 (uint8 from a ``wants_bytes``
    box transform), "rows": [row, ...]}``.

    ``box_transform`` augments the resized crop (``transforms.box_transform``
    with its own rng, so the stream's draws from ``rng`` come in the JAX
    package's order: the region, the crop corners, the flip, the captions
    and the shuffle)."""

    def __init__(self, reader, text_pre, box_transform: Callable, *,
                 image_res: int, patch_size: int, max_regions: int = 5,
                 min_perc_in_image: float = 0.5, careful_hflip: bool = True,
                 image_key: str = "binary", is_image_rpath: bool = False,
                 rng=None, max_consecutive_broken: int = 128):
        super().__init__(reader, text_pre, rng, max_consecutive_broken)
        self.box_transform = box_transform
        self.image_res = image_res
        self.patch_size = patch_size
        self.num_patch = image_res // patch_size
        self.max_regions = max_regions
        self.min_perc = min_perc_in_image
        self.careful_hflip = careful_hflip
        self.image_key = image_key
        self.is_image_rpath = is_image_rpath

    def get_image_attns(self, x, y, w, h) -> np.ndarray:
        """Patch bitmap over the region, plus the CLS slot (reference
        :595-610)."""
        P, ps = self.num_patch, self.patch_size
        x_min = min(math.floor(x / ps), P - 1)
        x_max = max(x_min + 1, min(math.ceil((x + w) / ps), P))
        y_min = min(math.floor(y / ps), P - 1)
        y_max = max(y_min + 1, min(math.ceil((y + h) / ps), P))
        atts = np.zeros(1 + P * P, np.float32)
        atts[0] = 1
        grid = atts[1:].reshape(P, P)
        grid[y_min:y_max, x_min:x_max] = 1
        return atts

    @staticmethod
    def _left_right_in_captions(ann) -> bool:
        def named(caption):
            caps = caption if isinstance(caption, list) else [caption]
            return any(("left" in c) or ("right" in c) for c in caps)

        if "caption" in ann and named(ann["caption"]):
            return True
        return any("caption" in e and named(e["caption"]) for e in ann["elems"])

    def _row(self, cap: str, image_atts, target_bbox, is_image: float) -> Dict:
        ids, atts, ids_m, pos, labels = self.text_pre(cap, with_masking=True)
        return {"text_ids": ids, "text_atts": atts, "text_ids_masked": ids_m,
                "masked_pos": pos, "masked_ids": labels, "image_atts": image_atts,
                "target_bbox": np.asarray(target_bbox, np.float32),
                "is_image": np.float32(is_image)}

    def _sample(self, ann: dict) -> Dict:
        rng = self.rng
        native = _wants_bytes(self.box_transform)
        if native:
            raw = _image_bytes(ann, self.image_key, self.is_image_rpath)
            W, H = self.box_transform.image_dims(raw)
        else:
            img = _image(ann, self.image_key, self.is_image_rpath)
            W, H = img.size
        x, y, w, h = [int(v) for v in rng.choice(ann["elems"])["bb"]]
        if not (x >= 0 and y >= 0 and x + w <= W and y + h <= H and w > 0 and h > 0):
            raise ValueError(f"box {(x, y, w, h)} outside the {W}x{H} image")

        # a crop that holds the chosen region whole
        x0, y0 = rng.randint(0, x), rng.randint(0, y)
        x1 = rng.randint(min(x + w, W), W)
        y1 = rng.randint(min(y + h, H), H)
        w0, h0 = x1 - x0, y1 - y0
        do_hflip = bool(rng.random() < 0.5 and not (
            self.careful_hflip and self._left_right_in_captions(ann)))

        if native:   # ROI decode, resample, flip and augment in C++; uint8
            images, ok = self.box_transform.region_batch([raw], [(x0, y0, w0, h0)],
                                                         [do_hflip])
            if not ok[0]:
                raise ValueError("broken image (native decode failed)")
            image, W, H = images[0], w0, h0
        else:
            img = img.crop((x0, y0, x1, y1))
            W, H = img.size
            if do_hflip:
                img = hflip(img)
            img = img.resize((self.image_res, self.image_res), pil().BICUBIC)
            image = self.box_transform(img).astype(np.float32)

        rows: List[Dict] = []
        max_elems = self.max_regions
        res = self.image_res
        if "caption" in ann:
            rows.append(self._row(_choose_caption(ann["caption"], rng),
                                  np.ones(1 + self.num_patch ** 2, np.float32),
                                  [0.5, 0.5, 1, 1], 1))
            max_elems -= 1

        elems = list(ann["elems"])
        rng.shuffle(elems)
        for elem in elems:
            if max_elems <= 0:
                break
            x, y, w, h = [int(v) for v in elem["bb"]]
            xx, yy = max(x0, x), max(y0, y)
            xm, ym = min(x0 + w0, x + w), min(y0 + h0, y + h)
            if not (xm > xx and ym > yy):
                continue
            if (xm - xx) * (ym - yy) / (w * h) <= self.min_perc:
                continue
            # the part inside the crop, in the resized crop's pixels
            x, y, w, h = xx - x0, yy - y0, xm - xx, ym - yy
            if do_hflip:
                x = (W - x) - w
            x, w = res / W * x, res / W * w
            y, h = res / H * y, res / H * h
            cap = _choose_caption(elem["caption"], rng)
            if "attributes" in elem:
                cap = _choose_caption(elem["attributes"], rng) + " " + cap
            rows.append(self._row(cap, self.get_image_attns(x, y, w, h),
                                  [(x + w / 2) / res, (y + h / 2) / res, w / res, h / res], 0))
            max_elems -= 1

        if not rows:
            raise ValueError("no region of the line lies in the crop")
        return {"image": image, "rows": rows}

    def __iter__(self):
        return self._samples(self._sample)


def region_collate(samples: Sequence[Dict], batch_size: int, max_images: int,
                   rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
    """A region batch of fixed shape (reference collate_fn:612-660): the
    rows of up to ``max_images`` images, ``batch_size`` of them sampled
    without replacement (or all of them, then padded by draws with
    replacement), ``idx_to_group_img`` naming each row's image, and the
    images padded with zero images to ``max_images``."""
    rng = rng or random
    samples = list(samples)[:max_images]
    images = [s["image"] for s in samples]
    rows, idx_to_group = [], []
    for ii, s in enumerate(samples):
        for r in s["rows"]:
            rows.append(r)
            idx_to_group.append(ii)

    n = len(rows)
    if n >= batch_size:
        keep = rng.sample(range(n), batch_size)
    else:
        keep = list(range(n))
        while len(keep) < batch_size:
            keep.append(rng.choice(range(n)))
    batch = collate([rows[i] for i in keep])
    batch["idx_to_group_img"] = np.asarray([idx_to_group[i] for i in keep], np.int32)
    while len(images) < max_images:
        images.append(np.zeros_like(images[0]))
    batch["image"] = np.stack(images)
    return batch
