"""Driver of the retrieval-eval cells: X2-VLM's two-stage image-text
retrieval eval (ITC shortlist, ITM rerank) through the port's
``tasks/retrieval.encode_corpus`` and ``retrieval_scores``.

The traffic file gives the gallery (images, captions an image, their
lengths), the image size and the eval's settings (``k_test``, the rerank
rows a call, the encode batches). The gallery is made from the seed: images
as the port's eval datasets yield them (float32 NHWC, CLIP-normalised),
captions as int32 ids with their masks. Set-up builds the retrieval model
with the launcher's factory, loads the seeded weights and runs one whole
pass, which warms every shape; the window repeats whole passes until
``--seconds`` have passed. A pass is ``encode_corpus`` then
``retrieval_scores``, each timed on the host with the card synchronised at
its end.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench.drivers.pretrain import CLS, FIRST_WORD_ID, PAD, SEP, model_block
from portbench.lib import flops, trace as trace_lib
from portbench.lib.harness import sync
from portbench.lib.weights import make_weights
from portbench.reference.x2vlm import IMAGE_MEAN, IMAGE_STD, Reference, param_spec, strict_fp32

__all__ = ["Cell", "Gallery", "make_gallery", "reference_outputs", "numbers"]


class Gallery:
    """The eval dataset's interface that ``encode_corpus`` reads."""

    def __init__(self, images: np.ndarray, ids: np.ndarray, atts: np.ndarray):
        self.images, self.ids, self.atts = images, ids, atts

    def n_images(self):
        return self.images.shape[0]

    def n_texts(self):
        return self.ids.shape[0]

    def image_batch(self, indices):
        return self.images[indices]

    def text_batch(self, indices):
        return self.ids[indices], self.atts[indices]


def make_gallery(tr: Dict, vocab: int, seed: int) -> Gallery:
    rng = np.random.default_rng(seed % (2 ** 63))
    n_img, res = tr["images"], tr["image_res"]
    pixels = rng.integers(0, 256, (n_img, res, res, 3), dtype=np.uint8)
    mean = np.asarray(IMAGE_MEAN, np.float32)
    std = np.asarray(IMAGE_STD, np.float32)
    images = ((pixels.astype(np.float32) / 255.0 - mean) / std).astype(np.float32)
    n_txt, S = n_img * tr["captions_per_image"], tr["max_tokens"]
    lo, hi = tr["caption_tokens"]
    lens = rng.integers(lo, hi + 1, n_txt)
    ids = np.full((n_txt, S), PAD, np.int32)
    atts = np.zeros((n_txt, S), np.int32)
    for i, n in enumerate(lens):
        ids[i, 0], ids[i, n - 1] = CLS, SEP
        ids[i, 1:n - 1] = rng.integers(FIRST_WORD_ID, vocab, n - 2)
        atts[i, :n] = 1
    return Gallery(images, ids, atts)


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.tr, self.seed, self.device = config, traffic, seed, device
        self.m = model_block(config, traffic)
        self.spec = param_spec(self.m, "retrieval")
        n_img = traffic["images"]
        n_txt = n_img * traffic["captions_per_image"]
        k = traffic["k_test"]
        self.pairs = n_img * min(k, n_txt) + n_txt * min(k, n_img)
        self.pass_flops = flops.retrieval_pass(self.m, n_img, n_txt, traffic["max_tokens"],
                                               self.pairs)

    def setup(self) -> None:
        from x2vlm_tpu_torch.factory import build_model
        from x2vlm_tpu_torch.tasks import retrieval as task

        self.task = task
        cfg = {**self.config["yaml"], **self.tr.get("yaml", {}),
               "image_res": self.tr["image_res"]}
        model, _ = build_model(cfg, "retrieval", device=self.device, seed=None)
        model.load_state_dict(make_weights(self.spec, self.seed, self.device), strict=True)
        model.eval()
        self.model = model
        self.gallery = make_gallery(self.tr, self.m["text"]["vocab"], self.seed)
        self.outputs = self._pass()   # warms every shape

    def _pass(self, spans=None):
        tr = self.tr
        t0 = time.time()
        enc = self.task.encode_corpus(self.model, self.gallery, device=self.device,
                                      batch_images=tr["batch_size_test"],
                                      batch_texts=tr["batch_size_test_text"])
        sync(self.device)
        t1 = time.time()
        s_i2t, s_t2i = self.task.retrieval_scores(self.model, *enc, k_test=tr["k_test"],
                                                  rerank_rows=tr["rerank_rows"])
        sync(self.device)
        t2 = time.time()
        if spans is not None:
            spans["encode_s"] += t1 - t0
            spans["rerank_s"] += t2 - t1
        return enc, s_i2t, s_t2i

    def window(self, seconds: float) -> Dict:
        spans = {"encode_s": 0.0, "rerank_s": 0.0}
        passes = 0
        sync(self.device)
        t0 = time.time()
        while passes == 0 or time.time() - t0 < seconds:
            self.outputs = self._pass(spans)
            passes += 1
        dt = spans["encode_s"] + spans["rerank_s"]
        return {"seconds": dt, "passes": passes, "attempted": passes * self.pairs,
                "counts": {"pairs": passes * self.pairs}, "flops": passes * self.pass_flops,
                "spans": spans}

    def trace(self):
        with trace_lib.KernelTap() as tap:
            tr = trace_lib.traced(lambda: self._pass(), tap)
        tr.steps = 1   # one pass
        return tr

    def release(self) -> None:
        enc, s_i2t, s_t2i = self.outputs
        img_embeds, img_feats, txt_embeds, txt_feats, _ = enc
        self.prog = {"img_feats": img_feats.float(), "txt_feats": txt_feats.float(),
                     "img_embeds": img_embeds, "txt_embeds": txt_embeds,
                     "i2t": s_i2t, "t2i": s_t2i}
        del self.model, self.outputs
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def check(self) -> Dict:
        ref = reference_outputs(self.m, self.tr, self.gallery, self.seed, self.device,
                                self.prog)
        return numbers(self.prog, ref)


def sample_rows(n: int, k: int, seed: int, salt: int) -> np.ndarray:
    rng = np.random.default_rng((seed * 7 + salt) % (2 ** 63))
    return np.sort(rng.choice(n, min(k, n), replace=False))


@torch.no_grad()
def reference_outputs(m: Dict, tr: Dict, gallery: Gallery, seed: int, device, prog: Dict,
                      lowp: bool = False) -> Dict:
    """The reference's (``lowp``: the control's) features and embeddings of
    the whole gallery; for query rows drawn from the seed, its similarities
    to every candidate, its ITM scores of the candidates ``prog``'s score
    matrices hold for those rows, and its own shortlist's scores."""
    strict_fp32()
    P = make_weights(param_spec(m, "retrieval"), seed, device)
    ref = Reference(P, m, lowp=lowp)
    bi = tr["reference_batch"]
    img_e, img_f = [], []
    for lo in range(0, gallery.n_images(), bi):
        e, f = ref.encode_images(torch.from_numpy(
            gallery.images[lo:lo + bi]).to(device))
        img_e.append(e)
        img_f.append(f)
    ids = torch.from_numpy(gallery.ids).to(device)
    atts = torch.from_numpy(gallery.atts).to(device)
    txt_e, txt_f = ref.encode_texts(ids, atts)
    img_e, img_f = torch.cat(img_e), torch.cat(img_f)
    out = {"img_feats": img_f, "txt_feats": txt_f, "img_embeds": img_e, "txt_embeds": txt_e}
    sims = img_f @ txt_f.t()
    k = tr["k_test"]
    rows = {"i2t": sample_rows(gallery.n_images(), tr["check_image_rows"], seed, 1),
            "t2i": sample_rows(gallery.n_texts(), tr["check_text_rows"], seed, 2)}
    for d, s in (("i2t", sims), ("t2i", sims.t())):
        cand_prog = [np.nonzero(prog[d][r] != -100.0)[0] for r in rows[d]]
        cand_own = [torch.topk(s[r], min(k, s.shape[1])).indices.cpu().numpy()
                    for r in rows[d]]
        out[d] = {"rows": rows[d], "sims": s[torch.from_numpy(rows[d]).to(device)].cpu(),
                  "prog_cands": cand_prog,
                  "prog_scores": _itm(ref, d, rows[d], cand_prog, img_e, txt_e, atts,
                                      tr["reference_pairs"]),
                  "own_cands": cand_own}
    return out


def _itm(ref, d, rows, cands, img_e, txt_e, atts, chunk):
    """The reference's ITM scores of each (row, candidate) pair."""
    q = np.concatenate([np.full(len(c), r) for r, c in zip(rows, cands)])
    c = np.concatenate(cands)
    img_idx, txt_idx = (q, c) if d == "i2t" else (c, q)
    out = []
    for lo in range(0, len(q), chunk):
        ii = torch.from_numpy(img_idx[lo:lo + chunk]).to(img_e.device)
        tt = torch.from_numpy(txt_idx[lo:lo + chunk]).to(img_e.device)
        uniq, gather = torch.unique(ii, return_inverse=True)
        out.append(ref.itm_score(img_e[uniq], txt_e[tt], atts[tt], gather=gather).cpu())
    return torch.cat(out) if out else torch.zeros(0)


def numbers(prog: Dict, ref: Dict) -> Dict:
    """The compared numbers: the worst row's relative L2 gap of the
    features and of the embeddings; the worst shortlist gap (how far the
    reference's similarity of a shortlisted candidate lies below that of
    the best candidate left out, over the sampled rows, both ways); the
    worst gap of an ITM score against the reference's for the same pair."""
    def rel(a, b):
        a, b = a.float().flatten(1), b.float().flatten(1)
        r = (a - b).norm(dim=1) / b.norm(dim=1).clamp(min=1e-30)
        i = int(r.argmax())
        return float(r[i]), i

    out = {}
    f1 = rel(prog["img_feats"], ref["img_feats"])
    f2 = rel(prog["txt_feats"], ref["txt_feats"])
    out["feature_gap"] = max((f1[0], f"image {f1[1]}"), (f2[0], f"text {f2[1]}"))
    e1 = rel(prog["img_embeds"], ref["img_embeds"])
    e2 = rel(prog["txt_embeds"], ref["txt_embeds"])
    out["embed_gap"] = max((e1[0], f"image {e1[1]}"), (e2[0], f"text {e2[1]}"))
    short, score = (0.0, ""), (0.0, "")
    for d in ("i2t", "t2i"):
        r = ref[d]
        for j, row in enumerate(r["rows"]):
            s = r["sims"][j]
            chosen = torch.zeros(s.shape[0], dtype=torch.bool)
            chosen[torch.from_numpy(r["prog_cands"][j])] = True
            if (~chosen).any():
                gap = float(s[~chosen].max() - s[chosen].min())
                short = max(short, (gap, f"{d} row {row}"))
        got = torch.from_numpy(np.concatenate([prog[d][row][c] for row, c in
                                               zip(r["rows"], r["prog_cands"])]))
        g = (got - r["prog_scores"]).abs()
        score = max(score, (float(g.max()), f"{d} pair {int(g.argmax())}"))
    out["shortlist_gap"] = short
    out["itm_gap"] = score
    return out


def control_outputs(m, tr, gallery, seed, device, prog_like=None) -> Dict:
    """The control's outputs in the program's form: the reference in float8
    (``lowp``) put in the program's place, its shortlist its own."""
    strict_fp32()
    ctl = reference_outputs(m, tr, gallery, seed, device, prog_like or _empty(gallery),
                            lowp=True)
    n_img, n_txt = gallery.n_images(), gallery.n_texts()
    i2t = np.full((n_img, n_txt), -100.0, np.float32)
    t2i = np.full((n_txt, n_img), -100.0, np.float32)
    P = make_weights(param_spec(m, "retrieval"), seed, device)
    ref = Reference(P, m, lowp=True)
    atts = torch.from_numpy(gallery.atts).to(device)
    for d, mat in (("i2t", i2t), ("t2i", t2i)):
        r = ctl[d]
        scores = _itm(ref, d, r["rows"], r["own_cands"], ctl["img_embeds"], ctl["txt_embeds"],
                      atts, tr["reference_pairs"]).numpy()
        lo = 0
        for row, c in zip(r["rows"], r["own_cands"]):
            mat[row, c] = scores[lo:lo + len(c)]
            lo += len(c)
    return {"img_feats": ctl["img_feats"], "txt_feats": ctl["txt_feats"],
            "img_embeds": ctl["img_embeds"], "txt_embeds": ctl["txt_embeds"],
            "i2t": i2t, "t2i": t2i}


def _empty(gallery):
    return {"i2t": np.full((gallery.n_images(), gallery.n_texts()), -100.0, np.float32),
            "t2i": np.full((gallery.n_texts(), gallery.n_images()), -100.0, np.float32)}
