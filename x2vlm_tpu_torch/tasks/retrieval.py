"""Image-text retrieval evaluation, the two-stage protocol (the port's
counterpart of x2vlm_tpu/tasks/retrieval.py; reference Retrieval.py
evaluation:71-168, itm_eval:171-215).

- every image and text is encoded in fixed-size batches (``encode_corpus``);
- the ITC similarity matrix is one matmul;
- the ITM rerank scores ``rerank_rows`` query rows per call, each against
  its top ``k_test`` candidates (``retrieval_scores``): 8 images x 128
  texts = 1024 fusion rows a call at the defaults;
- ``itm_eval`` turns the two score matrices into R@1/5/10 both ways.

At world N each rank reranks its contiguous share of the query rows
(``n // N + 1`` a rank, ``-100`` elsewhere) and the ranks' matrices are
all-gathered and merged by row ownership (``merge_row_sharded``), as the
JAX package's multi-host rerank.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from x2vlm_tpu_torch.core import mesh
from x2vlm_tpu_torch.tasks.finetune import host_range

__all__ = ["encode_corpus", "retrieval_scores", "merge_row_sharded", "itm_eval",
           "evaluate_retrieval"]


def _pad_rows(arr: np.ndarray, size: int) -> np.ndarray:
    if arr.shape[0] == size:
        return arr
    pad = np.zeros((size - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], 0)


@torch.inference_mode()
def encode_corpus(model, dataset, *, device, batch_images: int = 64, batch_texts: int = 256):
    """Encode every image and text of ``dataset`` (RetrievalEvalDataset, or
    VideoRetrievalDataset: its (B, F, H, W, 3) videos pooled over frames by
    ``encode_images``). Returns device tensors: img_embeds, img_feats,
    txt_embeds, txt_feats, txt_atts. Ragged tails are padded to the batch
    size, then sliced off."""
    img_embeds, img_feats = [], []
    n_img = dataset.n_images()
    for lo in range(0, n_img, batch_images):
        idx = list(range(lo, min(lo + batch_images, n_img)))
        imgs = _pad_rows(dataset.image_batch(idx), batch_images)
        e, f = model.encode_images(torch.from_numpy(imgs).to(device))
        img_embeds.append(e[:len(idx)])
        img_feats.append(f[:len(idx)])
    txt_embeds, txt_feats, txt_atts = [], [], []
    n_txt = dataset.n_texts()
    for lo in range(0, n_txt, batch_texts):
        idx = list(range(lo, min(lo + batch_texts, n_txt)))
        ids, atts = dataset.text_batch(idx)
        ids = torch.from_numpy(_pad_rows(ids, batch_texts)).to(device)
        atts_p = torch.from_numpy(_pad_rows(atts, batch_texts)).to(device)
        e, f = model.encode_texts(ids, atts_p)
        txt_embeds.append(e[:len(idx)])
        txt_feats.append(f[:len(idx)])
        txt_atts.append(atts_p[:len(idx)])
    return (torch.cat(img_embeds), torch.cat(img_feats), torch.cat(txt_embeds),
            torch.cat(txt_feats), torch.cat(txt_atts))


@torch.inference_mode()
def retrieval_scores(model, img_embeds, img_feats, txt_embeds, txt_feats, txt_atts, *,
                     k_test: int, rerank_rows: int = 8, host_id: int = 0, num_hosts: int = 1):
    """Two-stage scores: (score_i2t (n_img, n_txt), score_t2i (n_txt, n_img))
    as numpy, -100 at the entries outside each row's top ``k_test``. The
    last block of rows is padded with its last row, as the JAX package's.
    With ``num_hosts`` > 1 this rank scores its share of the rows
    (``host_range``) and every rank returns the merged matrices."""
    n_img, n_txt = img_feats.shape[0], txt_feats.shape[0]
    k_i2t, k_t2i = min(k_test, n_txt), min(k_test, n_img)
    sims = img_feats @ txt_feats.t()      # (n_img, n_txt) fp32

    def rerank(sims_rows, k, pairs: Callable):
        topk = torch.topk(sims_rows, k, dim=1).indices            # (R, k)
        return topk, pairs(topk).reshape(-1, k)

    def score_block(query_embeds_fn, scores, sims_q, k, n_q):
        share = host_range(n_q, host_id, num_hosts)
        for r0 in range(share.start, share.stop, rerank_rows):
            rows = np.arange(r0, min(r0 + rerank_rows, share.stop))
            rows_p = np.concatenate([rows, np.full(rerank_rows - len(rows), rows[-1])])
            idx = torch.from_numpy(rows_p).to(sims_q.device)
            topk, score = rerank(sims_q.index_select(0, idx), k,
                                 lambda t: query_embeds_fn(idx, t))
            topk, score = topk.cpu().numpy(), score.float().cpu().numpy()
            for j, r in enumerate(rows):
                scores[r, topk[j]] = score[j]

    def i2t_pairs(row_idx, topk):
        img = img_embeds.index_select(0, row_idx).repeat_interleave(topk.shape[1], 0)
        flat = topk.reshape(-1)
        return model.itm_score(img, txt_embeds.index_select(0, flat),
                               txt_atts.index_select(0, flat))

    def t2i_pairs(col_idx, topk):
        k = topk.shape[1]
        t_e = txt_embeds.index_select(0, col_idx).repeat_interleave(k, 0)
        t_a = txt_atts.index_select(0, col_idx).repeat_interleave(k, 0)
        return model.itm_score(img_embeds.index_select(0, topk.reshape(-1)), t_e, t_a)

    score_i2t = np.full((n_img, n_txt), -100.0, np.float32)
    score_block(i2t_pairs, score_i2t, sims, k_i2t, n_img)
    score_t2i = np.full((n_txt, n_img), -100.0, np.float32)
    score_block(t2i_pairs, score_t2i, sims.t().contiguous(), k_t2i, n_txt)
    if num_hosts > 1:
        score_i2t = merge_row_sharded(mesh.all_gather_array(score_i2t), num_hosts)
        score_t2i = merge_row_sharded(mesh.all_gather_array(score_t2i), num_hosts)
    return score_i2t, score_t2i


def merge_row_sharded(gathered: np.ndarray, num_hosts: int) -> np.ndarray:
    """The ranks' score matrices (num_hosts, n, m) merged by row ownership:
    rank h's rows are ``host_range(n, h, num_hosts)``."""
    merged = np.empty_like(gathered[0])
    n = merged.shape[0]
    for h in range(num_hosts):
        rows = host_range(n, h, num_hosts)
        merged[rows.start:rows.stop] = gathered[h, rows.start:rows.stop]
    return merged


def itm_eval(scores_i2t: np.ndarray, scores_t2i: np.ndarray, txt2img: Dict[int, int],
             img2txt: Dict[int, list]) -> Dict[str, float]:
    """R@1/5/10 both directions + means (reference Retrieval.py:171-215)."""
    ranks = np.zeros(scores_i2t.shape[0])
    for index, score in enumerate(scores_i2t):
        inds = np.argsort(score)[::-1]
        ranks[index] = min(np.where(inds == i)[0][0] for i in img2txt[index])
    tr1, tr5, tr10 = [100.0 * np.mean(ranks < k) for k in (1, 5, 10)]
    ranks = np.zeros(scores_t2i.shape[0])
    for index, score in enumerate(scores_t2i):
        inds = np.argsort(score)[::-1]
        ranks[index] = np.where(inds == txt2img[index])[0][0]
    ir1, ir5, ir10 = [100.0 * np.mean(ranks < k) for k in (1, 5, 10)]
    tr_mean = (tr1 + tr5 + tr10) / 3
    ir_mean = (ir1 + ir5 + ir10) / 3
    return {"txt_r1": tr1, "txt_r5": tr5, "txt_r10": tr10, "txt_r_mean": tr_mean,
            "img_r1": ir1, "img_r5": ir5, "img_r10": ir10, "img_r_mean": ir_mean,
            "r1_mean": (tr1 + ir1) / 2, "r_mean": (tr_mean + ir_mean) / 2}


def evaluate_retrieval(model, dataset, *, device, k_test: int = 128, batch_images: int = 64,
                       batch_texts: int = 256, rerank_rows: int = 8, host_id: int = 0,
                       num_hosts: int = 1) -> Dict[str, float]:
    """Encode, score (row-sharded over ``num_hosts`` ranks, merged) and
    rank ``dataset``; the metrics of :func:`itm_eval` and ``eval_seconds``
    (wall time, the card synchronised at the end)."""
    was_training = model.training
    model.eval()
    t0 = time.time()
    enc = encode_corpus(model, dataset, device=device, batch_images=batch_images,
                        batch_texts=batch_texts)
    s_i2t, s_t2i = retrieval_scores(model, *enc, k_test=k_test, rerank_rows=rerank_rows,
                                    host_id=host_id, num_hosts=num_hosts)
    metrics = itm_eval(s_i2t, s_t2i, dataset.txt2img, dataset.img2txt)
    metrics["eval_seconds"] = round(time.time() - t0, 2)
    model.train(was_training)
    return metrics
