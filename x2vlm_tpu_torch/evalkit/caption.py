"""Caption metrics (the port's own copy of x2vlm_tpu/evalkit/caption.py,
pure Python, held equal to it in the CPU tests): BLEU-1..4, CIDEr-D,
ROUGE-L and METEOR. The reference vendors utils/cider/ and relies on
pycocoevalcap for the full COCO metric set (dataset/utils.py:456-483);
these are self-contained implementations of the standard algorithms:

- corpus BLEU with brevity penalty
- CIDEr-D with tf-idf 1-4-gram cosine similarity, length/clipping penalties
- ROUGE-L as in pycocoevalcap/rouge: per-segment max-over-refs LCS F-measure
  with beta=1.2, corpus mean
- METEOR (Lavie & Agarwal 2007) with exact + Porter-stem matching stages and
  the fragmentation (chunk) penalty. pycocoevalcap shells out to the METEOR
  1.5 Java jar whose synonym/paraphrase tables are external data files; this
  implementation covers the exact/stem stages (the dominant matchers for
  English captions) and is fully reproducible offline.

SPICE is deliberately not implemented: it requires the Stanford scene-graph
parser (a Java dependency the reference also only reaches through
pycocoevalcap's jar).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

__all__ = ["bleu", "cider_d", "rouge_l", "meteor", "porter_stem",
           "caption_eval"]


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu(predictions: List[str], references: List[List[str]], max_n: int = 4
         ) -> Dict[str, float]:
    """Corpus BLEU with uniform weights and closest-length brevity penalty."""
    clipped = [0] * max_n
    totals = [0] * max_n
    pred_len, ref_len = 0, 0
    for pred, refs in zip(predictions, references):
        p = pred.split()
        rs = [r.split() for r in refs]
        pred_len += len(p)
        ref_len += min((abs(len(r) - len(p)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            pn = _ngrams(p, n)
            maxref: Counter = Counter()
            for r in rs:
                rn = _ngrams(r, n)
                for g, c in rn.items():
                    maxref[g] = max(maxref[g], c)
            totals[n - 1] += max(len(p) - n + 1, 0)
            clipped[n - 1] += sum(min(c, maxref[g]) for g, c in pn.items())
    out = {}
    log_sum = 0.0
    bp = 1.0 if pred_len > ref_len else math.exp(1 - ref_len / max(pred_len, 1))
    for n in range(1, max_n + 1):
        pn = clipped[n - 1] / totals[n - 1] if totals[n - 1] else 0.0
        log_sum += math.log(pn) if pn > 0 else -9999.0
        out[f"bleu{n}"] = bp * math.exp(log_sum / n)
    return out


def cider_d(predictions: List[str], references: List[List[str]],
            max_n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D corpus score (Vedantam et al. 2015), df from the reference set."""
    doc_freq: Dict = defaultdict(int)
    ref_grams = []
    pred_grams = []
    for pred, refs in zip(predictions, references):
        rgs = []
        for r in refs:
            toks = r.split()
            gs = {n: _ngrams(toks, n) for n in range(1, max_n + 1)}
            rgs.append((gs, len(toks)))
        ref_grams.append(rgs)
        for g in set(g for gs, _ in rgs for n in gs for g in gs[n]):
            doc_freq[g] += 1
        ptoks = pred.split()
        pred_grams.append(({n: _ngrams(ptoks, n) for n in range(1, max_n + 1)},
                           len(ptoks)))
    n_docs = max(len(references), 1)
    log_n = math.log(n_docs)

    def tfidf(gs: Counter, n: int):
        vec = {}
        norm = 0.0
        length = sum(gs.values())
        for g, c in gs.items():
            df = math.log(max(doc_freq[g], 1))
            w = (c / max(length, 1)) * max(log_n - df, 0.0)
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm)

    scores = []
    for (pgs, plen), rgs in zip(pred_grams, ref_grams):
        score_n = [0.0] * max_n
        for n in range(1, max_n + 1):
            pvec, pnorm = tfidf(pgs[n], n)
            for (rg, rlen) in rgs:
                rvec, rnorm = tfidf(rg[n], n)
                # clipped dot product (CIDEr-D)
                dot = sum(min(pvec[g], rvec.get(g, 0.0)) * rvec.get(g, 0.0)
                          for g in pvec)
                sim = dot / (pnorm * rnorm) if pnorm > 0 and rnorm > 0 else 0.0
                delta = plen - rlen
                sim *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                score_n[n - 1] += sim
            score_n[n - 1] /= len(rgs)
        scores.append(10.0 * sum(score_n) / max_n)
    return sum(scores) / max(len(scores), 1)


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Longest common subsequence length, O(len(a)·len(b)) with a rolling row."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(predictions: List[str], references: List[List[str]],
            beta: float = 1.2) -> float:
    """ROUGE-L exactly as pycocoevalcap/rouge/rouge.py calc_score: per
    segment, max over references of the LCS F-measure (beta=1.2); corpus
    score is the mean."""
    scores = []
    for pred, refs in zip(predictions, references):
        p = pred.split()
        prec, rec = [], []
        for r in refs:
            rt = r.split()
            lcs = _lcs_len(p, rt)
            prec.append(lcs / len(p) if p else 0.0)
            rec.append(lcs / len(rt) if rt else 0.0)
        pm, rm = max(prec, default=0.0), max(rec, default=0.0)
        if pm != 0 and rm != 0:
            scores.append(((1 + beta ** 2) * pm * rm) / (rm + beta ** 2 * pm))
        else:
            scores.append(0.0)
    return sum(scores) / max(len(scores), 1)


# ---------- METEOR ----------

_VOWELS = set("aeiou")


def _cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Porter's m: number of VC sequences."""
    forms = ""
    for i in range(len(stem)):
        forms += "C" if _cons(stem, i) else "V"
    m = 0
    prev = None
    for ch in forms:
        if prev == "V" and ch == "C":
            m += 1
        prev = ch
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _cons(stem, i) for i in range(len(stem)))


def _ends_cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    if not (_cons(word, len(word) - 3) and not _cons(word, len(word) - 2)
            and _cons(word, len(word) - 1)):
        return False
    return word[-1] not in "wxy"


def porter_stem(word: str) -> str:
    """Porter (1980) stemming algorithm — the 'stem' matcher stage of METEOR
    (and of the reference's Java METEOR jar for English)."""
    w = word.lower()
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]
    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif len(w) >= 2 and w[-1] == w[-2] and _cons(w, len(w) - 1) \
                    and w[-1] not in "lsz":
                w = w[:-1]
            elif _measure(w) == 1 and _ends_cvc(w):
                w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # steps 2-3 (suffix → replacement when measure(stem) > 0)
    for cond_m, pairs in (
        (0, (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
             ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
             ("alli", "al"), ("entli", "ent"), ("eli", "e"),
             ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
             ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
             ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
             ("iviti", "ive"), ("biliti", "ble"))),
        (0, (("icate", "ic"), ("ative", ""), ("alize", "al"),
             ("iciti", "ic"), ("ical", "ic"), ("ful", ""), ("ness", ""))),
    ):
        for suf, rep in pairs:
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if _measure(stem) > cond_m:
                    w = stem + rep
                break
    for suf in ("ement", "ance", "ence", "able", "ible", "ment",
                "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize",
                "al", "er", "ic", "ou"):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" \
                and _measure(w[:-3]) > 1:
            w = w[:-3]
    # step 5
    if w.endswith("e"):
        stem = w[:-1]
        if _measure(stem) > 1 or (_measure(stem) == 1 and not _ends_cvc(stem)):
            w = stem
    if len(w) >= 2 and w[-1] == "l" and w[-2] == "l" and _measure(w) > 1:
        w = w[:-1]
    return w


def _meteor_align(pred: List[str], ref: List[str]):
    """Stage-wise greedy 1-1 alignment: exact matches first, then Porter-stem
    matches over the leftovers (METEOR's matcher cascade)."""
    matches = []  # (pred_idx, ref_idx)
    used_p, used_r = set(), set()
    for key_fn in (lambda t: t, porter_stem):
        ref_slots: Dict = defaultdict(list)
        for j, t in enumerate(ref):
            if j not in used_r:
                ref_slots[key_fn(t)].append(j)
        for i, t in enumerate(pred):
            if i in used_p:
                continue
            slots = ref_slots.get(key_fn(t))
            if slots:
                j = slots.pop(0)
                matches.append((i, j))
                used_p.add(i)
                used_r.add(j)
    return sorted(matches)


def _meteor_segment(pred: List[str], ref: List[str], alpha: float,
                    beta: float, gamma: float) -> float:
    matches = _meteor_align(pred, ref)
    m = len(matches)
    if m == 0:
        return 0.0
    precision = m / len(pred)
    recall = m / len(ref)
    fmean = precision * recall / (alpha * precision + (1 - alpha) * recall)
    # fragmentation: count chunks = maximal runs contiguous in BOTH sides
    chunks = 1
    for (pi, ri), (pj, rj) in zip(matches, matches[1:]):
        if pj != pi + 1 or rj != ri + 1:
            chunks += 1
    if m == len(pred) == len(ref) and chunks == 1:
        penalty = 0.0
    else:
        penalty = gamma * (chunks / m) ** beta
    return fmean * (1.0 - penalty)


def meteor(predictions: List[str], references: List[List[str]],
           alpha: float = 0.9, beta: float = 3.0, gamma: float = 0.5) -> float:
    """Corpus METEOR: per segment, max over references; mean over segments.
    Defaults are the Lavie & Agarwal (2007) parameters (alpha=0.9 ⇒ the
    classic F = 10PR/(R+9P); penalty = 0.5·(chunks/matches)³)."""
    scores = []
    for pred, refs in zip(predictions, references):
        p = pred.split()
        scores.append(max((_meteor_segment(p, r.split(), alpha, beta, gamma)
                           for r in refs), default=0.0))
    return sum(scores) / max(len(scores), 1)


def caption_eval(predictions: List[Dict], annotations: Dict) -> Dict[str, float]:
    """predictions: [{image_id, caption}]; annotations: image_id → [refs].
    Emits the reference's pycocoevalcap metric set (dataset/utils.py:460-483)
    minus SPICE: BLEU-1..4, METEOR, ROUGE-L, CIDEr-D."""
    preds, refs = [], []
    for p in predictions:
        if p["image_id"] in annotations:
            preds.append(p["caption"].lower())
            refs.append([r.lower() for r in annotations[p["image_id"]]])
    out = bleu(preds, refs)
    out["cider"] = cider_d(preds, refs)
    out["meteor"] = meteor(preds, refs)
    out["rouge_l"] = rouge_l(preds, refs)
    out["n"] = len(preds)
    return out
