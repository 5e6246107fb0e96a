"""VQA accuracy (the port's own copy of x2vlm_tpu/evalkit/vqa.py; reference
vqaTools/vqaEval.py, the standard VQAv2 evaluation): answer normalisation
(contractions, punctuation, digit words, articles), and per question the
mean over the leave-one-out subsets of the human answers of
min(#matches / 3, 1).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List

__all__ = ["normalize_answer", "vqa_accuracy", "vqa_eval", "exact_match_accuracy"]

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldnt've": "couldn't've", "couldn'tve": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's", "whatve": "what've",
    "whens": "when's", "whered": "where'd", "wheres": "where's",
    "whereve": "where've", "whod": "who'd", "whod've": "who'd've",
    "who'dve": "who'd've", "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't", "wouldnt've": "wouldn't've",
    "wouldn'tve": "wouldn't've", "yall": "y'all", "yall'll": "y'all'll",
    "y'allll": "y'all'll", "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're", "youve": "you've",
}

_DIGIT_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
}

_ARTICLES = {"a", "an", "the"}
_PUNCT = list(";/[]\"{}()=+\\_-><@`,?!")
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")


def _process_punctuation(text: str) -> str:
    out = text
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) or (
                re.search(_COMMA_STRIP, text) is not None):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out, re.UNICODE)
    return out


def _process_digit_article(text: str) -> str:
    out = []
    for word in text.lower().split():
        word = _DIGIT_MAP.get(word, word)
        if word not in _ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in _CONTRACTIONS:
            out[i] = _CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    return _process_digit_article(_process_punctuation(ans))


def vqa_accuracy(pred: str, gt_answers: List[str]) -> float:
    """Official per-question accuracy: mean over leave-one-out human subsets
    of min(#matches/3, 1)."""
    pred = normalize_answer(pred)
    gts = [normalize_answer(a) for a in gt_answers]
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1:]
        matches = sum(1 for a in others if a == pred)
        accs.append(min(1.0, matches / 3.0))
    return sum(accs) / len(accs) if accs else 0.0


def vqa_eval(results: Iterable[Dict], annotations: Dict[int, List[str]]
             ) -> Dict[str, float]:
    """results: [{question_id, answer}]; annotations: qid → 10 human answers."""
    accs = []
    for r in results:
        qid = r["question_id"]
        if qid in annotations:
            accs.append(vqa_accuracy(r["answer"], annotations[qid]))
    return {"overall": 100.0 * sum(accs) / max(len(accs), 1), "n": len(accs)}


def exact_match_accuracy(results: Iterable[Dict], answers: Dict[int, object]
                         ) -> float:
    """Simple protocol used by VQA.py:94-116: prediction string-equals the gt.
    Accepts a single gt string or a list (correct if it matches any)."""
    total, correct = 0, 0
    for r in results:
        qid = r["question_id"]
        if qid in answers:
            gt = answers[qid]
            gt = gt if isinstance(gt, (list, tuple)) else [gt]
            total += 1
            correct += int(any(str(r["answer"]).strip() == str(a).strip()
                               for a in gt))
    return 100.0 * correct / max(total, 1)
