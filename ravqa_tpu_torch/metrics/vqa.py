"""Official VQA accuracy (OK-VQA).

The port's own copy of ravqa_tpu/metrics/vqa.py (the official VQAEval the
reference uses, src/utils/vqaEval.py:11-191, through
metrics_processors.compute_okvqa_scores:387): per question, for each of
the 10 human answers, acc = min(1, (# OTHER humans giving the predicted
answer)/3); the question's accuracy is the mean of those 10 leave-one-out
accuracies. Answer strings get the standard contraction/punctuation/
digit-article normalization, applied only when the ground-truth answer
set is non-degenerate (len(set(answers)) > 1), as in the official code.
tests/test_torch_rag_train.py holds the copy to the original.
"""

from __future__ import annotations

import re
from typing import Sequence

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
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
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

MANUAL_MAP = {"none": "0", "zero": "0", "one": "1", "two": "2",
              "three": "3", "four": "4", "five": "5", "six": "6",
              "seven": "7", "eight": "8", "nine": "9", "ten": "10"}
ARTICLES = {"a", "an", "the"}
PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")
PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
         "_", "-", ">", "<", "@", "`", ",", "?", "!"]


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) \
                or COMMA_STRIP.search(text) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return PERIOD_STRIP.sub("", out)


def process_digit_article(text: str) -> str:
    words = []
    for word in text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word in ARTICLES:
            continue
        words.append(CONTRACTIONS.get(word, word))
    return " ".join(words)


def normalize_answer(text: str) -> str:
    text = text.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(text))


def vqa_accuracy_single(prediction: str,
                        human_answers: Sequence[str]) -> float:
    """Leave-one-out consensus accuracy for one question (10 human answers
    in OK-VQA; works for any count)."""
    pred = prediction.replace("\n", " ").replace("\t", " ").strip()
    gts = [a.replace("\n", " ").replace("\t", " ").strip()
           for a in human_answers]
    if len(set(gts)) > 1:
        gts = [process_digit_article(process_punctuation(a)) for a in gts]
        pred = process_digit_article(process_punctuation(pred))
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1:]
        matching = sum(1 for a in others if a == pred)
        accs.append(min(1.0, matching / 3.0))
    return sum(accs) / max(len(accs), 1)


def vqa_accuracy(predictions: Sequence[str],
                 answers: Sequence[Sequence[str]]) -> float:
    """Mean official VQA accuracy over the dataset."""
    n = len(predictions)
    return sum(vqa_accuracy_single(p, a)
               for p, a in zip(predictions, answers)) / max(n, 1)


class TextCleaner:
    """Reference TextCleaner (src/utils/text_cleaner.py) — same
    normalization as VQAEval, exposed batch-wise."""

    def clean_texts(self, texts):
        return [normalize_answer(t) for t in texts]
