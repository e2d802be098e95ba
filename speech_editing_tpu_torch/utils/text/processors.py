"""Text front end: normalization and grapheme-to-phoneme processors.

The port's copy of the JAX package's ``utils/text/processors.py``, names
kept: ``TxtProcessor.process(txt) -> (txt_struct, txt)`` where txt_struct
is ``[[word, [phones...]], ...]`` with ``<BOS>/<EOS>`` wrappers and ``|``
word boundaries; ``txt_to_ph`` flattens it to the (ph, txt, words,
ph2word, ph_gb_word) tuple the edit API reads.

g2p backend: ``g2p_en`` when it imports; otherwise a deterministic
rule-based ARPAbet fallback (CMUdict phone symbols, not linguistically
accurate).
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Tuple

from speech_editing_tpu_torch.utils.text.text_encoder import is_sil_phoneme

PUNCS = "!,.?;:"

_TXT_PROCESSORS: dict = {}


def register_txt_processor(name: str):
    def wrap(cls):
        _TXT_PROCESSORS[name] = cls
        return cls
    return wrap


def get_txt_processor_cls(name: str):
    return _TXT_PROCESSORS[name]


_UNITS = ["zero", "one", "two", "three", "four", "five", "six", "seven",
          "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
          "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]


def _int_to_words(n: int) -> str:
    if n < 20:
        return _UNITS[n]
    if n < 100:
        return _TENS[n // 10] + (" " + _UNITS[n % 10] if n % 10 else "")
    if n < 1000:
        rest = n % 100
        return (_UNITS[n // 100] + " hundred"
                + (" " + _int_to_words(rest) if rest else ""))
    for div, name in ((10 ** 9, "billion"), (10 ** 6, "million"),
                      (10 ** 3, "thousand")):
        if n >= div:
            rest = n % div
            return (_int_to_words(n // div) + f" {name}"
                    + (" " + _int_to_words(rest) if rest else ""))
    return str(n)


def normalize_numbers(text: str) -> str:
    """Expand integers/ordinals/decimals to words (role of
    g2p_en.expand.normalize_numbers)."""
    text = re.sub(r"(\d),(\d)", r"\1\2", text)  # 1,000 -> 1000
    text = re.sub(r"\$(\d+)", r"\1 dollars", text)
    text = re.sub(r"(\d+)\.(\d+)",
                  lambda m: f"{_int_to_words(int(m.group(1)))} point "
                            + " ".join(_int_to_words(int(d)) for d in m.group(2)),
                  text)
    text = re.sub(r"(\d+)(st|nd|rd|th)\b", r"\1", text)
    text = re.sub(r"\d+", lambda m: _int_to_words(int(m.group(0))), text)
    return text


class _FallbackG2p:
    """Deterministic rule-based English letter-to-ARPAbet mapping.

    Not linguistically accurate — exists so preprocessing/inference run
    without g2p_en; the phone set matches CMUdict symbols."""

    DIGRAPHS = [
        ("tch", ["CH"]), ("sch", ["S", "K"]), ("th", ["TH"]), ("ch", ["CH"]),
        ("sh", ["SH"]), ("ph", ["F"]), ("wh", ["W"]), ("ck", ["K"]),
        ("ng", ["NG"]), ("qu", ["K", "W"]), ("ee", ["IY1"]), ("oo", ["UW1"]),
        ("ea", ["IY1"]), ("ou", ["AW1"]), ("ai", ["EY1"]), ("ay", ["EY1"]),
        ("oi", ["OY1"]), ("oy", ["OY1"]), ("au", ["AO1"]), ("aw", ["AO1"]),
        ("ow", ["OW1"]), ("ar", ["AA1", "R"]), ("er", ["ER0"]),
        ("or", ["AO1", "R"]), ("igh", ["AY1"]),
    ]
    SINGLE = {
        "a": ["AE1"], "b": ["B"], "c": ["K"], "d": ["D"], "e": ["EH1"],
        "f": ["F"], "g": ["G"], "h": ["HH"], "i": ["IH1"], "j": ["JH"],
        "k": ["K"], "l": ["L"], "m": ["M"], "n": ["N"], "o": ["AA1"],
        "p": ["P"], "q": ["K"], "r": ["R"], "s": ["S"], "t": ["T"],
        "u": ["AH1"], "v": ["V"], "w": ["W"], "x": ["K", "S"], "y": ["Y"],
        "z": ["Z"],
    }

    def word_to_phones(self, word: str) -> List[str]:
        phones: List[str] = []
        i = 0
        w = word.lower()
        while i < len(w):
            for pat, phs in self.DIGRAPHS:
                if w.startswith(pat, i):
                    phones.extend(phs)
                    i += len(pat)
                    break
            else:
                phones.extend(self.SINGLE.get(w[i], []))
                i += 1
        return phones or ["AH0"]

    def __call__(self, text: str) -> List[str]:
        """g2p_en-compatible: list of phones with ' ' word separators and
        punctuation kept as its own token."""
        out: List[str] = []
        for i, word in enumerate(text.split(" ")):
            if i > 0:
                out.append(" ")
            if word in PUNCS or (word and not word[0].isalnum()):
                out.append(word)
            elif word:
                out.extend(self.word_to_phones(word))
        return out


def _get_g2p():
    try:
        from g2p_en import G2p  # type: ignore

        return G2p()
    except Exception:
        return _FallbackG2p()


class BaseTxtProcessor:
    @staticmethod
    def sp_phonemes():
        return ["|"]

    @classmethod
    def process(cls, txt: str) -> Tuple[list, str]:
        raise NotImplementedError

    @classmethod
    def postprocess(cls, txt_struct: list) -> list:
        """Strip head/tail silences, add | boundaries, wrap <BOS>/<EOS>
        (base_text_processor.py:28-48)."""
        while txt_struct and is_sil_phoneme(txt_struct[0][0]):
            txt_struct = txt_struct[1:]
        while txt_struct and is_sil_phoneme(txt_struct[-1][0]):
            txt_struct = txt_struct[:-1]
        txt_struct_ = []
        for i, ts in enumerate(txt_struct):
            txt_struct_.append(ts)
            if i != len(txt_struct) - 1 and \
                    not is_sil_phoneme(txt_struct[i][0]) \
                    and not is_sil_phoneme(txt_struct[i + 1][0]):
                txt_struct_.append(["|", ["|"]])
        return [["<BOS>", ["<BOS>"]]] + txt_struct_ + [["<EOS>", ["<EOS>"]]]


@register_txt_processor("en")
class EnTxtProcessor(BaseTxtProcessor):
    _g2p = None

    @staticmethod
    def preprocess_text(text: str) -> str:
        text = normalize_numbers(text)
        text = "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")  # strip accents
        text = text.lower()
        text = re.sub("['\"()]+", "", text)
        text = re.sub("[-]+", " ", text)
        text = re.sub(f"[^ a-z{PUNCS}]", "", text)
        text = re.sub(f" ?([{PUNCS}]) ?", r"\1", text)
        text = re.sub(f"([{PUNCS}])+", r"\1", text)
        text = re.sub(f"([{PUNCS}])", r" \1 ", text)
        text = re.sub(r"\s+", r" ", text)
        return text

    @classmethod
    def process(cls, txt: str) -> Tuple[list, str]:
        if cls._g2p is None:
            cls._g2p = _get_g2p()
        txt = cls.preprocess_text(txt).strip()
        phs = cls._g2p(txt)
        txt_struct: list = [[w, []] for w in txt.split(" ")]
        i_word = 0
        for p in phs:
            if p == " ":
                i_word += 1
            else:
                txt_struct[i_word][1].append(p)
        txt_struct = [ts for ts in txt_struct if ts[1]]
        return cls.postprocess(txt_struct), txt


def txt_to_ph(txt_processor, txt_raw: str):
    """(ph, txt, words, ph2word, ph_gb_word) — base_preprocess.py:194-201."""
    txt_struct, txt = txt_processor.process(txt_raw)
    ph = [p for w in txt_struct for p in w[1]]
    ph_gb_word = ["_".join(w[1]) for w in txt_struct]
    words = [w[0] for w in txt_struct]
    ph2word = [w_id + 1 for w_id, w in enumerate(txt_struct)
               for _ in range(len(w[1]))]
    return " ".join(ph), txt, " ".join(words), ph2word, " ".join(ph_gb_word)
