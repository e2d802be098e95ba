"""Phone vocabularies: the reserved ids ``<pad>`` = 0, ``<EOS>`` = 1 and
``<UNK>`` = 2, then the tokens of a JSON list (a corpus's
``phone_set.json``). The port's copy of the JAX package's
``utils/text/text_encoder.py``."""

from __future__ import annotations

import json

PAD, EOS, UNK = "<pad>", "<EOS>", "<UNK>"
RESERVED_TOKENS = [PAD, EOS, UNK]
PAD_ID, EOS_ID, UNK_ID = 0, 1, 2


def is_sil_phoneme(p: str) -> bool:
    """A silence phone is empty or starts with a non-letter."""
    return p == "" or not p[0].isalpha()


class TokenTextEncoder:
    """Space-separated tokens <-> integer ids."""

    def __init__(self, vocab_list: list[str], replace_oov: str | None = UNK):
        self._replace_oov = replace_oov
        self.vocab = RESERVED_TOKENS + [t for t in vocab_list if t not in RESERVED_TOKENS]
        self._token_to_id = {t: i for i, t in enumerate(self.vocab)}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def __len__(self):
        return self.vocab_size

    def encode(self, s: str) -> list[int]:
        ids = []
        for t in (s.strip().split(" ") if s.strip() else []):
            if t not in self._token_to_id:
                if self._replace_oov is None:
                    raise KeyError(f"OOV token {t!r}")
                t = self._replace_oov
            ids.append(self._token_to_id[t])
        return ids

    def decode(self, ids, strip_eos: bool = False, strip_padding: bool = False) -> str:
        ids = [int(i) for i in ids]
        if strip_padding and PAD_ID in ids:
            ids = ids[: ids.index(PAD_ID)]
        if strip_eos and EOS_ID in ids:
            ids = ids[: ids.index(EOS_ID)]
        return " ".join(self.vocab[i] if 0 <= i < len(self.vocab) else UNK for i in ids)

    def sil_phonemes(self) -> list[str]:
        return [t for t in self.vocab if is_sil_phoneme(t)]

    def store_to_file(self, filename: str) -> None:
        with open(filename, "w") as f:
            json.dump(self.vocab[len(RESERVED_TOKENS):], f, ensure_ascii=False)


def build_token_encoder(token_list_file: str) -> TokenTextEncoder:
    """An encoder over the JSON list of tokens in ``token_list_file``."""
    with open(token_list_file) as f:
        return TokenTextEncoder(json.load(f), replace_oov=UNK)
