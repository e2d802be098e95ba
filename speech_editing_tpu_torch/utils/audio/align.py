"""Forced-alignment utilities: TextGrid parsing and mel2ph construction.

The port's copy of the JAX package's ``utils/audio/align.py``: a
self-contained Praat ooTextFile parser (``chardet`` is used when it
imports) and numpy frame<->phoneme alignment maps.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from speech_editing_tpu_torch.utils.text.text_encoder import is_sil_phoneme


@dataclass
class Interval:
    min_time: float
    max_time: float
    mark: str


def _decode_textgrid_bytes(raw: bytes, path: str) -> str:
    """Decode a TextGrid file of unknown encoding (reference
    ``utils/text/encoding.py:1-10`` behavior): BOM sniffing first (Praat
    writes UTF-16 with BOM on some locales), then chardet when available
    (GB2312 widened to GB18030 like the reference), then utf-8 with
    replacement as the last resort."""
    if raw.startswith((b"\xff\xfe", b"\xfe\xff")):
        return raw.decode("utf-16")
    if raw.startswith(b"\xef\xbb\xbf"):
        return raw.decode("utf-8-sig")
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError:
        pass
    try:
        import chardet  # type: ignore

        enc = chardet.detect(raw)["encoding"]
        if enc == "GB2312":
            enc = "GB18030"
        if enc:
            return raw.decode(enc, errors="replace")
    except ImportError:
        pass
    return raw.decode("utf-8", errors="replace")


def read_textgrid(path: str) -> dict[str, list[Interval]]:
    """Parse a Praat ooTextFile ('long' or 'short' form) into {tier: intervals}."""
    with open(path, "rb") as f:
        text = _decode_textgrid_bytes(f.read(), path)
    tiers: dict[str, list[Interval]] = {}
    if '"IntervalTier"' not in text:
        raise ValueError(f"no IntervalTier found in {path}")
    # long form has 'item [n]:' blocks; short form is a bare value stream.
    if re.search(r"item\s*\[", text):
        blocks = re.split(r"item\s*\[\d+\]\s*:", text)[1:]
        for block in blocks:
            if '"IntervalTier"' not in block:
                continue
            name_m = re.search(r'name\s*=\s*"([^"]*)"', block)
            name = name_m.group(1) if name_m else f"tier{len(tiers)}"
            ivs = []
            for m in re.finditer(
                    r"intervals\s*\[\d+\]\s*:\s*"
                    r"xmin\s*=\s*([\d.eE+-]+)\s*"
                    r"xmax\s*=\s*([\d.eE+-]+)\s*"
                    r'text\s*=\s*"((?:[^"]|"")*)"', block):
                ivs.append(Interval(float(m.group(1)), float(m.group(2)),
                                    m.group(3).replace('""', '"').strip()))
            tiers[name] = ivs
    else:
        # short text form: stream of values after the header
        toks = re.findall(r'"(?:[^"]|"")*"|[\d.eE+-]+', text)
        i = 0

        def nxt():
            nonlocal i
            v = toks[i]
            i += 1
            return v

        nxt()  # "ooTextFile"
        nxt()  # "TextGrid"
        nxt(), nxt()  # global xmin xmax
        nxt()  # <exists> flag is literal text; tolerate numeric
        n_tiers = int(float(nxt()))
        for _ in range(n_tiers):
            klass = nxt().strip('"')
            name = nxt().strip('"')
            nxt(), nxt()  # tier xmin xmax
            n_iv = int(float(nxt()))
            ivs = []
            for _ in range(n_iv):
                x0, x1 = float(nxt()), float(nxt())
                mark = nxt().strip('"').replace('""', '"').strip()
                ivs.append(Interval(x0, x1, mark))
            if klass == "IntervalTier":
                tiers[name] = ivs
    return tiers


def textgrid_phone_tier(path: str) -> list[Interval]:
    """The phone tier: the MFA convention is tier index 1 / name 'phones'."""
    tiers = read_textgrid(path)
    for key in ("phones", "phone"):
        if key in tiers:
            return tiers[key]
    vals = list(tiers.values())
    return vals[1] if len(vals) > 1 else vals[0]


def mel2token_to_dur(mel2token: np.ndarray, T_txt: int | None = None,
                     max_dur: int | None = None) -> np.ndarray:
    """Per-token frame counts from a frame->token map (ids start at 1).

    numpy bincount equivalent of the reference's torch scatter_add
    (``utils/audio/align.py:71-90``). Accepts [T] or [B, T].
    """
    mel2token = np.asarray(mel2token)
    squeeze = mel2token.ndim == 1
    if squeeze:
        mel2token = mel2token[None]
    if T_txt is None:
        T_txt = int(mel2token.max())
    dur = np.stack([
        np.bincount(row, minlength=T_txt + 1)[1: T_txt + 1]
        for row in mel2token.astype(np.int64)
    ])
    if max_dur is not None:
        dur = np.minimum(dur, max_dur)
    return dur[0] if squeeze else dur


def get_mel2ph(tg_fn: str, ph: str, mel: np.ndarray, hop_size: int,
               audio_sample_rate: int, min_sil_duration: float = 0.0):
    """Frame->phoneme alignment map from an MFA TextGrid.

    Contract (reference ``align.py:10-49``): ids are 1-based into the phoneme
    string, 0 = padding, short silences merge into the previous interval,
    silence intervals in the TextGrid map onto silence phonemes in ``ph``.
    Returns ``(mel2ph [T_mel], dur [T_txt])``.
    """
    ph_list = ph.split(" ")
    itvs = textgrid_phone_tier(tg_fn)
    merged: list[Interval] = []
    for i, itv in enumerate(itvs):
        if (itv.max_time - itv.min_time < min_sil_duration and i > 0
                and is_sil_phoneme(itv.mark)):
            merged[-1] = Interval(merged[-1].min_time, itv.max_time, merged[-1].mark)
        else:
            merged.append(Interval(itv.min_time, itv.max_time, itv.mark))

    tg_len = len([x for x in merged if not is_sil_phoneme(x.mark)])
    ph_len = len([x for x in ph_list if not is_sil_phoneme(x)])
    assert tg_len == ph_len, (tg_len, ph_len, [x.mark for x in merged], ph_list, tg_fn)

    mel2ph = np.zeros(mel.shape[0], np.int64)
    i_itv = i_ph = 0
    while i_itv < len(merged):
        itv = merged[i_itv]
        start = int(itv.min_time * audio_sample_rate / hop_size + 0.5)
        end = int(itv.max_time * audio_sample_rate / hop_size + 0.5)
        if i_ph >= len(ph_list):
            # every phoneme consumed: only extra TextGrid silences can
            # remain (e.g. two unmerged trailing sil intervals vs one
            # <EOS>); fold them onto the last phone instead of indexing
            # past the phoneme list
            assert is_sil_phoneme(itv.mark), (
                f"non-silence interval {itv.mark!r} beyond phoneme list "
                f"in {tg_fn}")
            mel2ph[start:end] = i_ph  # == last 1-based phone id
            i_itv += 1
            continue
        cur_ph = ph_list[i_ph]
        if is_sil_phoneme(itv.mark) and not is_sil_phoneme(cur_ph):
            # TextGrid silence with no matching ph: attribute to previous ph
            mel2ph[start:end] = i_ph
            i_itv += 1
        elif not is_sil_phoneme(itv.mark) and is_sil_phoneme(cur_ph):
            i_ph += 1
        else:
            same = (is_sil_phoneme(itv.mark) and is_sil_phoneme(cur_ph)) or \
                re.sub(r"\d+", "", itv.mark.lower()) == re.sub(r"\d+", "", cur_ph.lower())
            if not same:
                print(f"| WARN: {tg_fn} phoneme mismatch: {itv.mark} vs {cur_ph}")
            mel2ph[start:end] = i_ph + 1
            i_ph += 1
            i_itv += 1
    if len(mel2ph) >= 2:
        mel2ph[-1] = mel2ph[-2]
    assert not np.any(mel2ph == 0), f"unaligned frames in {tg_fn}"
    dur = mel2token_to_dur(mel2ph, len(ph_list))
    return mel2ph.tolist(), dur.tolist()
