"""YAML experiment configs: ``base_config`` inheritance, ``-hp`` overrides
and the resolved config saved in the work dir.

The counterpart of the JAX package's ``config/hparams.py`` with plain dicts
in place of its ``HParams`` view. The configs are read without PyYAML: the
shipped ``egs/*.yaml`` use one flat mapping of ``key: value`` lines, and
:func:`parse_yaml` reads exactly that subset (plain, single- and
double-quoted scalars, flow lists nested to any depth, comments) with
YAML 1.1's scalar types, as ``yaml.safe_load`` resolves them, and also the
block lists (``- item`` lines, nested as ``- - item``) that PyYAML's
``safe_dump`` writes for list values, as in the ``config.yaml`` the JAX
package saves in a work dir. Anything else (nested mappings, anchors,
tags, multi-line scalars) raises, naming the key.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
from typing import Any

_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*")
_NULL = re.compile(r"~|null|Null|NULL")
_BOOL = {s: v for v, words in ((True, "yes Yes YES true True TRUE on On ON"),
                               (False, "no No NO false False FALSE off Off OFF"))
         for s in words.split()}
_INT = re.compile(r"[-+]?(?:0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
# sexagesimal numbers and timestamps: YAML 1.1 types this reader does not build
_UNSUPPORTED = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                          r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*")
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")


class YamlSubsetError(ValueError):
    """The text uses YAML beyond the flat subset the configs are written in."""


def _plain(s: str, where: str) -> Any:
    """A plain scalar, resolved as YAML 1.1 (``yaml.safe_load``) resolves it."""
    if s == "" or _NULL.fullmatch(s):
        return None
    if s in _BOOL:
        return _BOOL[s]
    if s in ("<<", "=") or _UNSUPPORTED.fullmatch(s):
        raise YamlSubsetError(f"{where}: unsupported scalar {s!r}")
    if _INT.fullmatch(s):
        digits = s.replace("_", "")
        sign = -1 if digits[0] == "-" else 1
        digits = digits.lstrip("+-")
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if digits != "0" and digits.startswith("0"):
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.fullmatch(s):
        v = s.replace("_", "").lower()
        if v.endswith(".inf"):
            return -math.inf if v.startswith("-") else math.inf
        if v.endswith(".nan"):
            return math.nan
        return float(v)
    if s[0] in _INDICATORS and not (s[0] in "-?:" and s[1:2] not in ("", " ", "\t")):
        raise YamlSubsetError(f"{where}: unsupported scalar {s!r}")
    return s


def _quoted(s: str, i: int, where: str) -> tuple[str, int]:
    """The quoted scalar starting at ``s[i]``; returns (value, index after it)."""
    q = s[i]
    j = i + 1
    while j < len(s):
        if q == "'" and s[j] == "'":
            if s[j + 1:j + 2] == "'":
                j += 2
                continue
            return s[i + 1:j].replace("''", "'"), j + 1
        if q == '"' and s[j] == "\\":
            j += 2
            continue
        if q == '"' and s[j] == '"':
            try:
                return json.loads(s[i:j + 1]), j + 1
            except json.JSONDecodeError as e:
                raise YamlSubsetError(f"{where}: unsupported escape in {s[i:j + 1]}") from e
        j += 1
    raise YamlSubsetError(f"{where}: unterminated quoted scalar")


def _flow_list(s: str, i: int, where: str) -> tuple[list, int]:
    """The flow list starting at ``s[i] == '['``; returns (list, index after it)."""
    out: list = []
    i += 1
    expect_item = True
    while True:
        while i < len(s) and s[i] in " \t":
            i += 1
        if i == len(s):
            raise YamlSubsetError(f"{where}: unterminated flow list")
        c = s[i]
        if c == "]":
            return out, i + 1
        if c == ",":
            if expect_item:
                raise YamlSubsetError(f"{where}: empty flow list item")
            expect_item = True
            i += 1
            continue
        if not expect_item:
            raise YamlSubsetError(f"{where}: missing ',' in flow list")
        if c == "[":
            item, i = _flow_list(s, i, where)
        elif c in "'\"":
            item, i = _quoted(s, i, where)
        elif c in "{":
            raise YamlSubsetError(f"{where}: flow mappings are not supported")
        else:
            j = i
            while j < len(s) and s[j] not in ",[]{}":
                j += 1
            item, i = _plain(s[i:j].strip(), where), j
        out.append(item)
        expect_item = False


def _strip_comment(line: str) -> str:
    """The line without a trailing ``# comment`` (a '#' at the start or after
    white space, outside quotes)."""
    quote, i = None, 0
    while i < len(line):
        c = line[i]
        if quote == '"' and c == "\\":
            i += 1
        elif quote:
            quote = None if c == quote else quote
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _value(rest: str, where: str) -> Any:
    """The scalar or flow list that is the whole of ``rest``."""
    if rest.startswith("["):
        value, end = _flow_list(rest, 0, where)
    elif rest[:1] in ("'", '"'):
        value, end = _quoted(rest, 0, where)
    else:
        value, end = _plain(rest, where), len(rest)
    if rest[end:].strip():
        raise YamlSubsetError(f"{where}: unexpected text after the value: {rest!r}")
    return value


def _is_item(line: str) -> bool:
    return line == "-" or line.startswith("- ")


def _block_list(lines: list, key: str, name: str, where: str) -> list:
    """The block list in ``lines`` ((line number, text) pairs following
    ``key:``): ``- item`` entries at one column, an entry's value a scalar
    after its dash or a block list further in."""
    toks = []      # (column, "-" or the scalar's text, line number)
    for lineno, text in lines:
        col = len(text) - len(text.lstrip(" "))
        rest = text[col:]
        while _is_item(rest):
            toks.append((col, "-", lineno))
            body = rest[1:].lstrip(" ")
            col += len(rest) - len(body)
            rest = body
        if rest:
            toks.append((col, rest, lineno))

    def seq(i: int, col: int) -> tuple[list, int]:
        out: list = []
        while i < len(toks) and toks[i][0] == col and toks[i][1] == "-":
            i += 1
            item = None
            if i < len(toks) and toks[i][0] > col:
                if toks[i][1] == "-":
                    item, i = seq(i, toks[i][0])
                else:
                    text = toks[i][1]
                    if text[0] not in "['\"" and (": " in text or text.endswith(":")):
                        raise YamlSubsetError(f"{name}:{toks[i][2]}: key {key!r}: "
                                              "mappings in a list are not supported")
                    item = _value(text, f"{name}:{toks[i][2]}")
                    i += 1
            out.append(item)
        return out, i

    value, end = seq(0, toks[0][0]) if toks else ([], 0)
    if not toks or end != len(toks):
        raise YamlSubsetError(f"{where}: key {key!r}: only a value on its line or a "
                              "block list of '- item' lines is supported")
    return value


def parse_yaml(text: str, name: str = "<yaml>") -> dict:
    """One flat mapping of ``key: value`` lines, or of ``key:`` lines each
    followed by a block list -> dict (see module doc)."""
    out: dict = {}
    lines = [(n, _strip_comment(raw).rstrip(), raw)
             for n, raw in enumerate(text.splitlines(), 1)]
    lines = [entry for entry in lines if entry[1].strip()]
    i = 0
    while i < len(lines):
        lineno, line, raw = lines[i]
        i += 1
        where = f"{name}:{lineno}"
        if line[0] in " \t" or line.startswith(("---", "...", "%")) or _is_item(line):
            raise YamlSubsetError(f"{where}: only one flat mapping is supported: {raw!r}")
        key, sep, rest = line.partition(":")
        if (not sep or not _KEY.fullmatch(key) or key in _BOOL or _NULL.fullmatch(key)
                or (rest and rest[0] not in " \t")):
            raise YamlSubsetError(f"{where}: expected 'key: value', got {raw!r}")
        rest = rest.strip()
        block = []
        while i < len(lines) and (lines[i][1][0] in " \t" or _is_item(lines[i][1])):
            block.append(lines[i][:2])
            i += 1
        if block and rest:
            raise YamlSubsetError(f"{where}: key {key!r}: multi-line values are not "
                                  "supported")
        out[key] = _block_list(block, key, name, where) if block else _value(rest, where)
    return out


def _dump_value(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        mantissa, e, exp = text.partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        return mantissa + (e + ("" if exp[0] in "+-" else "+") + exp if e else "")
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_value(x) for x in v) + "]"
    raise YamlSubsetError(f"cannot write {type(v).__name__} value {v!r}")


def dump_yaml(cfg: dict) -> str:
    """A flat dict -> the YAML subset :func:`parse_yaml` reads back (and
    ``yaml.safe_load`` reads the same), keys sorted."""
    lines = []
    for k in sorted(cfg):
        if not _KEY.fullmatch(k):
            raise YamlSubsetError(f"cannot write key {k!r}")
        lines.append(f"{k}: {_dump_value(cfg[k])}")
    return "\n".join(lines) + "\n"


def read_yaml(path: str) -> dict:
    with open(path) as f:
        return parse_yaml(f.read(), path)


def _deep_update(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v
    return dst


def load_config(config_fn: str, _seen: set | None = None) -> dict:
    """Read a config and its ``base_config`` chain: bases apply depth-first
    in listed order, the including file's keys win, a cycle is cut. A
    relative base path resolves against the working directory first, then
    against the directory of the including file."""
    _seen = _seen if _seen is not None else set()
    config_fn = os.path.abspath(config_fn)
    if config_fn in _seen:
        return {}
    _seen.add(config_fn)
    cfg = read_yaml(config_fn)
    bases = cfg.pop("base_config", None) or []
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for base in bases:
        cand = base
        if not os.path.isabs(cand) and not os.path.exists(cand):
            cand = os.path.join(os.path.dirname(config_fn), base)
        _deep_update(merged, load_config(cand, _seen))
    return _deep_update(merged, cfg)


def _coerce(v: str) -> Any:
    """A ``-hp`` value string -> a Python value."""
    v = v.strip()
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    if v.lower() in ("none", "null"):
        return None
    if re.fullmatch(r"[+-]?\d+", v):
        return int(v)
    try:
        return float(v)
    except ValueError:
        pass
    if v.startswith("[") and v.endswith("]"):
        inner = v[1:-1].strip()
        return [_coerce(p) for p in re.split(r"[,\s]+", inner) if p] if inner else []
    return v


def apply_overrides(cfg: dict, hparams_str: str) -> dict:
    """Apply ``a.b=c,d=[1 2 3]`` overrides in place (commas inside
    brackets do not split); a dotted key sets a nested entry."""
    if not hparams_str:
        return cfg
    items, depth, cur = [], 0, ""
    for ch in hparams_str:
        depth += (ch == "[") - (ch == "]")
        if ch == "," and depth == 0:
            items.append(cur)
            cur = ""
        else:
            cur += ch
    items.append(cur)
    for item in items:
        if not item.strip():
            continue
        k, v = item.strip().split("=", 1)
        *parents, last = k.strip().split(".")
        node = cfg
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = _coerce(v)
    return cfg


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="speech_editing_tpu_torch")
    parser.add_argument("--config", type=str, default="")
    parser.add_argument("--exp_name", type=str, default="")
    parser.add_argument("-hp", "--hparams", type=str, default="")
    parser.add_argument("--infer", action="store_true")
    parser.add_argument("--validate", action="store_true")
    parser.add_argument("--reset", action="store_true")
    parser.add_argument("--remove", action="store_true")
    parser.add_argument("--debug", action="store_true")
    return parser


def set_hparams(args: argparse.Namespace, print_hparams: bool = True,
                save_config: bool = True) -> dict:
    """Resolve the experiment config from parsed :func:`arg_parser` args.

    Precedence, low to high: the ``base_config`` chain, the config file,
    the config saved in the work dir ``checkpoints/<exp_name>`` (unless
    ``--reset``), the ``-hp`` overrides. ``--remove`` deletes the work dir
    first. Outside ``--infer`` the resolved config is saved there as
    ``config.yaml`` when none is, or on ``--reset``. ``save_config`` False
    (the ranks of a job but rank 0) neither deletes nor saves."""
    cfg = load_config(args.config) if args.config else {}
    work_dir = ""
    if args.exp_name:
        work_dir = os.path.join(cfg.get("work_dir_root", "checkpoints"), args.exp_name)
        if args.remove and save_config and os.path.exists(work_dir):
            print(f"| removing work dir {work_dir}")
            shutil.rmtree(work_dir)
        saved_fn = os.path.join(work_dir, "config.yaml")
        if os.path.exists(saved_fn) and not args.reset:
            _deep_update(cfg, read_yaml(saved_fn))
    apply_overrides(cfg, args.hparams)
    cfg["work_dir"] = work_dir
    cfg["exp_name"] = args.exp_name
    cfg["infer"] = bool(args.infer or cfg.get("infer", False))
    cfg["validate"] = bool(args.validate)
    cfg["debug"] = bool(args.debug or cfg.get("debug", False))
    if work_dir and not cfg["infer"] and save_config:
        os.makedirs(work_dir, exist_ok=True)
        saved_fn = os.path.join(work_dir, "config.yaml")
        if args.reset or not os.path.exists(saved_fn):
            with open(saved_fn, "w") as f:
                f.write(dump_yaml(cfg))
    if print_hparams:
        print("| Hparams: ")
        for k in sorted(cfg):
            print(f"|   {k}: {cfg[k]}")
    return cfg
