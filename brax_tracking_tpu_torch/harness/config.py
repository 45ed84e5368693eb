"""Three-group config composition with interpolation.

Counterpart of ``brax_tracking_tpu/harness/config.py`` with the same API
(``load_config``, ``resolve``, ``save_config``, ``ConfigError``): YAML group
files composed as ``dataset x train x paths`` from the port's own copies
under ``brax_tracking_tpu_torch/configs/``, ``${...}`` interpolation
(dotted absolute paths, ``${..key}`` relative ones), CLI overrides
``key.sub=value`` and group swaps ``group=name``, and the resolvers
``resolve_default``, ``eq``, ``contains``, ``if_multi`` and ``env`` /
``oc.env``.

The card's machine has no ``yaml`` package, so this module carries its own
reader and writer for the subset of YAML the configs use, on every
machine: block mappings and sequences, flow sequences (``[a, b]``), plain,
single- and double-quoted scalars, ``#`` comments, and YAML 1.1's implicit
types as PyYAML's ``safe_load`` resolves them (``3e-4`` has no dot, so it
is a string; ``3_000_000_000`` is an int; ``~`` and ``null`` are None).
Anything outside the subset (anchors, tags, block scalars, flow mappings
other than ``{}``, multi-line plain scalars, dates) raises ``ConfigError``.
"""

from __future__ import annotations

import copy
import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")

_INTERP = re.compile(r"\$\{([^${}]+)\}")


class ConfigError(ValueError):
    pass


# --- the YAML subset ---------------------------------------------------------

# YAML 1.1 implicit types, as PyYAML's resolver matches them
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_DATE = re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                   r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)[0-9][0-9]?"
                   r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                   r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_TRUE = {"yes", "true", "on"}
_PLAIN_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_.\-]*$")


def _sexagesimal(text: str, cast) -> Any:
    sign = -1 if text[0] == "-" else 1
    digits = [cast(p) for p in text.lstrip("+-").split(":")]
    value = 0
    for d in digits:
        value = value * 60 + d
    return sign * value


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    t = t.lstrip("+-")
    if t == "0":
        return 0
    if ":" in t:
        return sign * _sexagesimal(t, int)
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if t.startswith("0"):
        return sign * int(t, 8)
    return sign * int(t)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    sign = -1.0 if t[0] == "-" else 1.0
    t = t.lstrip("+-")
    if t == ".inf":
        return sign * math.inf
    if t == ".nan":
        return math.nan
    if ":" in t:
        return sign * _sexagesimal(t, float)
    return sign * float(t)


def _plain(text: str, where: str) -> Any:
    """A plain scalar resolved to YAML 1.1's implicit type."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if (_DATE.match(text) or text in ("=", "<<") or text[0] in "&*!|>%@`,[]{}#'\""
            or (text[0] in "-?:" and text[1:2] in ("", " ")) or re.search(r":(?:\s|$)", text)):
        raise ConfigError(f"{where}: {text!r} is outside the config subset of YAML")
    return text


_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "0": "\0", "/": "/"}


def _quoted(text: str, where: str) -> Tuple[str, str]:
    """The quoted scalar at the start of ``text`` and what follows it."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _ESCAPES:
                raise ConfigError(f"{where}: unsupported escape \\{esc} in {text!r}")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), text[i + 1:]
        out.append(c)
        i += 1
    raise ConfigError(f"{where}: unterminated quoted scalar {text!r}")


def _strip_comment(rest: str, where: str) -> None:
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        raise ConfigError(f"{where}: unexpected {rest!r} after a value")


def _flow_seq(text: str, where: str) -> Tuple[List[Any], str]:
    """The flow sequence ``[...]`` at the start of ``text`` and what follows."""
    items: List[Any] = []
    rest = text[1:].lstrip()
    if rest.startswith("]"):
        return items, rest[1:]
    while True:
        if rest.startswith("["):
            item, rest = _flow_seq(rest, where)
        elif rest[:1] in ("'", '"'):
            item, rest = _quoted(rest, where)
        else:
            m = re.match(r"[^,\[\]{}]*", rest)
            token = m.group(0).strip()
            if " #" in token or token.startswith("#"):
                raise ConfigError(f"{where}: comment inside a flow sequence")
            item, rest = _plain(token, where), rest[m.end():]
        items.append(item)
        rest = rest.lstrip()
        if rest.startswith(","):
            rest = rest[1:].lstrip()
            continue
        if rest.startswith("]"):
            return items, rest[1:]
        raise ConfigError(f"{where}: malformed flow sequence {text!r}")


def _value(text: str, where: str) -> Any:
    """A scalar or a flow sequence: the whole of ``text`` (with an optional
    trailing comment)."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, where)
    elif text.startswith("["):
        value, rest = _flow_seq(text, where)
    elif text.startswith("{"):
        value, rest = {}, text[1:].lstrip()
        if not rest.startswith("}"):
            raise ConfigError(f"{where}: flow mappings are outside the config subset of YAML")
        rest = rest[1:]
    else:
        cut = re.search(r"\s#", text)
        return _plain(text[:cut.start()].rstrip() if cut else text, where)
    _strip_comment(rest, where)
    return value


def _split_key(content: str) -> Optional[Tuple[str, str]]:
    """``(key, rest)`` when ``content`` is a ``key: value`` entry."""
    if content[:1] in ("'", '"', "["):
        return None
    m = re.search(r":(?:\s|$)", content)
    if m is None:
        return None
    cut = re.search(r"\s#", content)
    if cut is not None and cut.start() < m.start():
        return None
    key = content[:m.start()].strip()
    return key, content[m.end():]


def yaml_loads(text: str) -> Any:
    """Parses ``text`` (the configs' subset of YAML) as ``yaml.safe_load``
    would."""
    lines: List[List[Any]] = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ConfigError(f"line {n}: tab indentation")
        stripped = raw.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped in ("---", "...") or stripped.startswith("%"):
            raise ConfigError(f"line {n}: documents and directives are outside the subset")
        lines.append([len(raw) - len(raw.lstrip(" ")), stripped.rstrip(), n])
    if not lines:
        return None
    pos = [0]

    def block(indent: int) -> Any:
        if lines[pos[0]][1] == "-" or lines[pos[0]][1].startswith("- "):
            return sequence(indent)
        if _split_key(lines[pos[0]][1]) is None:
            if len(lines) != 1:
                raise ConfigError(f"line {lines[pos[0]][2]}: expected 'key: value'")
            pos[0] += 1
            return _value(lines[0][1], f"line {lines[0][2]}")
        return mapping(indent)

    def nested(parent_indent: int, same_ok: bool) -> Any:
        """The block under a ``key:`` or ``-`` with nothing after it."""
        if pos[0] < len(lines):
            ind, content, _ = lines[pos[0]]
            is_seq = content == "-" or content.startswith("- ")
            if ind > parent_indent or (same_ok and ind == parent_indent and is_seq):
                return block(ind)
        return None

    def mapping(indent: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        while pos[0] < len(lines):
            ind, content, n = lines[pos[0]]
            if ind < indent:
                break
            where = f"line {n}"
            if ind > indent:
                raise ConfigError(f"{where}: unexpected indentation")
            kv = _split_key(content)
            if kv is None or content.startswith("- "):
                raise ConfigError(f"{where}: expected 'key: value', got {content!r}")
            key, rest = kv
            if key[:1] in ("'", '"', "?", "&", "*", "!") or not key:
                raise ConfigError(f"{where}: key {key!r} is outside the config subset of YAML")
            pos[0] += 1
            if rest.strip() == "" or rest.strip().startswith("#"):
                out[key] = nested(indent, same_ok=True)
            else:
                out[key] = _value(rest, where)
        return out

    def sequence(indent: int) -> List[Any]:
        out: List[Any] = []
        while pos[0] < len(lines):
            ind, content, n = lines[pos[0]]
            if ind < indent:
                break
            if ind > indent or not (content == "-" or content.startswith("- ")):
                if ind == indent:
                    break
                raise ConfigError(f"line {n}: unexpected indentation")
            item = content[1:].lstrip()
            if item == "" or item.startswith("#"):
                pos[0] += 1
                out.append(nested(indent, same_ok=False))
            elif item.startswith("- ") or _split_key(item) is not None:
                # the entry's own block starts on this line, at the item's column
                lines[pos[0]] = [ind + len(content) - len(item), item, n]
                out.append(block(lines[pos[0]][0]))
            else:
                pos[0] += 1
                out.append(_value(item, f"line {n}"))
        return out

    result = block(lines[0][0])
    if pos[0] != len(lines):
        raise ConfigError(f"line {lines[pos[0]][2]}: unexpected content {lines[pos[0]][1]!r}")
    return result


def _scalar_text(v: Any) -> str:
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
        r = repr(v)
        mantissa, e, exp = r.partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        if e and exp[0] not in "+-":
            exp = "+" + exp
        return mantissa + (e + exp if e else "")
    if isinstance(v, str):
        if "\n" in v or "\r" in v:
            raise ConfigError(f"multi-line string {v!r} is outside the config subset of YAML")
        return "'" + v.replace("'", "''") + "'"
    raise ConfigError(f"cannot write {type(v).__name__} {v!r} as config YAML")


def _dump_lines(node: Any, indent: int) -> List[str]:
    pad = " " * indent
    out: List[str] = []
    if isinstance(node, dict):
        for k, v in node.items():
            if not isinstance(k, str) or not _PLAIN_KEY.match(k) or _plain(k, "key") != k:
                raise ConfigError(f"cannot write key {k!r} as config YAML")
            if isinstance(v, (dict, list, tuple)) and len(v):
                out.append(f"{pad}{k}:")
                out.extend(_dump_lines(v, indent + 2))
            else:
                out.append(f"{pad}{k}: {_container_or_scalar(v)}")
    else:
        for v in node:
            if isinstance(v, (dict, list, tuple)) and len(v):
                sub = _dump_lines(v, indent + 2)
                sub[0] = pad + "- " + sub[0][indent + 2:]
                out.extend(sub)
            else:
                out.append(f"{pad}- {_container_or_scalar(v)}")
    return out


def _container_or_scalar(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar_text(v)


def yaml_dumps(node: Dict[str, Any]) -> str:
    """Writes a config tree (dicts, lists, str, int, float, bool, None) in
    the subset ``yaml_loads`` reads; ``yaml.safe_load`` reads it the same."""
    if not isinstance(node, dict):
        raise ConfigError("a config document is a mapping")
    return "\n".join(_dump_lines(node, 0)) + "\n" if node else "{}\n"


def read_yaml(path: str) -> Any:
    with open(path) as f:
        return yaml_loads(f.read())


# --- composition -------------------------------------------------------------


def _parse_scalar(s: str) -> Any:
    return yaml_loads(s) if s != "" else ""


def _set_dotted(cfg: Dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ConfigError(f"cannot override through non-dict at {k!r} in {dotted}")
    node[keys[-1]] = value


def _get_dotted(cfg: Dict, dotted: str) -> Any:
    node = cfg
    for k in dotted.split("."):
        if not isinstance(node, dict) or k not in node:
            raise KeyError(dotted)
        node = node[k]
    return node


def load_config(
    overrides: Optional[List[str]] = None,
    config_dir: str = DEFAULT_CONFIG_DIR,
    config_name: str = "config",
) -> Dict:
    """Compose the config tree and resolve interpolations."""
    overrides = list(overrides or [])
    root = read_yaml(os.path.join(config_dir, config_name + ".yaml")) or {}

    defaults = root.pop("defaults", [])
    groups: Dict[str, str] = {}
    for entry in defaults:
        if entry == "_self_":
            continue
        if isinstance(entry, dict):
            groups.update({str(k): str(v) for k, v in entry.items()})

    # group swaps from CLI: "train=smoke"
    kv_overrides = []
    for ov in overrides:
        if "=" not in ov:
            raise ConfigError(f"override {ov!r} must be key=value")
        k, v = ov.split("=", 1)
        if k in groups and "." not in k:
            groups[k] = v
        else:
            kv_overrides.append((k, v))

    cfg = dict(root)
    for group, choice in groups.items():
        path = os.path.join(config_dir, group, choice + ".yaml")
        if not os.path.exists(path):
            raise ConfigError(f"unknown {group} config {choice!r} ({path})")
        cfg[group] = read_yaml(path) or {}

    for k, v in kv_overrides:
        _set_dotted(cfg, k, _parse_scalar(v))

    return resolve(cfg)


# --- interpolation -----------------------------------------------------------


def _resolver(name: str, args: List[Any]) -> Any:
    if name == "resolve_default":
        default, value = args
        return default if value in ("", None) else value
    if name == "eq":
        return args[0] == args[1]
    if name == "contains":
        return str(args[0]) in str(args[1])
    if name == "if_multi":
        # the reference's resolver picks its first argument
        multi, single = args
        return multi
    if name == "oc.env" or name == "env":
        return os.environ.get(str(args[0]), args[1] if len(args) > 1 else "")
    raise ConfigError(f"unknown resolver {name!r}")


def _resolve_expr(expr: str, cfg: Dict, path: List[str], depth: int) -> Any:
    if ":" in expr:
        name, _, rest = expr.partition(":")
        args = [
            _resolve_value(a.strip(), cfg, path, depth + 1)
            for a in _split_args(rest)
        ]
        return _resolver(name.strip(), args)
    key = expr.strip()
    # relative refs: ".." walks up from the interpolation site
    if key.startswith("."):
        up = len(key) - len(key.lstrip("."))
        rel = key.lstrip(".")
        base = path[: len(path) - up]
        key = ".".join(base + [rel]) if rel else ".".join(base)
    try:
        val = _get_dotted(cfg, key)
    except KeyError:
        raise ConfigError(f"interpolation key {key!r} not found")
    if isinstance(val, str) and _INTERP.search(val):
        return _resolve_str(val, cfg, key.split(".")[:-1], depth + 1)
    return val


def _split_args(s: str) -> List[str]:
    out, buf, depth = [], "", 0
    for ch in s:
        if ch == "," and depth == 0:
            out.append(buf)
            buf = ""
        else:
            depth += ch == "{"
            depth -= ch == "}"
            buf += ch
    out.append(buf)
    return out


def _resolve_value(v: str, cfg: Dict, path: List[str], depth: int) -> Any:
    m = _INTERP.fullmatch(v)
    if m:
        return _resolve_expr(m.group(1), cfg, path, depth)
    if _INTERP.search(v):
        return _resolve_str(v, cfg, path, depth)
    return _parse_scalar(v)


def _resolve_str(s: str, cfg: Dict, path: List[str], depth: int) -> Any:
    if depth > 20:
        raise ConfigError(f"interpolation loop at {s!r}")
    m = _INTERP.fullmatch(s)
    if m:  # whole-string interpolation keeps the value's type
        return _resolve_expr(m.group(1), cfg, path, depth)

    def sub(mm):
        return str(_resolve_expr(mm.group(1), cfg, path, depth))

    return _INTERP.sub(sub, s)


def resolve(cfg: Dict) -> Dict:
    """Resolve every ${...} in the tree (multiple passes for chains)."""
    cfg = copy.deepcopy(cfg)

    def walk(node: Any, path: List[str]) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, path + [k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        if isinstance(node, str) and _INTERP.search(node):
            return walk(_resolve_str(node, cfg, path[:-1], 0), path)
        return node

    return walk(cfg, [])


def save_config(cfg: Dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(yaml_dumps(cfg))
