"""A minimal TOML emitter (the port's copy of the JAX package's
``testground_tpu/utils/tomlio.py`` ``dumps``): the subset of TOML the
composition schema uses (string/int/float/bool scalars, flat lists,
nested tables and arrays of tables), so that ``build composition
--write-artifacts`` writes a composition back as the JAX command does.
Reading is the standard library's ``tomllib``.
"""

from __future__ import annotations

from typing import Any


def _fmt_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        escaped = v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        return f'"{escaped}"'
    if isinstance(v, list):
        return "[" + ", ".join(_fmt_scalar(x) for x in v) + "]"
    raise TypeError(f"cannot serialize {type(v)} as TOML scalar")


def _is_table(v: Any) -> bool:
    return isinstance(v, dict)


def _is_table_array(v: Any) -> bool:
    return isinstance(v, list) and len(v) > 0 and all(isinstance(x, dict) for x in v)


def _emit_table(out: list[str], path: list[str], table: dict, list_tables: set[str]) -> None:
    scalars = {}
    subtables = {}
    table_arrays = {}
    for k, v in table.items():
        if v is None:
            continue
        if _is_table(v):
            subtables[k] = v
        elif _is_table_array(v) or (k in list_tables and isinstance(v, list)):
            table_arrays[k] = v
        else:
            scalars[k] = v

    if scalars:
        if path:
            out.append(f"[{'.'.join(path)}]")
        for k, v in scalars.items():
            out.append(f"{k} = {_fmt_scalar(v)}")
        out.append("")
    elif path and not subtables and not table_arrays:
        out.append(f"[{'.'.join(path)}]")
        out.append("")

    for k, v in subtables.items():
        _emit_table(out, path + [_quote_key(k)], v, list_tables)

    for k, arr in table_arrays.items():
        for item in arr:
            out.append(f"[[{'.'.join(path + [_quote_key(k)])}]]")
            _emit_inline_body(out, path + [_quote_key(k)], item, list_tables)


def _emit_inline_body(out: list[str], path: list[str], table: dict, list_tables: set[str]) -> None:
    subtables = {}
    for k, v in table.items():
        if v is None:
            continue
        if _is_table(v):
            subtables[k] = v
        elif _is_table_array(v):
            subtables[k] = v  # nested arrays-of-tables handled below
        else:
            out.append(f"{k} = {_fmt_scalar(v)}")
    out.append("")
    for k, v in subtables.items():
        if _is_table(v):
            _emit_table(out, path + [_quote_key(k)], v, list_tables)
        else:
            for item in v:
                out.append(f"[[{'.'.join(path + [_quote_key(k)])}]]")
                _emit_inline_body(out, path + [_quote_key(k)], item, list_tables)


def _quote_key(k: str) -> str:
    if k and all(c.isalnum() or c in "-_" for c in k):
        return k
    return f'"{k}"'


def dumps(d: dict, list_tables: set[str] | None = None) -> str:
    """Serialize a dict to TOML text. ``list_tables`` names keys that must be
    emitted as arrays-of-tables even when empty-able."""
    out: list[str] = []
    _emit_table(out, [], d, list_tables or set())
    return "\n".join(out).rstrip() + "\n"
