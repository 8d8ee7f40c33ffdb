"""SQL tokenizer.

The reference outsources SQL to DataFusion's sqlparser; we need our own.
Produces a flat token stream: keywords (uppercased), identifiers, string /
number literals, operators, punctuation. Comments (`--` and `/* */`) are
stripped. Case-insensitive keywords; identifiers keep original case but are
matched case-insensitively downstream.
"""

from __future__ import annotations

from dataclasses import dataclass

from ballista_tpu_torch.errors import SqlParseError

KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "OFFSET", "AS", "AND", "OR", "NOT", "IN", "EXISTS", "BETWEEN", "LIKE",
    "IS", "NULL", "TRUE", "FALSE", "CASE", "WHEN", "THEN", "ELSE", "END",
    "CAST", "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "ON",
    "USING", "UNION", "ALL", "DISTINCT", "ASC", "DESC", "NULLS", "FIRST",
    "LAST", "WITH", "DATE", "INTERVAL", "EXTRACT", "SUBSTRING", "FOR",
    "VALUES", "EXPLAIN", "ANALYZE", "VERBOSE", "CREATE", "EXTERNAL", "TABLE",
    "STORED", "LOCATION", "DROP", "SHOW", "TABLES", "COLUMNS", "SET", "SEMI",
    "ANTI", "NATURAL", "OVER", "PARTITION", "ROLLUP", "CUBE", "GROUPING", "SETS",
    "EXCEPT", "INTERSECT",
}


@dataclass(frozen=True)
class Token:
    kind: str  # kw | ident | string | number | op | punct | eof
    value: str
    pos: int

    def is_kw(self, *kws: str) -> bool:
        return self.kind == "kw" and self.value in kws


_OPS = ["<>", "!=", ">=", "<=", "||", "=", "<", ">", "+", "-", "*", "/", "%"]
_PUNCT = "(),.;"


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":
            j = sql.find("*/", i + 2)
            if j < 0:
                raise SqlParseError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":  # escaped ''
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            if j >= n:
                raise SqlParseError(f"unterminated string at {i}")
            toks.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlParseError(f"unterminated quoted identifier at {i}")
            toks.append(Token("ident", sql[i + 1 : j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_e = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_e:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_e and j > i:
                    seen_e = True
                    j += 1
                    if j < n and sql[j] in "+-":
                        j += 1
                else:
                    break
            toks.append(Token("number", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            up = word.upper()
            if up in KEYWORDS:
                toks.append(Token("kw", up, i))
            else:
                toks.append(Token("ident", word, i))
            i = j
            continue
        matched = False
        for op in _OPS:
            if sql.startswith(op, i):
                toks.append(Token("op", "<>" if op == "!=" else op, i))
                i += len(op)
                matched = True
                break
        if matched:
            continue
        if c in _PUNCT:
            toks.append(Token("punct", c, i))
            i += 1
            continue
        raise SqlParseError(f"unexpected character {c!r} at position {i}")
    toks.append(Token("eof", "", n))
    return toks
