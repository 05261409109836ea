"""deal.II .prm configuration-file reader (a copy of
dflo_tpu/config/prm.py: pure Python, shared by no import).

Parses the INI-like format consumed by deal.II's ParameterHandler
(src/parameters.cc, examples/*/input.prm) so the reference example configs
run unchanged (BASELINE.md requirement):

    set key = value            # comment
    subsection name
       set key = value
    end

Values keep everything up to an unquoted '#'.  Repeated `set` of the same key
overrides (last wins), matching ParameterHandler.  Unknown keys are NOT
rejected here — schema validation happens in config/params.py, which
knows the declared entries (src/parameters.cc:10-417).
"""

from __future__ import annotations


def parse_prm(text: str) -> dict:
    """Parse prm text into a nested dict: sections are sub-dicts, entries are
    strings."""
    root: dict = {}
    stack = [root]
    # line continuations: deal.II joins lines ending in backslash
    logical_lines: list[str] = []
    pending = ""
    for raw in text.splitlines():
        line = raw.rstrip()
        if line.endswith("\\"):
            pending += line[:-1] + " "
            continue
        logical_lines.append(pending + line)
        pending = ""
    if pending:
        logical_lines.append(pending)

    for lineno, raw in enumerate(logical_lines, 1):
        line = _strip_comment(raw).strip()
        if not line:
            continue
        low = line.lower()
        if low.startswith("subsection"):
            name = line[len("subsection"):].strip()
            sub = stack[-1].setdefault(name, {})
            if not isinstance(sub, dict):
                raise ValueError(f"line {lineno}: '{name}' is both an entry "
                                 f"and a subsection")
            stack.append(sub)
        elif low == "end":
            if len(stack) == 1:
                raise ValueError(f"line {lineno}: unmatched 'end'")
            stack.pop()
        elif low.startswith("set "):
            key, _, value = line[4:].partition("=")
            if not _:
                raise ValueError(f"line {lineno}: malformed set: {raw!r}")
            stack[-1][key.strip()] = value.strip()
        elif low.startswith("include "):
            raise ValueError("prm 'include' directives are not supported")
        else:
            raise ValueError(f"line {lineno}: cannot parse: {raw!r}")
    if len(stack) != 1:
        raise ValueError("missing 'end' for subsection")
    return root


def _strip_comment(line: str) -> str:
    """Drop '#' comments (the prm format has no quoting of '#')."""
    i = line.find("#")
    return line if i < 0 else line[:i]


def parse_prm_file(path: str) -> dict:
    with open(path) as f:
        return parse_prm(f.read())
