"""Minimal ``.env`` loader (the W&B API key, dataset roots).

No external dependency: parses ``KEY=VALUE`` lines, ``#`` comments,
optional quotes, and ``${VAR}`` expansion against the values loaded so far
and ``os.environ``.
"""

from __future__ import annotations

import os
import re

_VAR = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}")


def load_dotenv(path: str = ".env", override: bool = False) -> dict[str, str]:
    """Load the variables of ``path`` into ``os.environ`` (an existing
    variable is kept unless ``override``); returns the parsed mapping.  A
    missing file gives an empty dict."""
    if not os.path.exists(path):
        return {}
    loaded: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key = key.strip()
            value = value.strip().strip("'\"")
            value = _VAR.sub(
                lambda m: loaded.get(m.group(1),
                                     os.environ.get(m.group(1), "")),
                value)
            loaded[key] = value
            if override or key not in os.environ:
                os.environ[key] = value
    return loaded
