"""Live "watch this run" page (a copy of gaussian_splatterer_tpu.io.watch,
which is pure Python): the headless equivalent of the reference's
continuously re-rendering splat preview panel
(src/ui/UiPanelViewOutput.cpp:52-70: re-render each idle tick, caption =
iteration count and count/capacity splats).

``write_watch_page`` rewrites a self-refreshing ``index.html`` beside a
``latest.png`` (written by the caller) and a machine-readable
``status.json``, byte for byte as the JAX package writes them.  Open the
file in any browser (or serve the directory with ``python -m
http.server``) and the tab tracks the run: the page reloads itself every
``refresh_s`` seconds and cache-busts the image with the iteration number.
"""

from __future__ import annotations

import html
import json
import os
from typing import Sequence

_PAGE = """<!doctype html>
<html><head>
<meta charset="utf-8">
<meta http-equiv="refresh" content="{refresh}">
<title>gsplat-tpu — training</title>
<style>
  body {{ background: #14141a; color: #d8d8e0; font: 14px/1.5 system-ui,
         sans-serif; margin: 2rem auto; max-width: 64rem; }}
  h1 {{ font-size: 1.1rem; font-weight: 600; }}
  table {{ border-collapse: collapse; margin: 0.8rem 0; }}
  td {{ padding: 0.15rem 1.2rem 0.15rem 0; }}
  td:first-child {{ color: #8a8a99; }}
  img {{ max-width: 100%; border: 1px solid #2c2c38; border-radius: 4px;
        image-rendering: auto; }}
  pre {{ color: #8a8a99; font-size: 12px; }}
</style>
</head><body>
<h1>gsplat-tpu training &mdash; live</h1>
<table>{rows}</table>
<img src="latest.png?it={it}" alt="current splat render">
<pre>{tail}</pre>
</body></html>
"""


def write_watch_page(
    directory: str,
    status: dict,
    history: Sequence[dict] = (),
    refresh_s: float = 2.0,
) -> None:
    """Rewrite index.html + status.json.  ``status`` keys become the
    table rows verbatim; ``history`` (recent per-iteration dicts) is
    shown as a text tail so the trend is visible without any charting."""
    os.makedirs(directory, exist_ok=True)
    rows = "".join(
        f"<tr><td>{html.escape(str(k))}</td>"
        f"<td>{html.escape(str(v))}</td></tr>"
        for k, v in status.items()
    )
    tail = "\n".join(json.dumps(h) for h in list(history)[-12:])
    page = _PAGE.format(
        refresh=refresh_s, rows=rows, it=status.get("iteration", 0),
        tail=html.escape(tail),
    )
    # write-then-rename so a mid-write browser reload never sees a torn page
    tmp = os.path.join(directory, ".index.html.tmp")
    with open(tmp, "w") as fh:
        fh.write(page)
    os.replace(tmp, os.path.join(directory, "index.html"))
    with open(os.path.join(directory, "status.json"), "w") as fh:
        json.dump(status, fh)
