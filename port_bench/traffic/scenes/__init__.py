"""One module per scene, named by a traffic file's `scene` key.  Each has
`make(p, cam, device) -> (scene, T_cw)`: the `generator.Scene` and the
true camera poses (N, 4, 4) float64 of the traffic file `p`."""

from __future__ import annotations

import importlib
from pathlib import Path


def load(name: str):
    path = Path(__file__).with_name(f"{name}.py")
    if not (name.isidentifier() and not name.startswith("_") and path.is_file()):
        raise FileNotFoundError(f"no scene {name!r}: the generator looked for {path}")
    return importlib.import_module(f"{__name__}.{name}")
