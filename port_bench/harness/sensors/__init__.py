"""One module per sensor, named by a configuration file's `sensor` key.

Each module states, as `rgbd.py` and `stereo.py` do:
  CALL        the `SlamSystem` method that takes one frame `(a, b, det)`;
  K1_IMAGES   the frame's images (indices into the frame) that one K1
              launch covers, in the launch's level order;
  capture()   the program's function whose output the shape step reads as
              its depth image, or None where it reads the frame's own;
  shape_depth(frame, captured)  that depth image, from the frame or from
              what the harness captured of `capture()` on that frame;
  render(view, T_cw, cam)  what the generator renders per frame:
              (a, b, true depth, instance ids) from `view(T_cw)`, which
              renders (gray uint8, depth f32 metres, instance ids) at a pose.
"""

from __future__ import annotations

import importlib
from pathlib import Path


def load(name: str):
    path = Path(__file__).with_name(f"{name}.py")
    if not (name.isidentifier() and not name.startswith("_") and path.is_file()):
        raise FileNotFoundError(f"no sensor {name!r}: the harness looked for {path}")
    return importlib.import_module(f"{__name__}.{name}")
