"""Measured-best knobs from ``tuned_defaults.json``: the port's counterpart
of ``pointcloud_render_tpu.utils.tuned``.

The file at the repository's root holds one section per lane (``disc``,
``trail``, ``droplet``) of knob values and a ``note``; a lane fills every
knob its caller did not pass from its section (:func:`fill`).  The file is
read as data.  Most knobs render the same images at any value; the
geometry knobs of the trail and droplet sections (``segments``,
``rows9``) change what is drawn and are certified by
``utils/fidelity.py`` before a lane runs them.
"""

from __future__ import annotations

import json
import os

TUNED_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "tuned_defaults.json")


def load_tuned(path: str | None = None) -> dict:
    """The tuned-defaults dict of ``path`` (the repository's
    ``tuned_defaults.json`` by default), or {} when the file is absent,
    unreadable or not a JSON object."""
    try:
        with open(path or TUNED_PATH) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def fill(args_value, tuned_section: dict, key: str, builtin):
    """Resolve one knob: explicit value > tuned file > builtin."""
    if args_value is not None:
        return args_value
    v = tuned_section.get(key)
    return builtin if v is None else v
