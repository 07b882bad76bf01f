"""Filesystem roots and plot configuration (reference: _config.py; a copy
of rajepy_tpu._config)."""
import os

_PKG_ROOT = os.path.dirname(os.path.realpath(__file__))

dcys = {"scripts": _PKG_ROOT,
        "files": os.path.join(_PKG_ROOT, "data"),
        "home": os.path.expanduser("~")}

plots = {"dims": {"column": 3.32153,   # inches (reference _config.py:16-18)
                  "text": 6.97522},
         "metadata": {"pdf": {"Subject": "rajepy_tpu_torch"},
                      "png": {"Source": "rajepy_tpu_torch"}}}
